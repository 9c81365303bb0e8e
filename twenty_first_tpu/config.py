"""Runtime configuration (mirrors twenty-first/src/config.rs).

The reference's single knob switches Merkle construction between rayon-
parallel and sequential below a node-count cutoff (config.rs:32-77). The
analogue here switches between batched hashing and the scalar
host path (device dispatch overhead dominates for tiny trees). The same
environment variable is honored for drop-in compatibility.
"""

from __future__ import annotations

import os

_ENV_VAR = "TWENTY_FIRST_MERKLE_TREE_PARALLELIZATION_CUTOFF"
_DEFAULT_CUTOFF = 512
_MIN_CUTOFF = 2

_cutoff: int | None = None


def merkle_tree_parallelization_cutoff() -> int:
    """Current cutoff; env var wins over programmatic setting (config.rs:68-77)."""
    env = os.environ.get(_ENV_VAR)
    if env is not None:
        try:
            return max(int(env), _MIN_CUTOFF)
        except ValueError:
            pass
    if _cutoff is not None:
        return _cutoff
    return _DEFAULT_CUTOFF


def set_merkle_tree_parallelization_cutoff(cutoff: int) -> None:
    global _cutoff
    _cutoff = max(int(cutoff), _MIN_CUTOFF)


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compilation_cache_dir() -> str:
    """Where JAX's persistent compilation cache lives: the directory named
    by JAX_COMPILATION_CACHE_DIR when it is set, else `<repo>/.jax_cache`
    (a fixed path, because the path is part of the cache key)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO_ROOT, ".jax_cache"))


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at compilation_cache_dir()
    and return that directory. Every entry point (tests, bench, scripts,
    chip_smoke) calls this and sets no other cache directory."""
    import jax

    path = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
