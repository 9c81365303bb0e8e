"""ctypes bridge to the native host core (native/twenty_first_native.cpp).

The shared library is built on demand with the C++ compiler ($CXX, default
g++; the same flags as native/Makefile); if the
toolchain or library is unavailable everything falls back to the pure-Python
implementations transparently. `available()` reports the active state.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtwenty_first_native.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("TWENTY_FIRST_TPU_NO_NATIVE"):
        return None
    src = os.path.join(_NATIVE_DIR, "twenty_first_native.cpp")
    stale = (not os.path.exists(_LIB_PATH)
             or (os.path.exists(src)
                 and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)))
    if stale:
        # the flags of native/Makefile, without needing make; $CXX first,
        # then the usual compiler names
        flags = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
                 "-fopenmp", "-o", _LIB_PATH, src]
        for cxx in dict.fromkeys(filter(None, (os.environ.get("CXX"), "g++",
                                               "c++"))):
            try:
                subprocess.run([cxx, *flags], check=True, capture_output=True,
                               timeout=120)
                break
            except Exception:
                continue
        if not os.path.exists(_LIB_PATH):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    # Pointer args are declared c_void_p and passed as raw ints
    # (arr.ctypes.data): building a ctypes POINTER object per argument via
    # data_as costs ~10us/call, which dominated small-array ops — the int
    # path measures 7us/call end to end.
    vp = ctypes.c_void_p
    lib.gl_mul_arrays.argtypes = [vp, vp, vp, ctypes.c_size_t]
    lib.gl_xfe_mul_arrays.argtypes = [vp, vp, vp, ctypes.c_size_t]
    lib.gl_add_arrays.argtypes = [vp, vp, vp, ctypes.c_size_t]
    lib.gl_sub_arrays.argtypes = [vp, vp, vp, ctypes.c_size_t]
    lib.gl_batch_inverse.argtypes = [vp, vp, ctypes.c_size_t]
    lib.gl_batch_inverse_or_zero.argtypes = [vp, vp, ctypes.c_size_t]
    lib.gl_mul_scalar.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.gl_mul_scalar.restype = ctypes.c_uint64
    lib.gl_inv_scalar.argtypes = [ctypes.c_uint64]
    lib.gl_inv_scalar.restype = ctypes.c_uint64
    lib.gl_pow_scalar.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.gl_pow_scalar.restype = ctypes.c_uint64
    lib.tip5_init.argtypes = [vp, vp, vp]
    lib.tip5_permute_batch.argtypes = [vp, ctypes.c_size_t]
    lib.tip5_hash_pairs.argtypes = [vp, vp, ctypes.c_size_t]
    lib.tip5_merkle_root.argtypes = [vp, vp, ctypes.c_size_t]
    lib.tip5_hash_varlen.argtypes = [vp, ctypes.c_size_t, vp]
    lib.gl_horner_points.argtypes = [vp, ctypes.c_size_t, vp,
                                     ctypes.c_size_t, vp]
    lib.gl_reduce_by_ntt_modulus.argtypes = [
        vp, ctypes.c_size_t, vp, ctypes.c_size_t, ctypes.c_size_t,
        vp, vp, ctypes.c_uint64, vp]
    lib.gl_ntt.argtypes = [vp, ctypes.c_size_t, ctypes.c_uint64]
    lib.gl_intt.argtypes = [vp, ctypes.c_size_t, ctypes.c_uint64]
    lib.gl_ntt_rows.argtypes = [vp, ctypes.c_size_t, ctypes.c_size_t,
                                vp, ctypes.c_uint64]
    lib.gl_poly_divmod.argtypes = [vp, ctypes.c_size_t, vp,
                                   ctypes.c_size_t, vp, vp]
    lib.gl_lagrange_interpolate.argtypes = [vp, vp, ctypes.c_size_t, vp]

    # one-time Tip5 constant upload
    from .tip5.constants import (
        LOOKUP_TABLE,
        MDS_MATRIX_FIRST_COLUMN,
        ROUND_CONSTANTS,
    )

    lut = np.ascontiguousarray(LOOKUP_TABLE.astype(np.uint8))
    rc = np.ascontiguousarray(ROUND_CONSTANTS)
    col = np.ascontiguousarray(MDS_MATRIX_FIRST_COLUMN.astype(np.uint64))
    lib.tip5_init(lut.ctypes.data, rc.ctypes.data, col.ctypes.data)
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _u64p(arr):
    """Raw data pointer as int (argtypes are c_void_p — see _load)."""
    return arr.ctypes.data


def tip5_permute_batch(states: np.ndarray) -> np.ndarray:
    """(..., 16) uint64 canonical states -> permuted, via native code."""
    lib = _load()
    assert lib is not None
    out = np.ascontiguousarray(states, dtype=np.uint64).copy()
    batch = out.size // 16
    lib.tip5_permute_batch(_u64p(out), batch)
    return out


def tip5_hash_pairs(nodes: np.ndarray) -> np.ndarray:
    """One Merkle layer: (2b, 5) uint64 digests -> (b, 5) hash_pair rows
    (OpenMP across pairs; no staging buffer)."""
    lib = _load()
    assert lib is not None
    nodes = np.ascontiguousarray(nodes, dtype=np.uint64)
    b = nodes.shape[0] // 2
    out = np.empty((b, 5), dtype=np.uint64)
    lib.tip5_hash_pairs(_u64p(nodes), _u64p(out), b)
    return out


def tip5_hash_varlen(values: np.ndarray) -> np.ndarray:
    """Whole variable-length sponge hash (n,) uint64 -> (5,) digest words."""
    lib = _load()
    assert lib is not None
    values = np.ascontiguousarray(values, dtype=np.uint64)
    out = np.empty(5, dtype=np.uint64)
    lib.tip5_hash_varlen(_u64p(values), values.size, _u64p(out))
    return out


def reduce_by_ntt_modulus(coeffs: np.ndarray, shift_ntt: np.ndarray,
                          tail_len: int, tw_f: np.ndarray,
                          tw_i: np.ndarray, n_inv: int) -> np.ndarray:
    """Whole chunked structured-modulus reduction in one native call
    (the reduce_by_ntt_friendly_modulus loop). Returns the surviving
    window of len(shift_ntt) coefficients."""
    lib = _load()
    assert lib is not None
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint64)
    shift_ntt = np.ascontiguousarray(shift_ntt, dtype=np.uint64)
    out = np.empty(shift_ntt.size, dtype=np.uint64)
    lib.gl_reduce_by_ntt_modulus(
        _u64p(coeffs), coeffs.size, _u64p(shift_ntt), shift_ntt.size,
        tail_len, _u64p(tw_f), _u64p(tw_i), ctypes.c_uint64(n_inv),
        _u64p(out))
    return out


def horner_points(coeffs: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Multipoint evaluation: (k,) coefficients at (m,) points -> (m,)
    via lane-blocked Horner (8 points per vector, OpenMP across blocks)."""
    lib = _load()
    assert lib is not None
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint64)
    pts = np.ascontiguousarray(pts, dtype=np.uint64)
    out = np.empty(pts.shape[0], dtype=np.uint64)
    lib.gl_horner_points(_u64p(coeffs), coeffs.size, _u64p(pts),
                         pts.size, _u64p(out))
    return out


def tip5_merkle_root(leafs: np.ndarray) -> np.ndarray:
    """Frugal Merkle root of (n, 5) uint64 leafs, n a power of two —
    the whole layer loop stays in native code."""
    lib = _load()
    assert lib is not None
    leafs = np.ascontiguousarray(leafs, dtype=np.uint64)
    root = np.empty(5, dtype=np.uint64)
    lib.tip5_merkle_root(_u64p(leafs), _u64p(root), leafs.shape[0])
    return root


def ntt_inplace(x: np.ndarray, root: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    out = np.ascontiguousarray(x, dtype=np.uint64).copy()
    lib.gl_ntt(_u64p(out), out.size, ctypes.c_uint64(root))
    return out


def intt_inplace(x: np.ndarray, root_inv: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    out = np.ascontiguousarray(x, dtype=np.uint64).copy()
    lib.gl_intt(_u64p(out), out.size, ctypes.c_uint64(root_inv))
    return out


def ntt_rows_inplace(x: np.ndarray, stage_tw: np.ndarray,
                     n_inv: int = 0) -> None:
    """Row-batched in-place NTT of a C-contiguous (rows, n) uint64 array,
    with caller-precomputed concatenated stage twiddles (length n-1)."""
    lib = _load()
    assert lib is not None
    rows, n = x.shape
    lib.gl_ntt_rows(_u64p(x), rows, n, _u64p(stage_tw),
                    ctypes.c_uint64(n_inv))


def batch_inverse(x: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    xc = np.ascontiguousarray(x, dtype=np.uint64)
    out = np.empty_like(xc)
    lib.gl_batch_inverse(_u64p(xc), _u64p(out), xc.size)
    return out


def batch_inverse_or_zero(x: np.ndarray) -> np.ndarray:
    """Elementwise inverse-or-zero (zero-tolerant Montgomery trick)."""
    lib = _load()
    assert lib is not None
    xc = np.ascontiguousarray(x, dtype=np.uint64)
    out = np.empty_like(xc)
    lib.gl_batch_inverse_or_zero(_u64p(xc), _u64p(out), xc.size)
    return out


def lagrange_interpolate(dom: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """O(n^2) zerofier-based Lagrange interpolation on canonical uint64
    arrays; returns the (n,) coefficient array."""
    lib = _load()
    assert lib is not None
    dom = np.ascontiguousarray(dom, dtype=np.uint64)
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    out = np.empty_like(vals)
    lib.gl_lagrange_interpolate(_u64p(dom), _u64p(vals), dom.size, _u64p(out))
    return out


def poly_divmod(num: np.ndarray, den: np.ndarray):
    """Long division on coefficient arrays (degree = len-1, no trailing
    zeros in den). Returns (quotient, remainder) arrays."""
    lib = _load()
    assert lib is not None
    num = np.ascontiguousarray(num, dtype=np.uint64)
    den = np.ascontiguousarray(den, dtype=np.uint64)
    dn, dd = num.size - 1, den.size - 1
    assert dd >= 0 and den[dd] != 0
    if dn < dd:
        return np.zeros(1, dtype=np.uint64), num.copy()
    quot = np.empty(dn - dd + 1, dtype=np.uint64)
    rem = np.empty(max(dd, 1), dtype=np.uint64)
    lib.gl_poly_divmod(_u64p(num), dn, _u64p(den), dd, _u64p(quot),
                       _u64p(rem))
    return quot, rem[:dd]
