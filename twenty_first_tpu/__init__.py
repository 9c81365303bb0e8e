"""twenty_first_tpu — STARK primitives for JAX accelerators.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of the
`twenty-first` Rust crate: Goldilocks-field and cubic-extension arithmetic,
batched NTT/iNTT, polynomial algebra, the Tip5 permutation/sponge, Merkle
trees and Merkle Mountain Ranges, lattice crypto in F_p[X]/(X^64+1) with a
KEM, and BFieldCodec serialization — designed batch-first for device meshes.
"""

__version__ = "0.1.0"

# Native-u64 planes (math/gf64.py, the Tip5 GPU kernel, the opt-in u64 NTT
# and multiply routes) need the x64 flag, which must be set before the
# first trace.
import jax as _jax

_jax.config.update("jax_enable_x64", True)

from . import errors  # noqa: F401
from . import math  # noqa: F401
from . import tip5  # noqa: F401
from . import util_types  # noqa: F401
from . import config  # noqa: F401
from . import prelude  # noqa: F401
