"""Exact mod-p collectives over a device mesh.

MPI has no modular-arithmetic reduction, so the reference hand-rolls
Send/Recv loops that sum partials u64-exactly at a communicator root
(reference: mpi/lanczos_modp.c:1088-1125, comment "not using MPI_Reduce to
avoid overflow").  Here we get exactness *and* the native all-reduce:
partials < p < 2^30 are split into 15-bit limbs, each limb is psum'd in
uint32 (safe for up to 2^17 devices), and the limbs are recombined mod p.
The result is bit-exact, order-independent, and replicated — no root.
"""

from __future__ import annotations

import jax

from block_lanczos_tpu.ops import gfp
from block_lanczos_tpu.ops.gfp import GFp


def psum_mod(f: GFp, x, axis_name: str):
    """Exact sum mod p of per-device partials (each in [0, p))."""
    hi, lo = gfp.limb_split(x)
    hi_s = jax.lax.psum(hi, axis_name)
    lo_s = jax.lax.psum(lo, axis_name)
    return gfp.limb_combine(f, hi_s, lo_s)


def psum_mod_wide(f2, x, axis_name: str):
    """Exact wide-field (p < 2^62) psum: five 15-bit limbs, recombined.

    f2: ops.gfp_wide.GFpWide; x: (..., 2) uint32 pairs in [0, p).
    Safe for up to 2^17 devices (each limb < 2^15 per partial).
    """
    from block_lanczos_tpu.ops import gfp_wide as gw
    limbs = gw.limb_split(x)                      # (..., 5)
    limbs_s = jax.lax.psum(limbs, axis_name)
    return gw.limb_combine(f2, limbs_s)
