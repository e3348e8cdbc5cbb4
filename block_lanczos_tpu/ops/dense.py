"""Dense mod-p block linear algebra on the device.

Covers the reference's L3/L4 layers (matmul_CpAB / matmul_CpAtB /
block_dot_products; reference: sequential/lanczos_modp.c:292-315,443-453)
with uint32-only formulations:

  * tile products (N x k) * (k x m) with k, m <= block width n: one
    mont_mul per scalar product and a 15-bit-limb exact sum over k
    (k <= 64 << 2^17, so a single limb pass is always safe),
  * tall Gram contractions V^T W over millions of rows: lax.scan over row
    chunks, limb-summing each chunk and mod-adding across chunks — the
    functional, overflow-proof version of the reference's per-thread u64
    cache + critical-section merge (openMP/lanczos_modp.c:681-712).

Inputs/outputs are standard-form uint32 residues; the small right-hand
matrices are converted to the Montgomery domain once per call (O(n^2) work
amortized over O(N n^2)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from block_lanczos_tpu.ops import gfp
from block_lanczos_tpu.ops.gfp import GFp, u32


def matmul_mod(f: GFp, X, B):
    """(N, k) @ (k, m) mod p with small k, m (block-width-sized)."""
    Bm = gfp.to_mont(f, B)
    return matmul_mont(f, X, Bm)


def matmul_mont(f: GFp, X, Bm):
    """(N, k) @ (k, m) mod p where Bm is already Montgomery-form."""
    prod = gfp.mont_mul(f, X[..., :, None], Bm[None, :, :])  # (N, k, m)
    hi, lo = gfp.limb_split(prod)
    # k <= 64 terms of 15-bit limbs: far below the uint32 overflow bound
    return gfp.limb_combine(f, jnp.sum(hi, axis=-2), jnp.sum(lo, axis=-2))


def _gram_chunk_rows(n_cols_sq: int) -> int:
    """Row-chunk size: bounded by the limb-sum cap and a ~32MB temp budget
    (set before the H100 port; not measured on the H100, ROADMAP C5)."""
    budget = max(256, (1 << 23) // max(n_cols_sq, 1))
    return min(gfp.LIMB_SUM_MAX, budget)


def gram_mod(f: GFp, V, W):
    """V^T @ W mod p for (N, a) and (N, b) blocks, N arbitrary, exact.

    Scans row chunks; each chunk contributes an exact (a, b) partial.
    """
    N, a = V.shape
    b = W.shape[1]
    chunk = _gram_chunk_rows(a * b)
    Wm = gfp.to_mont(f, W)

    def chunk_gram(Vc, Wc):
        prod = gfp.mont_mul(f, Vc[:, :, None], Wc[:, None, :])  # (c, a, b)
        hi, lo = gfp.limb_split(prod)
        return gfp.limb_combine(f, jnp.sum(hi, axis=0), jnp.sum(lo, axis=0))

    if N <= chunk:
        return chunk_gram(V, Wm)

    pad = (-N) % chunk
    if pad:  # zero rows contribute nothing
        V = jnp.pad(V, ((0, pad), (0, 0)))
        Wm = jnp.pad(Wm, ((0, pad), (0, 0)))
    nchunks = (N + pad) // chunk

    def body(acc, vw):
        Vc, Wc = vw
        return gfp.modadd(f, acc, chunk_gram(Vc, Wc)), None

    acc0 = gfp.zeros_vma_like((V, Wm), (a, b))  # joined vma carry
    acc, _ = jax.lax.scan(
        body, acc0,
        (V.reshape(nchunks, chunk, a), Wm.reshape(nchunks, chunk, b)))
    return acc


def matmul_nn_mod(f: GFp, A, B):
    """Small (n, n) @ (n, n) mod p (host-sized but device-resident)."""
    return matmul_mod(f, A, B)
