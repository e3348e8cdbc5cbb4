"""The mod-p "semi-inverse": maximal-invertible-submatrix Gauss-Jordan.

Given the n x n Gram matrix U, compute a partial inverse W and a 0/1
diagonal mask d with d*W == W*d == W and d == W*U*d, returning the number of
pivots (0 pivots == Lanczos termination).  Semantics follow the reference's
two-phase elimination (reference: sequential/lanczos_modp.c:342-438) exactly
— phase 1 discovers the pivotable column set d, phase 2 re-eliminates on the
d-masked matrix while accumulating W — so iterates stay bit-identical.

Two implementations:

  * `semi_inverse_np`: host NumPy oracle (u64 intermediates are exact for
    p < 2^30); used for tests and host-driven solves.
  * `semi_inverse_device`: branch-free masked formulation (fori_loop +
    one-hot row swaps + Fermat inversion) that runs *inside* jit, so the
    whole Lanczos iteration stays on-device with no host round trip — the
    answer to the reference's "inherently sequential, never
    parallelized" host step (SURVEY.md section 2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from block_lanczos_tpu.ops import gfp
from block_lanczos_tpu.ops.gfp import GFp, u32


# ---------------------------------------------------------------------------
# Host oracle
# ---------------------------------------------------------------------------

def _eliminate_np(p: int, M: np.ndarray, W: np.ndarray | None):
    """One Gauss-Jordan sweep; updates M (and W) in place, returns (d, npiv)."""
    n = M.shape[0]
    d = np.zeros(n, np.uint32)
    npiv = 0
    for j in range(n):
        pivots = np.nonzero(M[j:, j])[0]
        if len(pivots) == 0:
            continue
        pivot = j + int(pivots[0])
        d[j] = 1
        npiv += 1
        pinv = np.uint64(pow(int(M[pivot, j]), p - 2, p))
        M[pivot] = (M[pivot].astype(np.uint64) * pinv % p).astype(np.uint32)
        M[[j, pivot]] = M[[pivot, j]]
        if W is not None:
            W[pivot] = (W[pivot].astype(np.uint64) * pinv % p).astype(np.uint32)
            W[[j, pivot]] = W[[pivot, j]]
        mult = (np.uint64(p) - M[:, j].astype(np.uint64)) % p  # -M[i,j]
        mult[j] = 0
        M[:] = ((M.astype(np.uint64) + mult[:, None] * M[j].astype(np.uint64))
                % p).astype(np.uint32)
        if W is not None:
            W[:] = ((W.astype(np.uint64) + mult[:, None] * W[j].astype(np.uint64))
                    % p).astype(np.uint32)
    return d, npiv


def semi_inverse_np(p: int, U: np.ndarray):
    """Return (winv, d, npiv) for the n x n uint32 matrix U mod p."""
    n = U.shape[0]
    M = U.astype(np.uint32).copy()
    d1, _ = _eliminate_np(p, M, None)                      # phase 1: find d
    mask = (d1[:, None] & d1[None, :]).astype(bool)
    M2 = np.where(mask, U, 0).astype(np.uint32)            # phase 2 input
    W = (np.eye(n, dtype=np.uint32) * d1)                  # masked identity
    d, npiv = _eliminate_np(p, M2, W)
    return W, d, npiv


# ---------------------------------------------------------------------------
# On-device masked version (jit-safe)
# ---------------------------------------------------------------------------

def _eliminate_device(f: GFp, M, W):
    """Masked Gauss-Jordan sweep over columns; returns (M, W, d, npiv)."""
    n = M.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]

    def body(j, state):
        M, W, d, npiv = state
        col = jax.lax.dynamic_index_in_dim(M.T, j, 0, keepdims=False)
        cand = (col != u32(0)) & (rows >= j)
        found = jnp.any(cand)
        pivot = jnp.argmax(cand).astype(jnp.int32)  # first True

        pivot_val = jax.lax.dynamic_index_in_dim(col, pivot, 0, keepdims=False)
        pinv_m = gfp.to_mont(
            f, gfp.modinv_device(f, jnp.maximum(pivot_val, u32(1))))

        # M and W see the SAME row swap/normalization, and `mult` for W's
        # update comes from M's post-swap column (the reference updates winv
        # with M's multiplier: sequential/lanczos_modp.c:423-434)
        perm = jnp.where(rows == j, pivot, jnp.where(rows == pivot, j, rows))
        M2 = M[perm, :]
        W2 = W[perm, :]
        rowj_M = gfp.mont_mul(f, M2[j, :], pinv_m)
        rowj_W = gfp.mont_mul(f, W2[j, :], pinv_m)
        M2 = jax.lax.dynamic_update_index_in_dim(M2, rowj_M, j, 0)
        W2 = jax.lax.dynamic_update_index_in_dim(W2, rowj_W, j, 0)
        colj = jax.lax.dynamic_index_in_dim(M2.T, j, 0, keepdims=False)
        mult = gfp.modneg(f, colj)
        is_j = (rows == j)[:, None]
        M3 = jnp.where(is_j, M2, gfp.modadd(
            f, M2, gfp.mont_mul(f, mult[:, None], gfp.to_mont(f, rowj_M)[None, :])))
        W3 = jnp.where(is_j, W2, gfp.modadd(
            f, W2, gfp.mont_mul(f, mult[:, None], gfp.to_mont(f, rowj_W)[None, :])))

        M = jnp.where(found, M3, M)
        W = jnp.where(found, W3, W)
        d = d.at[j].set(found.astype(u32))
        npiv = npiv + found.astype(jnp.int32)
        return M, W, d, npiv

    d0 = jnp.zeros(n, u32)
    return jax.lax.fori_loop(0, n, body, (M, W, d0, jnp.int32(0)))


def semi_inverse_device(f: GFp, U):
    """(winv, d, npiv) on device; matches semi_inverse_np bit-for-bit."""
    n = U.shape[0]
    scratch_w = jnp.zeros_like(U)  # phase 1 does not track W; pass dummy
    _, _, d1, _ = _eliminate_device(f, U, scratch_w)
    mask = (d1[:, None] * d1[None, :]).astype(bool)
    M2 = jnp.where(mask, U, u32(0))
    W0 = jnp.eye(n, dtype=u32) * d1[None, :]
    _, W, d, npiv = _eliminate_device(f, M2, W0)
    return W, d, npiv
