"""Exact GF(p) arithmetic built on uint32 only.

The reference's pervasive "accumulate in u64, reduce % p" idiom
(reference: sequential/lanczos_modp.c:280-285) is not used: every device
value stays uint32, so the program needs no 64-bit integer support
(whether native u64 pays on the H100 is not measured, ROADMAP C6).
This module provides:

  * a full 32x32 -> hi/lo-64 multiply from 16-bit limb products (uint32 only),
  * Montgomery multiplication with R = 2^32 for odd p (exact, branch-free),
  * a direct (a*b) % p path for p = 2 (the only even prime),
  * exact overflow-safe summation via 15-bit limb splitting: any value < 2^30
    splits into two limbs < 2^15, each of which can be summed 2^17 times in
    uint32 without overflow, then recombined mod p.

All device values live in [0, p) as uint32 unless explicitly documented as
being in the Montgomery domain (x*R mod p).  The prime is capped at
2^30 - 35 like the reference (sequential/lanczos_modp.c:189-193), which also
guarantees every residue fits in 30 bits — the invariant the limb-splitting
tricks rely on.

The `GFp` context is a small frozen (hashable) dataclass of host-precomputed
constants; it is always passed statically (closed over / static_argnum) so
everything under jit specializes on the prime.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

u32 = jnp.uint32

PRIME_CAP = 0x3FFFFFDD  # 2^30 - 35, same cap as the reference

# Max number of 15-bit limbs that can be accumulated in uint32 without overflow.
LIMB_SUM_MAX = 1 << 17


def _invmod_int(a: int, m: int) -> int:
    """Host modular inverse (extended Euclid) over Python ints."""
    t, nt, r, nr = 0, 1, m, a % m
    while nr != 0:
        q = r // nr
        t, nt = nt, t - q * nt
        r, nr = nr, r - q * nr
    if r != 1:
        raise ValueError(f"{a} is not invertible mod {m}")
    return t % m


@dataclasses.dataclass(frozen=True)
class GFp:
    """Precomputed constants for arithmetic mod a prime p.

    use_mont is True for odd p (Montgomery, R = 2^32); for p = 2 we fall back
    to a direct (a*b) % p path (products fit uint32 trivially).
    """

    p: int
    use_mont: bool
    pprime: int  # -p^-1 mod 2^32           (mont only)
    r1: int      # R   mod p == to_mont(1)
    r2: int      # R^2 mod p  (to_mont multiplier)
    c15: int     # to_mont(2^15)  — limb recombination constant
    c30: int     # to_mont(2^30)

    @staticmethod
    def make(p: int) -> "GFp":
        p = int(p)
        if p < 2:
            raise ValueError("p must be >= 2")
        if p > PRIME_CAP:
            raise ValueError(f"p is capped at 2**30 - 35 (got {p})")
        if p % 2 == 1:
            R = 1 << 32
            pprime = (-_invmod_int(p, R)) % R
            r1 = R % p
            r2 = (R * R) % p
            c15 = ((1 << 15) * R) % p
            c30 = ((1 << 30) * R) % p
            return GFp(p=p, use_mont=True, pprime=pprime, r1=r1, r2=r2,
                       c15=c15, c30=c30)
        if p != 2:
            raise ValueError("p must be prime; the only even prime is 2")
        # Direct mode: the "Montgomery domain" degenerates to the identity.
        return GFp(p=2, use_mont=False, pprime=0, r1=1, r2=1,
                   c15=(1 << 15) % 2, c30=(1 << 30) % 2)

    # -- host-side scalar helpers ------------------------------------------
    def invmod(self, a: int) -> int:
        return _invmod_int(int(a), self.p)

    def to_mont_int(self, x: int) -> int:
        return (int(x) * (1 << 32)) % self.p if self.use_mont else int(x) % self.p

    def from_mont_int(self, x: int) -> int:
        if not self.use_mont:
            return int(x) % self.p
        rinv = _invmod_int(1 << 32, self.p)
        return (int(x) * rinv) % self.p


# ---------------------------------------------------------------------------
# 32x32 -> 64 multiply from 16-bit limbs (all uint32)
# ---------------------------------------------------------------------------

def mulhi32(a, b):
    """floor(a*b / 2^32) for uint32 arrays, via 16-bit limb products."""
    a = a.astype(u32)
    b = b.astype(u32)
    mask = u32(0xFFFF)
    al, ah = a & mask, a >> 16
    bl, bh = b & mask, b >> 16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    # carry column: (ll >> 16) + lo16(lh) + lo16(hl) < 3 * 2^16, fits uint32
    t = (ll >> 16) + (lh & mask) + (hl & mask)
    return hh + (lh >> 16) + (hl >> 16) + (t >> 16)


def mullo32(a, b):
    """a*b mod 2^32 (native wrap-around uint32 multiply)."""
    return a.astype(u32) * b.astype(u32)


def zeros_vma_like(ref, shape, dtype=u32):
    """Zeros of `shape` carrying the JOINED varying-manual-axes type of
    `ref` (one array, or a tuple/list of arrays).

    A plain jnp.zeros carry is axis-INVARIANT under shard_map; if the loop
    body produces a varying value (anything derived from sharded operands),
    lax.scan/fori_loop reject the carry-type mismatch — but only at shapes
    big enough to take the chunked path, which small-matrix tests never
    reach.  Deriving the zero from a varying operand (x & 0 broadcast) is
    a no-op numerically, folds away in XLA, and carries the right type in
    BOTH shard_map and plain-jit contexts.

    Pass EVERY operand the loop body reads: a loop joining a vector (e.g.
    varying only over "rows" — or over "cols" after a psum) with matrix
    leaves (varying over BOTH mesh axes) produces the joined type, and a
    carry seeded from the vector alone mismatches (round-4 regression:
    the spill-scan SpMV crashed at >2^17-entry spill segments under the
    mesh — tests/test_sharded.py pins every such path now).
    """
    refs = ref if isinstance(ref, (tuple, list)) else (ref,)
    z = None
    for r in refs:
        t = (r[(0,) * r.ndim] & r.dtype.type(0)).astype(dtype)
        z = t if z is None else z + t      # still zero; vma types join
    return jnp.zeros(shape, dtype) + z


# ---------------------------------------------------------------------------
# Core field ops.  All take/return uint32 arrays with values in [0, p).
# ---------------------------------------------------------------------------

def modadd(f: GFp, a, b):
    s = a + b  # both < p < 2^30 -> no overflow
    return jnp.where(s >= u32(f.p), s - u32(f.p), s)


def modsub(f: GFp, a, b):
    r = a - b  # wraps mod 2^32 when a < b
    return jnp.where(a >= b, r, r + u32(f.p))


def modneg(f: GFp, a):
    return jnp.where(a == u32(0), u32(0), u32(f.p) - a)


def mont_mul(f: GFp, a, b):
    """Montgomery product a*b*R^-1 mod p (R = 2^32) for odd p.

    For p = 2 ("direct" mode) this is a plain modular product; the Montgomery
    domain is the identity there, so all domain bookkeeping still works.
    """
    if not f.use_mont:
        return (mullo32(a, b)) % u32(f.p)
    lo = mullo32(a, b)
    m = mullo32(lo, u32(f.pprime))
    # lo(a*b) + lo(m*p) == 0 mod 2^32; carry out iff lo != 0.
    carry = (lo != u32(0)).astype(u32)
    t = mulhi32(a, b) + mulhi32(m, u32(f.p)) + carry  # t < 2p < 2^31
    return jnp.where(t >= u32(f.p), t - u32(f.p), t)


def to_mont(f: GFp, x):
    return mont_mul(f, x, jnp.asarray(f.r2, u32))


def from_mont(f: GFp, x):
    return mont_mul(f, x, jnp.asarray(1, u32))


def modmul(f: GFp, a, b):
    """Plain a*b mod p (both operands in standard form).  Two mont products."""
    return mont_mul(f, a, to_mont(f, b))


def mont_pow_const(f: GFp, a_mont, e: int):
    """a^e mod p with e a static Python int; input/output in Montgomery form.

    Unrolled square-and-multiply at trace time (<= 30 bits for our p cap).
    """
    acc = jnp.broadcast_to(jnp.asarray(f.r1, u32), jnp.shape(a_mont))
    if e == 0:
        return acc
    for bit in bin(int(e))[2:]:
        acc = mont_mul(f, acc, acc)
        if bit == "1":
            acc = mont_mul(f, acc, a_mont)
    return acc


def modinv_device(f: GFp, a):
    """a^-1 mod p on device via Fermat (a^(p-2)); a in standard form.

    Returns garbage for a == 0 (0), matching the caller's contract to only
    invert pivots that were tested nonzero.
    """
    am = to_mont(f, a)
    inv_m = mont_pow_const(f, am, f.p - 2)
    return from_mont(f, inv_m)


# ---------------------------------------------------------------------------
# Exact overflow-safe summation (15-bit limb splitting)
# ---------------------------------------------------------------------------

def limb_split(x):
    """v < 2^30  ->  (hi, lo) with v = hi*2^15 + lo, both < 2^15."""
    return x >> 15, x & u32(0x7FFF)


def limb_combine(f: GFp, hi_sum, lo_sum):
    """Recombine limb sums (each any uint32) into [0, p): (hi*2^15 + lo) mod p."""
    hi_m = hi_sum % u32(f.p)
    lo_m = lo_sum % u32(f.p)
    return modadd(f, mont_mul(f, hi_m, jnp.asarray(f.c15, u32)), lo_m)


def sum_mod(f: GFp, x, axis: int = 0):
    """Exact sum mod p along `axis` for values in [0, p); any length.

    Uses limb splitting; lengths beyond LIMB_SUM_MAX are chunked recursively.
    """
    x = jnp.asarray(x, u32)
    axis = axis % x.ndim
    n = x.shape[axis]
    if n == 0:
        return jnp.zeros(x.shape[:axis] + x.shape[axis + 1:], u32)
    if n <= LIMB_SUM_MAX:
        hi, lo = limb_split(x)
        return limb_combine(f, jnp.sum(hi, axis=axis), jnp.sum(lo, axis=axis))
    chunk = LIMB_SUM_MAX
    npad = (-n) % chunk
    if npad:
        pad_width = [(0, 0)] * x.ndim
        pad_width[axis] = (0, npad)
        x = jnp.pad(x, pad_width)  # zeros are additive identity
    new_shape = x.shape[:axis] + ((n + npad) // chunk, chunk) + x.shape[axis + 1:]
    x = x.reshape(new_shape)
    partial_sums = sum_mod(f, x, axis=axis + 1)  # (..., nchunks, ...), < p
    return sum_mod(f, partial_sums, axis=axis)


def segment_sum_mod(f: GFp, x, segment_ids, num_segments: int):
    """Exact segment sum mod p.

    Caller contract: every segment has at most LIMB_SUM_MAX elements *within
    this call* (the sparse layer chunks the nnz axis to guarantee it and
    mod-adds partial outputs across chunks).
    """
    hi, lo = limb_split(jnp.asarray(x, u32))
    hi_s = jax.ops.segment_sum(hi, segment_ids, num_segments=num_segments)
    lo_s = jax.ops.segment_sum(lo, segment_ids, num_segments=num_segments)
    return limb_combine(f, hi_s, lo_s)


# ---------------------------------------------------------------------------
# NumPy oracle (host, exact via int64/object) — used by tests and the checker
# ---------------------------------------------------------------------------

def np_modmul(p: int, a, b):
    return ((a.astype(np.uint64) * b.astype(np.uint64)) % np.uint64(p)).astype(np.uint32)


def np_matmul_mod(p: int, A, B):
    """Exact (A @ B) mod p on host for uint32 inputs; reduces per k-step."""
    A = A.astype(np.uint64)
    B = B.astype(np.uint64)
    K = A.shape[-1]
    C = np.zeros(A.shape[:-1] + B.shape[1:], np.uint64)
    for k in range(K):  # products < 2^60; one addition then reduce: exact
        C = (C + A[..., k:k + 1] * B[k]) % np.uint64(p)
    return C.astype(np.uint32)
