"""Exact GF(p) arithmetic for WIDE primes (p < 2^62) on uint32 pairs.

The reference caps the prime at 2^30 - 35 because its entire design rests
on "accumulate in u64, reduce % p" with ~16 unreduced additions of
(p-1)^2 products fitting u64 (reference: sequential/lanczos_modp.c:189-193,
doc/sujet.pdf section 5).  Record-size discrete-log computations want
larger fields; this module removes the cap up to p < 2^62 — a capability
the reference does not have.

Representation: a field element is a pair of uint32 limbs (lo, hi) with
value hi*2^32 + lo, carried as an array whose TRAILING axis has size 2
("...2" shapes).  All arithmetic is built from 32x32->64 multiplies
(16-bit limb products, ops/gfp.py) with explicit carry propagation:

  * 64x64 -> 128 multiply (4 widening mul32 + carry columns),
  * Montgomery reduction with R = 2^64 for odd p,
  * exact overflow-safe summation via 15-bit limb splitting: a 62-bit
    value splits into FIVE 15-bit limbs, each summable 2^17 times in
    uint32 without overflow (same discipline as the narrow field).

Every value lives in [0, p).  The `GFpWide` context mirrors `GFp`
(host-precomputed constants, hashable, closed over statically).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from block_lanczos_tpu.ops.gfp import _invmod_int, mulhi32, mullo32, u32

WIDE_PRIME_CAP = (1 << 62) - 1

# number of 15-bit limbs covering a 62-bit value
N_LIMBS = 5
LIMB_SUM_MAX = 1 << 17  # per-limb addend cap for exact uint32 sums


@dataclasses.dataclass(frozen=True)
class GFpWide:
    """Constants for arithmetic mod an ODD prime p < 2^62 (R = 2^64)."""

    p: int
    p_lo: int
    p_hi: int
    pprime_lo: int  # -p^-1 mod 2^64, low word
    pprime_hi: int
    r1: tuple      # R mod p       == to_mont(1), as (lo, hi) ints
    r2: tuple      # R^2 mod p     (to_mont multiplier)
    c15: tuple     # to_mont(2^15k) for k = 0..N_LIMBS-1, ((lo,hi),...)

    @staticmethod
    def make(p: int) -> "GFpWide":
        p = int(p)
        if p < 3 or p % 2 == 0:
            raise ValueError("GFpWide requires an odd prime p >= 3")
        if p > WIDE_PRIME_CAP:
            raise ValueError(f"wide p is capped at 2**62 - 1 (got {p})")
        R = 1 << 64
        pprime = (-_invmod_int(p, R)) % R
        r1 = R % p
        r2 = (R * R) % p
        c15 = tuple(((1 << (15 * k)) * R % p) for k in range(N_LIMBS))
        lohi = lambda v: (v & 0xFFFFFFFF, v >> 32)
        return GFpWide(
            p=p, p_lo=p & 0xFFFFFFFF, p_hi=p >> 32,
            pprime_lo=pprime & 0xFFFFFFFF, pprime_hi=pprime >> 32,
            r1=lohi(r1), r2=lohi(r2),
            c15=tuple(lohi(c) for c in c15))

    # -- host-side helpers --------------------------------------------------
    def invmod(self, a: int) -> int:
        return _invmod_int(int(a), self.p)

    def to_mont_int(self, x: int) -> int:
        return (int(x) << 64) % self.p

    def from_mont_int(self, x: int) -> int:
        return (int(x) * _invmod_int(1 << 64, self.p)) % self.p


# ---------------------------------------------------------------------------
# pair helpers.  A "pair" is an array with trailing axis 2: [..., (lo, hi)].
# ---------------------------------------------------------------------------

def pair(lo, hi):
    return jnp.stack([jnp.asarray(lo, u32), jnp.asarray(hi, u32)], axis=-1)


def const_pair(f_or_tuple, shape=()):
    lo, hi = f_or_tuple
    return jnp.broadcast_to(pair(jnp.full(shape, lo, u32),
                                 jnp.full(shape, hi, u32)), shape + (2,))


def np_pair(vals, dtype=np.uint32):
    """Host: int array (object/int64/uint64) -> (..., 2) uint32 pairs."""
    vals = np.asarray(vals, dtype=object)
    lo = (vals & 0xFFFFFFFF).astype(np.uint32)
    hi = (vals >> 32).astype(np.uint32)
    return np.stack([lo, hi], axis=-1)


def np_unpair(p2):
    """Host: (..., 2) uint32 pairs -> object int array."""
    p2 = np.asarray(p2)
    return (p2[..., 1].astype(object) << 32) + p2[..., 0].astype(object)


def _add64(alo, ahi, blo, bhi):
    """64-bit add, NO carry-out tracking (caller guarantees < 2^64)."""
    lo = alo + blo
    carry = (lo < alo).astype(u32)
    return lo, ahi + bhi + carry


def _add64c(alo, ahi, blo, bhi):
    """64-bit add WITH carry-out (0/1)."""
    lo = alo + blo
    c0 = (lo < alo).astype(u32)
    hi = ahi + bhi
    c1 = (hi < ahi).astype(u32)
    hi2 = hi + c0
    c2 = (hi2 < hi).astype(u32)
    return lo, hi2, c1 + c2


def _sub64(alo, ahi, blo, bhi):
    """64-bit subtract assuming a >= b."""
    lo = alo - blo
    borrow = (alo < blo).astype(u32)
    return lo, ahi - bhi - borrow


def _geq64(alo, ahi, blo, bhi):
    return (ahi > bhi) | ((ahi == bhi) & (alo >= blo))


def modadd(f: GFpWide, a, b):
    """(a + b) mod p; both < p < 2^62 so the raw sum fits 64 bits."""
    lo, hi = _add64(a[..., 0], a[..., 1], b[..., 0], b[..., 1])
    plo, phi = u32(f.p_lo), u32(f.p_hi)
    ge = _geq64(lo, hi, plo, phi)
    rlo, rhi = _sub64(lo, hi, plo, phi)
    return pair(jnp.where(ge, rlo, lo), jnp.where(ge, rhi, hi))


def modsub(f: GFpWide, a, b):
    alo, ahi = a[..., 0], a[..., 1]
    blo, bhi = b[..., 0], b[..., 1]
    ge = _geq64(alo, ahi, blo, bhi)
    d_lo, d_hi = _sub64(alo, ahi, blo, bhi)
    # a < b: a + p - b  (fits: a + p < 2^63)
    slo, shi = _add64(alo, ahi, u32(f.p_lo), u32(f.p_hi))
    w_lo, w_hi = _sub64(slo, shi, blo, bhi)
    return pair(jnp.where(ge, d_lo, w_lo), jnp.where(ge, d_hi, w_hi))


def modneg(f: GFpWide, a):
    zero = (a[..., 0] == 0) & (a[..., 1] == 0)
    rlo, rhi = _sub64(u32(f.p_lo), u32(f.p_hi), a[..., 0], a[..., 1])
    return pair(jnp.where(zero, u32(0), rlo), jnp.where(zero, u32(0), rhi))


def _mul32x32(a, b):
    """u32 x u32 -> (lo, hi) u32."""
    return mullo32(a, b), mulhi32(a, b)


def _mul64_128(alo, ahi, blo, bhi):
    """64x64 -> 128 as four u32 words (r0..r3, little-endian)."""
    ll_lo, ll_hi = _mul32x32(alo, blo)
    lh_lo, lh_hi = _mul32x32(alo, bhi)
    hl_lo, hl_hi = _mul32x32(ahi, blo)
    hh_lo, hh_hi = _mul32x32(ahi, bhi)
    r0 = ll_lo
    # column 1: ll_hi + lh_lo + hl_lo  (carries into column 2)
    s1 = ll_hi + lh_lo
    c1 = (s1 < ll_hi).astype(u32)
    r1 = s1 + hl_lo
    c1 = c1 + (r1 < s1).astype(u32)
    # column 2: lh_hi + hl_hi + hh_lo + c1
    s2 = lh_hi + hl_hi
    c2 = (s2 < lh_hi).astype(u32)
    s3 = s2 + hh_lo
    c2 = c2 + (s3 < s2).astype(u32)
    r2 = s3 + c1
    c2 = c2 + (r2 < s3).astype(u32)
    r3 = hh_hi + c2  # no overflow: product < 2^124
    return r0, r1, r2, r3


def _mul64_lo64(alo, ahi, blo, bhi):
    """64x64 -> low 64 bits only."""
    ll_lo, ll_hi = _mul32x32(alo, blo)
    r1 = ll_hi + mullo32(alo, bhi) + mullo32(ahi, blo)
    return ll_lo, r1


def mont_mul(f: GFpWide, a, b):
    """Montgomery product a*b*R^-1 mod p (R = 2^64) on pair arrays."""
    alo, ahi = a[..., 0], a[..., 1]
    blo, bhi = b[..., 0], b[..., 1]
    t0, t1, t2, t3 = _mul64_128(alo, ahi, blo, bhi)
    # m = (T mod 2^64) * p' mod 2^64
    m0, m1 = _mul64_lo64(t0, t1, u32(f.pprime_lo), u32(f.pprime_hi))
    # U = m * p  (128 bits); T + U has zero low 64 bits by construction.
    u0, u1, u2, u3 = _mul64_128(m0, m1, u32(f.p_lo), u32(f.p_hi))
    # low-half add, only the carry-out matters
    s0 = t0 + u0
    c0 = (s0 < t0).astype(u32)
    s1 = t1 + u1
    c1a = (s1 < t1).astype(u32)
    s1c = s1 + c0
    c1 = c1a + (s1c < s1).astype(u32)
    # high half: (t2,t3) + (u2,u3) + c1   (result < 2p < 2^63, no overflow)
    rlo, rhi = _add64(t2, t3, u2, u3)
    rlo2 = rlo + c1
    rhi = rhi + (rlo2 < rlo).astype(u32)
    rlo = rlo2
    plo, phi = u32(f.p_lo), u32(f.p_hi)
    ge = _geq64(rlo, rhi, plo, phi)
    qlo, qhi = _sub64(rlo, rhi, plo, phi)
    return pair(jnp.where(ge, qlo, rlo), jnp.where(ge, qhi, rhi))


def to_mont(f: GFpWide, x):
    return mont_mul(f, x, const_pair(f.r2, jnp.shape(x)[:-1]))


def from_mont(f: GFpWide, x):
    one = pair(jnp.ones(jnp.shape(x)[:-1], u32),
               jnp.zeros(jnp.shape(x)[:-1], u32))
    return mont_mul(f, x, one)


def modmul(f: GFpWide, a, b):
    return mont_mul(f, a, to_mont(f, b))


def mont_pow_const(f: GFpWide, a_mont, e: int):
    """a^e (static e) in Montgomery form; unrolled square-and-multiply."""
    shape = jnp.shape(a_mont)[:-1]
    acc = const_pair(f.r1, shape)
    if e == 0:
        return acc
    for bit in bin(int(e))[2:]:
        acc = mont_mul(f, acc, acc)
        if bit == "1":
            acc = mont_mul(f, acc, a_mont)
    return acc


def mont_pow_loop(f: GFpWide, a_mont, e: int):
    """a^e (static e) in Montgomery form via a fori_loop — O(1) trace size.

    Unlike mont_pow_const, the 62 squarings don't unroll into the jaxpr
    (a 62-bit exponent inside another loop would explode compile time).
    """
    shape = jnp.shape(a_mont)[:-1]
    nbits = max(int(e).bit_length(), 1)
    bits = jnp.asarray([(int(e) >> (nbits - 1 - k)) & 1
                        for k in range(nbits)], u32)

    def body(k, acc):
        acc = mont_mul(f, acc, acc)
        hit = mont_mul(f, acc, a_mont)
        return jnp.where((bits[k] == 1)[..., None], hit, acc)

    del shape
    # the leading bit of e is always 1: start from a_mont directly
    return jax.lax.fori_loop(1, nbits, body, a_mont)


def modinv_device(f: GFpWide, a):
    """a^-1 mod p via Fermat; a standard form, 0 -> 0."""
    am = to_mont(f, a)
    return from_mont(f, mont_pow_loop(f, am, f.p - 2))


# ---------------------------------------------------------------------------
# Exact overflow-safe summation: 5 x 15-bit limbs
# ---------------------------------------------------------------------------

# numpy scalar (not a jnp constant): module import must not initialize the
# XLA backend — jax.distributed.initialize() has to run first in multi-host
_M15 = np.uint32(0x7FFF)


def limb_split(x):
    """pair (..., 2) -> (..., 5) of 15-bit limbs (value = sum limb_k 2^15k).

    lo covers bits 0..31, hi bits 32..61:
      L0 = lo[0:15], L1 = lo[15:30], L2 = lo[30:32] | hi[0:13] << 2,
      L3 = hi[13:28], L4 = hi[28:32]  (p < 2^62 -> L4 < 2^2... <= 2^4 ok)
    """
    lo, hi = x[..., 0], x[..., 1]
    l0 = lo & _M15
    l1 = (lo >> 15) & _M15
    l2 = ((lo >> 30) | (hi << 2)) & _M15
    l3 = (hi >> 13) & _M15
    l4 = hi >> 28
    return jnp.stack([l0, l1, l2, l3, l4], axis=-1)


def limb_combine(f: GFpWide, limb_sums):
    """(..., 5) uint32 limb sums -> pair (..., 2) in [0, p).

    result = sum_k limb_sum_k * 2^(15k) mod p, via Montgomery constants
    to_mont(2^15k): mont_mul(pair(limb_sum, 0), c15k) == limb_sum * 2^15k.
    """
    shape = limb_sums.shape[:-1]
    acc = pair(jnp.zeros(shape, u32), jnp.zeros(shape, u32))
    for k in range(N_LIMBS):
        term = mont_mul(f, pair(limb_sums[..., k], jnp.zeros(shape, u32)),
                        const_pair(f.c15[k], shape))
        acc = modadd(f, acc, term)
    return acc


def sum_mod(f: GFpWide, x, axis: int = 0):
    """Exact sum mod p along `axis` of a pair array; any length."""
    x = jnp.asarray(x, u32)
    axis = axis % (x.ndim - 1)  # never the limb axis
    n = x.shape[axis]
    if n == 0:
        shp = list(x.shape)
        del shp[axis]
        return jnp.zeros(shp, u32)
    if n <= LIMB_SUM_MAX:
        limbs = limb_split(x)
        return limb_combine(f, jnp.sum(limbs, axis=axis))
    chunk = LIMB_SUM_MAX
    npad = (-n) % chunk
    if npad:
        pad_width = [(0, 0)] * x.ndim
        pad_width[axis] = (0, npad)
        x = jnp.pad(x, pad_width)
    new_shape = (x.shape[:axis] + ((n + npad) // chunk, chunk)
                 + x.shape[axis + 1:])
    x = x.reshape(new_shape)
    partial = sum_mod(f, x, axis=axis + 1)
    return sum_mod(f, partial, axis=axis)


# ---------------------------------------------------------------------------
# NumPy oracle (host, exact via Python ints)
# ---------------------------------------------------------------------------

def np_matmul_mod(p: int, A, B):
    """Exact (A @ B) mod p on object-int arrays (host oracle for tests)."""
    A = np.asarray(A, dtype=object)
    B = np.asarray(B, dtype=object)
    return (A @ B) % p
