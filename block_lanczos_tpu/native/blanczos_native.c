/*
 * Native host-side helpers for block_lanczos_tpu (loaded via ctypes).
 *
 * The device compute path is JAX/XLA; this C library covers the
 * host-side runtime the reference implements in C: fast MatrixMarket triplet
 * parsing (reference: sequential/lanczos_modp.c:199-263), the xoshiro256+
 * PRNG used for the deterministic initial block (reference:
 * sequential/lanczos_modp.c:67-87, :624-625), and COO->CSR conversion
 * (counting sort by row).  Everything here has a pure-NumPy fallback in
 * Python; this library is a performance fast path, not a requirement.
 *
 * Build: cc -O3 -shared -fPIC -o libblanczos_native.so blanczos_native.c
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

typedef uint64_t u64;
typedef uint32_t u32;
typedef int32_t i32;
typedef int64_t i64;

/* ------------------------- xoshiro256+ ---------------------------------- */

static inline u64 rotl(u64 x, int k) { return (x << k) | (x >> (64 - k)); }

/* Advance the generator `count` times, writing random64() % prime each step.
 * State is updated in place so successive calls continue the stream,
 * matching the reference's single global generator. */
void xoshiro_fill_mod(u64 *s, u64 prime, u32 *out, i64 count)
{
    for (i64 n = 0; n < count; n++) {
        u64 result = rotl(s[0] + s[3], 23) + s[0];
        u64 t = s[1] << 17;
        s[2] ^= s[0];
        s[3] ^= s[1];
        s[1] ^= s[2];
        s[0] ^= s[3];
        s[2] ^= t;
        s[3] = rotl(s[3], 45);
        out[n] = (u32)(result % prime);
    }
}

/* Wide-prime (p < 2^62) variant: full 64-bit residues. */
void xoshiro_fill_mod64(u64 *s, u64 prime, u64 *out, i64 count)
{
    for (i64 n = 0; n < count; n++) {
        u64 result = rotl(s[0] + s[3], 23) + s[0];
        u64 t = s[1] << 17;
        s[2] ^= s[0];
        s[3] ^= s[1];
        s[1] ^= s[2];
        s[0] ^= s[3];
        s[2] ^= t;
        s[3] = rotl(s[3], 45);
        out[n] = result % prime;
    }
}

/* ------------------------- triplet parsing ------------------------------ */

/* Parse `nnz` whitespace-separated "i j x" integer triplets from buf.
 * Writes 0-based row/col indices and the coefficient reduced mod prime.
 * A negative x is first cast to uint32 (two's complement) and then reduced,
 * reproducing the reference's fscanf("%d", (u32*)&x); x % prime semantics.
 * Returns the number of triplets parsed (== nnz on success). */
i64 parse_triplets_mod(const char *buf, i64 len, i64 nnz,
                       i32 *mi, i32 *mj, u32 *mx, u64 prime)
{
    const char *ptr = buf;
    const char *end = buf + len;
    for (i64 u = 0; u < nnz; u++) {
        i64 vals[3];
        for (int k = 0; k < 3; k++) {
            while (ptr < end && (*ptr == ' ' || *ptr == '\t' ||
                                 *ptr == '\n' || *ptr == '\r'))
                ptr++;
            if (ptr >= end)
                return u;
            int neg = 0;
            if (*ptr == '+') ptr++;
            else if (*ptr == '-') { neg = 1; ptr++; }
            i64 v = 0;
            int digits = 0;
            while (ptr < end && *ptr >= '0' && *ptr <= '9') {
                v = v * 10 + (*ptr - '0');
                ptr++;
                digits++;
            }
            if (!digits)
                return u;
            vals[k] = neg ? -v : v;
        }
        /* ids must survive the i32 narrowing un-wrapped; exact range checks
         * against nrows/ncols happen in Python (_validate_indices) */
        if (vals[0] < 1 || vals[0] > 0x7FFFFFFFLL ||
            vals[1] < 1 || vals[1] > 0x7FFFFFFFLL)
            return u;
        mi[u] = (i32)(vals[0] - 1);  /* MatrixMarket is 1-based */
        mj[u] = (i32)(vals[1] - 1);
        mx[u] = (u32)(((u64)(u32)vals[2]) % prime);
    }
    return nnz;
}

/* ------------------------- COO -> CSR (counting sort) ------------------- */

/* Stable counting sort of COO triplets by row.  rowptr has nrows+1 entries.
 * Outputs (cols, vals) permuted row-major; within a row the original file
 * order is preserved (stability matters only for reproducible layouts). */
void coo_to_csr(i64 nnz, i32 nrows,
                const i32 *mi, const i32 *mj, const u32 *mx,
                i64 *rowptr, i32 *cols, u32 *vals)
{
    memset(rowptr, 0, (size_t)(nrows + 1) * sizeof(i64));
    for (i64 k = 0; k < nnz; k++)
        rowptr[mi[k] + 1]++;
    for (i32 r = 0; r < nrows; r++)
        rowptr[r + 1] += rowptr[r];
    /* temp cursor array: reuse a scan over rowptr copy */
    for (i64 k = 0; k < nnz; k++) {
        i64 dst = rowptr[mi[k]]++;
        cols[dst] = mj[k];
        vals[dst] = mx[k];
    }
    /* restore rowptr (shift back) */
    for (i32 r = nrows; r > 0; r--)
        rowptr[r] = rowptr[r - 1];
    rowptr[0] = 0;
}

/* ------------------------- fast integer writer -------------------------- */

/* Format `count` uint64 values, one per line, into `out` (caller allocates
 * >= count * 21 bytes).  Returns the number of bytes written.  ~6x faster
 * than np.savetxt for large kernel blocks (the reference writes its output
 * with an fprintf loop: sequential/lanczos_modp.c:673-686). */
i64 format_u64_lines(const u64 *vals, i64 count, char *out)
{
    char *p = out;
    for (i64 k = 0; k < count; k++) {
        u64 v = vals[k];
        char buf[20];
        int len = 0;
        do {
            buf[len++] = (char)('0' + (v % 10));
            v /= 10;
        } while (v);
        while (len)
            *p++ = buf[--len];
        *p++ = '\n';
    }
    return (i64)(p - out);
}

/* Wide-prime (p < 2^62) parser: coefficients reduced mod p as full 64-bit
 * residues (mathematical v mod p for negatives, matching the Python path). */
i64 parse_triplets_mod64(const char *buf, i64 len, i64 nnz,
                         i32 *mi, i32 *mj, u64 *mx, u64 prime)
{
    const char *ptr = buf;
    const char *end = buf + len;
    for (i64 u = 0; u < nnz; u++) {
        i64 vals[3];
        for (int k = 0; k < 3; k++) {
            while (ptr < end && (*ptr == ' ' || *ptr == '\t' ||
                                 *ptr == '\n' || *ptr == '\r'))
                ptr++;
            if (ptr >= end)
                return u;
            int neg = 0;
            if (*ptr == '+') ptr++;
            else if (*ptr == '-') { neg = 1; ptr++; }
            i64 v = 0;
            int digits = 0;
            while (ptr < end && *ptr >= '0' && *ptr <= '9') {
                v = v * 10 + (*ptr - '0');
                ptr++;
                digits++;
            }
            if (!digits)
                return u;
            vals[k] = neg ? -v : v;
        }
        if (vals[0] < 1 || vals[0] > 0x7FFFFFFFLL ||
            vals[1] < 1 || vals[1] > 0x7FFFFFFFLL)
            return u;
        mi[u] = (i32)(vals[0] - 1);
        mj[u] = (i32)(vals[1] - 1);
        i64 r = vals[2] % (i64)prime;   /* C: sign follows dividend */
        if (r < 0)
            r += (i64)prime;
        mx[u] = (u64)r;
    }
    return nnz;
}
