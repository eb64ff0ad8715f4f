/* Native host-side marshaling for zerochain_tpu_torch.
 *
 * The proving pipeline moves big-integer material between Python bigints
 * and the device's limb/bit tensor layouts; doing that per-bit in Python
 * costs tens of millions of interpreter ops per CRS/proof batch.  This C
 * module implements the hot converters on contiguous buffers:
 *
 *   scalars(32-byte LE) -> (n_bits, N) int32 bit planes
 *   scalars(32-byte LE) -> (n_limbs, N) int32 12-bit limb planes
 *   (n_limbs, N) int32 limb planes -> 32-byte LE scalars
 *
 * Host C, not a device kernel: built by cc and bound with ctypes; see
 * codec.py.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define LIMB_BITS 12
#define LIMB_MASK ((1 << LIMB_BITS) - 1)

/* scalars: N * 32 bytes little-endian.  out: n_bits * N int32, bit-major
 * (out[bit * N + j] = bit of scalar j). */
void scalars_to_bits(const uint8_t *scalars, int64_t n, int64_t n_bits,
                     int32_t *out) {
    for (int64_t j = 0; j < n; ++j) {
        const uint8_t *s = scalars + j * 32;
        int64_t maxb = n_bits < 256 ? n_bits : 256;
        for (int64_t b = 0; b < maxb; ++b) {
            out[b * n + j] = (s[b >> 3] >> (b & 7)) & 1;
        }
        for (int64_t b = 256; b < n_bits; ++b) {
            out[b * n + j] = 0;
        }
    }
}

/* scalars -> 12-bit limb planes: out[limb * N + j]. */
void scalars_to_limbs(const uint8_t *scalars, int64_t n, int64_t n_limbs,
                      int32_t *out) {
    for (int64_t j = 0; j < n; ++j) {
        const uint8_t *s = scalars + j * 32;
        for (int64_t l = 0; l < n_limbs; ++l) {
            int64_t bit0 = l * LIMB_BITS;
            int64_t byte0 = bit0 >> 3;
            int32_t v = 0;
            /* read up to 3 bytes covering the 12-bit window */
            for (int k = 0; k < 3; ++k) {
                if (byte0 + k < 32) {
                    v |= ((int32_t)s[byte0 + k]) << (8 * k);
                }
            }
            out[l * n + j] = (v >> (bit0 & 7)) & LIMB_MASK;
        }
    }
}

/* limb planes (n_limbs * N int32, canonical limbs < 2^12) -> 32-byte LE
 * scalars.  Limbs beyond 256 bits are ignored. */
void limbs_to_scalars(const int32_t *limbs, int64_t n, int64_t n_limbs,
                      uint8_t *out) {
    memset(out, 0, (size_t)(n * 32));
    for (int64_t j = 0; j < n; ++j) {
        uint8_t *s = out + j * 32;
        for (int64_t l = 0; l < n_limbs; ++l) {
            int64_t bit0 = l * LIMB_BITS;
            if (bit0 >= 256) break;
            uint32_t v = (uint32_t)limbs[l * n + j] & LIMB_MASK;
            int64_t byte0 = bit0 >> 3;
            int sh = (int)(bit0 & 7);
            uint32_t acc = v << sh;
            for (int k = 0; k < 3 && byte0 + k < 32; ++k) {
                s[byte0 + k] |= (uint8_t)(acc >> (8 * k));
            }
        }
    }
}

/* Montgomery-domain conversion (multiplying each scalar by R mod p) stays
 * in Python bigints; this file keeps only layout transforms. */
