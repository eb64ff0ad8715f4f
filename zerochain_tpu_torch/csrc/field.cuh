// Prime-field arithmetic on 32-bit words for the three fields of the prover:
// Fq (BLS12-381 base field, 12 words, R = 2^384), Fr (its scalar field,
// 8 words, R = 2^256) and Fs (Jubjub's scalar field, 8 words, R = 2^256).
//
// Shared by ff_kernels.cu, ec_kernels.cu and totals_kernel.cu.  An element
// is N words, least significant first, canonical in [0, p), Montgomery domain
// where the function name says so.  Every function returns canonical words,
// so any two correct implementations agree bit for bit.
//
// The multiply is word-serial CIOS with 64-bit intermediates: the 32x32->64
// multiply-add is the card's native wide integer instruction (IMAD.WIDE), and
// (2^32-1)^2 + 2(2^32-1) = 2^64-1 shows that a product plus two words never
// overflows.  p < R/2 holds for all three fields, so the CIOS result is below
// 2p and one conditional subtraction makes it canonical.
//
// The file also compiles as plain C++ (the ZC_HD macro falls away), which is
// how the arithmetic is checked on a machine without the CUDA toolkit.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define ZC_HD __device__ __forceinline__
#define ZC_NOINLINE __device__ __noinline__
#define ZC_CONST __device__ __constant__
#else
#define ZC_HD inline
#define ZC_NOINLINE inline
#define ZC_CONST static const
#endif

ZC_CONST uint32_t ZC_FQ_P[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
ZC_CONST uint32_t ZC_FQ_ONE[12] = {  // R mod p
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
ZC_CONST uint32_t ZC_FR_P[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u, 0x3339d808u,
    0x299d7d48u, 0x73eda753u};
ZC_CONST uint32_t ZC_FR_ONE[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau, 0xecbc4ff5u, 0x998c4fefu,
    0xacc5056fu, 0x1824b159u};
ZC_CONST uint32_t ZC_FS_P[8] = {
    0xd6f72cb7u, 0xd0970e5eu, 0xccc81082u, 0xa6682093u, 0x01343b00u, 0x06673b01u,
    0x6533afa9u, 0x0e7db4eau};
ZC_CONST uint32_t ZC_FS_ONE[8] = {
    0xb99607d9u, 0x25f80bb3u, 0x66b6e750u, 0xf315d62fu, 0xeb8814f4u, 0x932514eeu,
    0x479155c6u, 0x09a6fc6fu};

struct FqP {
  static constexpr int N = 12;
  static constexpr uint32_t INV = 0xfffcfffdu;  // -1/p mod 2^32
  ZC_HD static uint32_t p(int i) { return ZC_FQ_P[i]; }
  ZC_HD static uint32_t one(int i) { return ZC_FQ_ONE[i]; }
};
struct FrP {
  static constexpr int N = 8;
  static constexpr uint32_t INV = 0xffffffffu;
  ZC_HD static uint32_t p(int i) { return ZC_FR_P[i]; }
  ZC_HD static uint32_t one(int i) { return ZC_FR_ONE[i]; }
};
struct FsP {
  static constexpr int N = 8;
  static constexpr uint32_t INV = 0xef788ef9u;
  ZC_HD static uint32_t p(int i) { return ZC_FS_P[i]; }
  ZC_HD static uint32_t one(int i) { return ZC_FS_ONE[i]; }
};

// r = a - p if a >= p else a   (a < 2p < R)
template <class F>
ZC_HD void fp_cond_sub_p(uint32_t* r, const uint32_t* a) {
  uint32_t d[F::N];
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < F::N; ++i) {
    int64_t s = (int64_t)a[i] - (int64_t)F::p(i) + borrow;
    d[i] = (uint32_t)s;
    borrow = s >> 32;  // 0 or -1
  }
#pragma unroll
  for (int i = 0; i < F::N; ++i) r[i] = borrow ? a[i] : d[i];
}

template <class F>
ZC_HD void fp_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[F::N];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < F::N; ++i) {
    uint64_t s = (uint64_t)a[i] + b[i] + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  fp_cond_sub_p<F>(r, t);  // a + b < 2p < R: no carry out
}

template <class F>
ZC_HD void fp_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t d[F::N];
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < F::N; ++i) {
    int64_t s = (int64_t)a[i] - (int64_t)b[i] + borrow;
    d[i] = (uint32_t)s;
    borrow = s >> 32;
  }
  uint64_t c = 0;
  const uint32_t mask = borrow ? 0xffffffffu : 0u;  // add p back if negative
#pragma unroll
  for (int i = 0; i < F::N; ++i) {
    uint64_t s = (uint64_t)d[i] + (F::p(i) & mask) + c;
    r[i] = (uint32_t)s;
    c = s >> 32;
  }
}

template <class F>
ZC_HD bool fp_is_zero(const uint32_t* a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < F::N; ++i) acc |= a[i];
  return acc == 0;
}

// r = a * b / R mod p (CIOS).  r may alias a or b.
template <class F>
ZC_HD void fp_mont_mul_inl(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
    const uint32_t bi = b[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * bi + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::INV;
    s = (uint64_t)m * F::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * F::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  fp_cond_sub_p<F>(r, t);
}

// Out-of-line copy for the curve kernels: one instance per field keeps their
// code size and compile time down (a formula inlines ~16 multiplies).
template <class F>
ZC_NOINLINE void fp_mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t x[F::N], y[F::N], z[F::N];
#pragma unroll
  for (int i = 0; i < F::N; ++i) { x[i] = a[i]; y[i] = b[i]; }
  fp_mont_mul_inl<F>(z, x, y);
#pragma unroll
  for (int i = 0; i < F::N; ++i) r[i] = z[i];
}
