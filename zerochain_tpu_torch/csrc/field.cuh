// Prime-field arithmetic on 32-bit words for the three fields of the prover:
// Fq (BLS12-381 base field, 12 words, R = 2^384), Fr (its scalar field,
// 8 words, R = 2^256) and Fs (Jubjub's scalar field, 8 words, R = 2^256).
//
// Shared by every kernel source.  An element is N words, least significant
// first, Montgomery domain where the function name says so.  Two interfaces:
//
//   - the word-array functions (fp_mont_mul_inl, fp_add, fp_sub, ...), which
//     take and return canonical words in [0, p); every one of them returns
//     canonical words, so any two correct implementations agree bit for bit.
//     The field kernels, the Jubjub chains and the staged group programs use
//     them;
//   - the Fq value type (struct Fq) with LAZY reduction, for the curve
//     formulas of jacobian.cuh: a value lies in [0, 2p), not necessarily
//     canonical.  p < 2^381, so 4p < R = 2^384, and a Montgomery product of
//     two values below 2p is below (4p^2 + R p) / R < 2p: the multiply needs
//     no final subtraction, an add or a subtract one conditional step of 2p.
//     fq_canon makes a value canonical; fq_is_zero tests the class (0 or p).
//     A caller canonicalises before it stores or exchanges a value, so every
//     word that leaves a thread is canonical.  Fr and Fs keep the full
//     reduction of the word-array functions.
//
// The Fq multiply is CIOS on 32-bit carry chains: per word of b, the low
// and the high halves of a * b_i are added in two chains of multiply-add
// with carry (mad.lo.cc / madc.lo.cc, mad.hi.cc / madc.hi.cc), then the same
// for m * p with m = t_0 * (-1/p) mod 2^32, and the running sum moves down
// one word: 4N + 3 instructions a word of b, where 64-bit intermediates cost
// 3-4 instructions a word product.  The running sum fits N + 1 words
// (inputs below 2p, p < R/8).  Fq's add, subtract and reduction run on
// add.cc / sub.cc chains too.  Each chain instruction is one PTX
// instruction in its own asm statement (asm volatile keeps their order, and
// the carry flag is only ever written by the chain that reads it next).  Fr
// and Fs keep CIOS on 64-bit intermediates: their users are the Jubjub
// chains, a thread's serial chain of multiplies, whose latency the single
// carry flag lengthened (PERF.md).
//
// The whole file also compiles as plain C++ (ZC_HD falls away), with each
// chain instruction emulated on a carry flag in a variable: the host build
// runs the same instruction sequence, which is how the arithmetic is checked
// on a machine without the CUDA toolkit.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define ZC_HD __device__ __forceinline__
#define ZC_HOST_HD __host__ __device__ inline
#define ZC_NOINLINE __device__ __noinline__
#define ZC_CONST __device__ __constant__
#else
#define ZC_HD inline
#define ZC_HOST_HD inline
#define ZC_NOINLINE inline
#define ZC_CONST static const
#endif

ZC_CONST uint32_t ZC_FQ_P[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
ZC_CONST uint32_t ZC_FQ_2P[12] = {
    0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu, 0xed61ec48u, 0xce61a541u,
    0xe70a257eu, 0xc8ee9709u, 0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u};
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

// ------------------------------------------------------------ carry chains
// add/sub/mad with the carry flag: .cc writes it, c (after the op) reads it.
// After sub.cc / subc.cc the flag is the borrow.
#ifdef __CUDA_ARCH__
#define ZC_ASM2(name, op)                                                  \
  ZC_HD uint32_t name(uint32_t a, uint32_t b) {                            \
    uint32_t r;                                                            \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));            \
    return r;                                                              \
  }
#define ZC_ASM3(name, op)                                                  \
  ZC_HD uint32_t name(uint32_t a, uint32_t b, uint32_t c) {                \
    uint32_t r;                                                            \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                              \
  }
ZC_ASM2(zc_add_cc, "add.cc.u32")
ZC_ASM2(zc_addc_cc, "addc.cc.u32")
ZC_ASM2(zc_addc, "addc.u32")
ZC_ASM2(zc_sub_cc, "sub.cc.u32")
ZC_ASM2(zc_subc_cc, "subc.cc.u32")
ZC_ASM2(zc_subc, "subc.u32")
ZC_ASM3(zc_mad_lo_cc, "mad.lo.cc.u32")
ZC_ASM3(zc_madc_lo_cc, "madc.lo.cc.u32")
ZC_ASM3(zc_mad_hi_cc, "mad.hi.cc.u32")
ZC_ASM3(zc_madc_hi_cc, "madc.hi.cc.u32")
ZC_ASM3(zc_madc_hi, "madc.hi.u32")
#undef ZC_ASM2
#undef ZC_ASM3
#else
inline uint32_t& zc_cf() {  // the emulated carry flag
  static uint32_t cf = 0;
  return cf;
}
inline uint32_t zc_set(uint64_t s) { zc_cf() = (uint32_t)(s >> 32) & 1u; return (uint32_t)s; }
inline uint32_t zc_add_cc(uint32_t a, uint32_t b) { return zc_set((uint64_t)a + b); }
inline uint32_t zc_addc_cc(uint32_t a, uint32_t b) { return zc_set((uint64_t)a + b + zc_cf()); }
inline uint32_t zc_addc(uint32_t a, uint32_t b) { return a + b + zc_cf(); }
inline uint32_t zc_sub_cc(uint32_t a, uint32_t b) { return zc_set((uint64_t)a - b); }
inline uint32_t zc_subc_cc(uint32_t a, uint32_t b) { return zc_set((uint64_t)a - b - zc_cf()); }
inline uint32_t zc_subc(uint32_t a, uint32_t b) { return a - b - zc_cf(); }
inline uint32_t zc_mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return zc_set((uint64_t)(uint32_t)(a * b) + c);
}
inline uint32_t zc_madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return zc_set((uint64_t)(uint32_t)(a * b) + c + zc_cf());
}
inline uint32_t zc_mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return zc_set((((uint64_t)a * b) >> 32) + c);
}
inline uint32_t zc_madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return zc_set((((uint64_t)a * b) >> 32) + c + zc_cf());
}
inline uint32_t zc_madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return (uint32_t)(((uint64_t)a * b) >> 32) + c + zc_cf();
}
#endif

// t = a * b / R for Fq, below 2p for inputs below 2p (the running sum
// fits 13 words, p < R/8); not reduced further.  t may alias a or b.
ZC_HD void fq_cios(uint32_t* t_out, const uint32_t* a, const uint32_t* b) {
  constexpr int N = 12;
  uint32_t t[N + 1];
#pragma unroll
  for (int j = 0; j <= N; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = b[i];
    t[0] = zc_mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = zc_madc_lo_cc(a[j], bi, t[j]);
    t[N] = zc_addc(t[N], 0);
    t[1] = zc_mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j) t[j + 1] = zc_madc_hi_cc(a[j], bi, t[j + 1]);
    t[N] = zc_madc_hi(a[N - 1], bi, t[N]);
    const uint32_t m = t[0] * FqP::INV;
    t[0] = zc_mad_lo_cc(m, FqP::p(0), t[0]);  // 0
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = zc_madc_lo_cc(m, FqP::p(j), t[j]);
    t[N] = zc_addc(t[N], 0);
    t[1] = zc_mad_hi_cc(m, FqP::p(0), t[1]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j) t[j + 1] = zc_madc_hi_cc(m, FqP::p(j), t[j + 1]);
    t[N] = zc_madc_hi(m, FqP::p(N - 1), t[N]);
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] = t[j + 1];
    t[N] = 0;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) t_out[j] = t[j];
}

// r = a - m if a >= m else a, for the modulus words m(i) (a < 2m).
// The borrow of a - m, as a mask, picks a.
template <int N, class M>
ZC_HD void zc_cond_sub(uint32_t* r, const uint32_t* a, M m) {
  uint32_t d[N];
  d[0] = zc_sub_cc(a[0], m(0));
#pragma unroll
  for (int i = 1; i < N; ++i) d[i] = zc_subc_cc(a[i], m(i));
  const uint32_t keep = zc_subc(0, 0);  // all ones if a < m
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = (a[i] & keep) | (d[i] & ~keep);
}

// r = a + b - m if that is >= 0 else a + b, with a + b < 2^(32N).
template <int N, class M>
ZC_HD void zc_add_mod(uint32_t* r, const uint32_t* a, const uint32_t* b, M m) {
  uint32_t s[N];
  s[0] = zc_add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) s[i] = zc_addc_cc(a[i], b[i]);
  zc_cond_sub<N>(r, s, m);
}

// r = a - b, plus m if that is negative.
template <int N, class M>
ZC_HD void zc_sub_mod(uint32_t* r, const uint32_t* a, const uint32_t* b, M m) {
  uint32_t d[N];
  d[0] = zc_sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) d[i] = zc_subc_cc(a[i], b[i]);
  const uint32_t neg = zc_subc(0, 0);  // all ones if a < b
  r[0] = zc_add_cc(d[0], m(0) & neg);
#pragma unroll
  for (int i = 1; i < N; ++i) r[i] = zc_addc_cc(d[i], m(i) & neg);
}

struct ZcFqP {
  ZC_HD uint32_t operator()(int i) const { return ZC_FQ_P[i]; }
};
struct ZcFq2P {
  ZC_HD uint32_t operator()(int i) const { return ZC_FQ_2P[i]; }
};

// ------------------------------------------- word arrays, canonical [0, p)
// Fr and Fs: 64-bit intermediates.  Fq (specialised below): carry chains.

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

// r = a * b / R mod p (CIOS on 64-bit intermediates).  r may alias a or b.
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

template <>
ZC_HD void fp_cond_sub_p<FqP>(uint32_t* r, const uint32_t* a) {
  zc_cond_sub<12>(r, a, ZcFqP());
}

template <>
ZC_HD void fp_add<FqP>(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  zc_add_mod<12>(r, a, b, ZcFqP());  // a + b < 2p < R: no carry out
}

template <>
ZC_HD void fp_sub<FqP>(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  zc_sub_mod<12>(r, a, b, ZcFqP());
}

template <>
ZC_HD void fp_mont_mul_inl<FqP>(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[12];
  fq_cios(t, a, b);
  fp_cond_sub_p<FqP>(r, t);
}

// ------------------------------------------------ Fq values, lazy [0, 2p)

struct Fq {
  uint32_t w[12];
};

ZC_HD Fq fq_zero() {
  Fq r;
#pragma unroll
  for (int i = 0; i < 12; ++i) r.w[i] = 0;
  return r;
}

ZC_HD Fq fq_one() {
  Fq r;
#pragma unroll
  for (int i = 0; i < 12; ++i) r.w[i] = FqP::one(i);
  return r;
}

// The curve formulas' multiply: one out-of-line instance an image, whose
// operands and result pass in registers (a value, not a pointer: nothing of
// the caller goes to local memory, and ptxas gives it a 0-byte frame).
ZC_NOINLINE Fq fq_mul(Fq a, Fq b) {
  Fq r;
  fq_cios(r.w, a.w, b.w);
  return r;
}

ZC_HD Fq fq_add(const Fq& a, const Fq& b) {  // a + b < 4p < R
  Fq r;
  zc_add_mod<12>(r.w, a.w, b.w, ZcFq2P());
  return r;
}

ZC_HD Fq fq_sub(const Fq& a, const Fq& b) {
  Fq r;
  zc_sub_mod<12>(r.w, a.w, b.w, ZcFq2P());
  return r;
}

ZC_HD Fq fq_neg(const Fq& a) { return fq_sub(fq_zero(), a); }

ZC_HD Fq fq_canon(const Fq& a) {
  Fq r;
  fp_cond_sub_p<FqP>(r.w, a.w);
  return r;
}

// a = 0 mod p, for a in [0, 2p): a is 0 or p.
ZC_HD bool fq_is_zero(const Fq& a) {
  uint32_t z = 0, e = 0;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    z |= a.w[i];
    e |= a.w[i] ^ FqP::p(i);
  }
  return z == 0 || e == 0;
}
