// The Fermat inverse a^(p-2) of one element, one thread, for Fq, Fr and Fs:
// MSB-first square-and-multiply with the exponent in constant memory (every
// thread reads the same bit: no divergence) and the element in registers,
// 254 squarings and 163 multiplies for Fr, 380 and 228 for Fq.  Zero maps to
// zero.  The inverse is unique and canonical, so the words equal any other
// correct inverse's.  Used by zc_ff_inv (ff_kernels.cu) and by the witness
// gadgets' batched inversions (witness_kernel.cu); builds as plain C++.
#pragma once
#include "field.cuh"

// p - 2 of each field, least significant word first
ZC_CONST uint32_t ZC_FQ_PM2[12] = {
    0xffffaaa9u, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
ZC_CONST uint32_t ZC_FR_PM2[8] = {
    0xffffffffu, 0xfffffffeu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u, 0x3339d808u,
    0x299d7d48u, 0x73eda753u};
ZC_CONST uint32_t ZC_FS_PM2[8] = {
    0xd6f72cb5u, 0xd0970e5eu, 0xccc81082u, 0xa6682093u, 0x01343b00u, 0x06673b01u,
    0x6533afa9u, 0x0e7db4eau};

// The Fermat exponent of F: its bit length and words.
template <class F> struct FermatExp;
template <> struct FermatExp<FqP> {
  static constexpr int BITS = 381;
  ZC_HD static uint32_t word(int i) { return ZC_FQ_PM2[i]; }
};
template <> struct FermatExp<FrP> {
  static constexpr int BITS = 255;
  ZC_HD static uint32_t word(int i) { return ZC_FR_PM2[i]; }
};
template <> struct FermatExp<FsP> {
  static constexpr int BITS = 252;
  ZC_HD static uint32_t word(int i) { return ZC_FS_PM2[i]; }
};

// r = a^(p-2) in the Montgomery domain: a^-1 for a != 0, 0 for a = 0.
template <class F>
ZC_HD void fp_inv_fermat(uint32_t* r, const uint32_t* a) {
  uint32_t x[F::N], acc[F::N];
#pragma unroll
  for (int i = 0; i < F::N; ++i) x[i] = acc[i] = a[i];  // the leading 1
#pragma unroll 1
  for (int b = FermatExp<F>::BITS - 2; b >= 0; --b) {
    fp_mont_mul_inl<F>(acc, acc, acc);
    if ((FermatExp<F>::word(b >> 5) >> (b & 31)) & 1u) fp_mont_mul_inl<F>(acc, acc, x);
  }
#pragma unroll
  for (int i = 0; i < F::N; ++i) r[i] = acc[i];
}
