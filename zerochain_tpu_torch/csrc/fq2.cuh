// Coordinate fields of the two curve groups, as values behind one interface:
// FqE (G1: one Fq, 12 words) and Fq2E (G2: c0 + c1*u with u^2 = -1, 24
// words, c0 first).  Values are lazy, in [0, 2p) a component (field.cuh);
// canon makes them canonical and is_zero tests the class.  Fq2 multiplies by
// 3-multiply Karatsuba and squares with 2 multiplies, each an out-of-line
// fq_mul on values.  word(v, c, w) is word w of component c, for the loads
// and stores of jacobian.cuh (compile-time c and w keep v in registers).
#pragma once
#include "field.cuh"

struct Fq2 {
  Fq c0, c1;
};

struct FqE {
  static constexpr int W = 12;  // words of one coordinate
  using V = Fq;
  ZC_HD static V zero() { return fq_zero(); }
  ZC_HD static V one() { return fq_one(); }
  ZC_HD static V mul(const V& a, const V& b) { return fq_mul(a, b); }
  ZC_HD static V sqr(const V& a) { return fq_mul(a, a); }
  ZC_HD static V add(const V& a, const V& b) { return fq_add(a, b); }
  ZC_HD static V sub(const V& a, const V& b) { return fq_sub(a, b); }
  ZC_HD static V neg(const V& a) { return fq_neg(a); }
  ZC_HD static V canon(const V& a) { return fq_canon(a); }
  ZC_HD static bool is_zero(const V& a) { return fq_is_zero(a); }
  ZC_HD static uint32_t& word(V& v, int, int w) { return v.w[w]; }
  ZC_HD static uint32_t word(const V& v, int, int w) { return v.w[w]; }
};

struct Fq2E {
  static constexpr int W = 24;
  using V = Fq2;
  ZC_HD static V zero() { return {fq_zero(), fq_zero()}; }
  ZC_HD static V one() { return {fq_one(), fq_zero()}; }
  ZC_HD static V mul(const V& a, const V& b) {
    const Fq aa = fq_mul(a.c0, b.c0), bb = fq_mul(a.c1, b.c1);
    const Fq o = fq_mul(fq_add(a.c0, a.c1), fq_add(b.c0, b.c1));
    return {fq_sub(aa, bb), fq_sub(o, fq_add(aa, bb))};
  }
  ZC_HD static V sqr(const V& a) {
    const Fq ab = fq_mul(a.c0, a.c1);
    return {fq_mul(fq_add(a.c0, a.c1), fq_sub(a.c0, a.c1)), fq_add(ab, ab)};
  }
  ZC_HD static V add(const V& a, const V& b) { return {fq_add(a.c0, b.c0), fq_add(a.c1, b.c1)}; }
  ZC_HD static V sub(const V& a, const V& b) { return {fq_sub(a.c0, b.c0), fq_sub(a.c1, b.c1)}; }
  ZC_HD static V neg(const V& a) { return {fq_neg(a.c0), fq_neg(a.c1)}; }
  ZC_HD static V canon(const V& a) { return {fq_canon(a.c0), fq_canon(a.c1)}; }
  ZC_HD static bool is_zero(const V& a) { return fq_is_zero(a.c0) && fq_is_zero(a.c1); }
  ZC_HD static uint32_t& word(V& v, int c, int w) { return c ? v.c1.w[w] : v.c0.w[w]; }
  ZC_HD static uint32_t word(const V& v, int c, int w) { return c ? v.c1.w[w] : v.c0.w[w]; }
};
