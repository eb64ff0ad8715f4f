// Coordinate fields of the two curve groups, behind one interface:
// FqE (G1: one Fq element, 12 words) and Fq2E (G2: c0 + c1*u with u^2 = -1,
// 24 words, c0 first).  Every function may be called with r aliasing an
// input.  Fq2 multiplies by 3-multiply Karatsuba with full reductions, so
// all results are canonical and independent of how they were computed.
#pragma once
#include "field.cuh"

struct FqE {
  static constexpr int W = 12;
  ZC_HD static void mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    fp_mont_mul<FqP>(r, a, b);
  }
  ZC_HD static void sqr(uint32_t* r, const uint32_t* a) { fp_mont_mul<FqP>(r, a, a); }
  ZC_HD static void add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    fp_add<FqP>(r, a, b);
  }
  ZC_HD static void sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    fp_sub<FqP>(r, a, b);
  }
  ZC_HD static bool is_zero(const uint32_t* a) { return fp_is_zero<FqP>(a); }
  ZC_HD static void set_zero(uint32_t* r) {
    for (int i = 0; i < W; ++i) r[i] = 0;
  }
  ZC_HD static void set_one(uint32_t* r) {
    for (int i = 0; i < W; ++i) r[i] = FqP::one(i);
  }
  ZC_HD static void neg(uint32_t* r, const uint32_t* a) {
    uint32_t z[W];
    set_zero(z);
    fp_sub<FqP>(r, z, a);
  }
};

struct Fq2E {
  static constexpr int W = 24;
  static constexpr int H = 12;
  ZC_HD static void mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    uint32_t aa[H], bb[H], sa[H], sb[H], o[H];
    fp_mont_mul<FqP>(aa, a, b);
    fp_mont_mul<FqP>(bb, a + H, b + H);
    fp_add<FqP>(sa, a, a + H);
    fp_add<FqP>(sb, b, b + H);
    fp_mont_mul<FqP>(o, sa, sb);
    fp_sub<FqP>(r, aa, bb);
    fp_add<FqP>(sa, aa, bb);
    fp_sub<FqP>(r + H, o, sa);
  }
  ZC_HD static void sqr(uint32_t* r, const uint32_t* a) {
    uint32_t ab[H], s[H], d[H];
    fp_mont_mul<FqP>(ab, a, a + H);
    fp_add<FqP>(s, a, a + H);
    fp_sub<FqP>(d, a, a + H);
    fp_mont_mul<FqP>(r, s, d);
    fp_add<FqP>(r + H, ab, ab);
  }
  ZC_HD static void add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    fp_add<FqP>(r, a, b);
    fp_add<FqP>(r + H, a + H, b + H);
  }
  ZC_HD static void sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    fp_sub<FqP>(r, a, b);
    fp_sub<FqP>(r + H, a + H, b + H);
  }
  ZC_HD static bool is_zero(const uint32_t* a) {
    return fp_is_zero<FqP>(a) && fp_is_zero<FqP>(a + H);
  }
  ZC_HD static void set_zero(uint32_t* r) {
    for (int i = 0; i < W; ++i) r[i] = 0;
  }
  ZC_HD static void set_one(uint32_t* r) {
    for (int i = 0; i < H; ++i) { r[i] = FqP::one(i); r[H + i] = 0; }
  }
  ZC_HD static void neg(uint32_t* r, const uint32_t* a) {
    uint32_t z[W];
    set_zero(z);
    sub(r, z, a);
  }
};
