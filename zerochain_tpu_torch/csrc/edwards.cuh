// Jubjub group law in extended twisted-Edwards coordinates (a = -1) over Fr,
// for the witness stage's chains (jubjub_kernels.cu).
//
// A point is 32 words: X, Y, Z, T, 8 words each, Montgomery form, with
// x = X/Z, y = Y/Z, xy = T/Z.  The formulas are those of ec/jubjub.py:
// `add` (unified, 9M, the constant 2d) and `double` (4M + 4S, the negation
// taken as 0 - x), operation for operation, so the words equal the plain
// loop's (every field result is canonical).  Both are complete on Jubjub
// (a = -1 a square, d not), so no input takes a branch.
//
// The field multiply is fp_mont_mul_inl, inlined: a chain kernel holds its
// points and temporaries in registers.  r may alias p or q: the outputs are
// written after the last read of the inputs.  Like field.cuh, this file
// also compiles as plain C++.
#pragma once
#include "field.cuh"

// 2d, Montgomery form (R = 2^256)
ZC_CONST uint32_t ZC_JJ_D2[8] = {
    0x72e9ed5fu, 0x54a448acu, 0x1b373967u, 0xa51befdbu,
    0x7b4a799eu, 0xc0d81f21u, 0xd27ecf14u, 0x3c0445feu};

constexpr int ZC_JJ_W = 8;        // words of one coordinate
constexpr int ZC_JJ_PW = 4 * 8;   // words of one extended point

ZC_HD void jj_set_identity(uint32_t* r) {  // (0 : 1 : 1 : 0)
#pragma unroll
  for (int i = 0; i < ZC_JJ_W; ++i) {
    r[i] = 0;
    r[ZC_JJ_W + i] = FrP::one(i);
    r[2 * ZC_JJ_W + i] = FrP::one(i);
    r[3 * ZC_JJ_W + i] = 0;
  }
}

// (x, y) affine -> (x : y : 1 : xy)
ZC_HD void jj_from_affine(uint32_t* r, const uint32_t* x, const uint32_t* y) {
#pragma unroll
  for (int i = 0; i < ZC_JJ_W; ++i) {
    r[i] = x[i];
    r[ZC_JJ_W + i] = y[i];
    r[2 * ZC_JJ_W + i] = FrP::one(i);
  }
  fp_mont_mul_inl<FrP>(r + 3 * ZC_JJ_W, x, y);
}

// r = p + q (ec/jubjub.py: add)
ZC_HD void jj_add(uint32_t* r, const uint32_t* p, const uint32_t* q) {
  constexpr int W = ZC_JJ_W;
  const uint32_t *X1 = p, *Y1 = p + W, *Z1 = p + 2 * W, *T1 = p + 3 * W;
  const uint32_t *X2 = q, *Y2 = q + W, *Z2 = q + 2 * W, *T2 = q + 3 * W;
  uint32_t a[W], b[W], c[W], d[W], u[W], v[W];
  fp_sub<FrP>(u, Y1, X1);
  fp_sub<FrP>(v, Y2, X2);
  fp_mont_mul_inl<FrP>(a, u, v);            // a = (Y1 - X1)(Y2 - X2)
  fp_add<FrP>(u, Y1, X1);
  fp_add<FrP>(v, Y2, X2);
  fp_mont_mul_inl<FrP>(b, u, v);            // b = (Y1 + X1)(Y2 + X2)
#pragma unroll
  for (int i = 0; i < W; ++i) u[i] = ZC_JJ_D2[i];
  fp_mont_mul_inl<FrP>(u, T1, u);
  fp_mont_mul_inl<FrP>(c, u, T2);           // c = T1 * 2d * T2
  fp_mont_mul_inl<FrP>(u, Z1, Z2);
  fp_add<FrP>(d, u, u);                     // d = 2 Z1 Z2
  fp_sub<FrP>(u, b, a);                     // e
  fp_sub<FrP>(v, d, c);                     // f
  fp_add<FrP>(d, d, c);                     // g
  fp_add<FrP>(b, b, a);                     // h
  fp_mont_mul_inl<FrP>(r, u, v);            // X3 = e f
  fp_mont_mul_inl<FrP>(r + W, d, b);        // Y3 = g h
  fp_mont_mul_inl<FrP>(r + 2 * W, v, d);    // Z3 = f g
  fp_mont_mul_inl<FrP>(r + 3 * W, u, b);    // T3 = e h
}

// r = 2p (ec/jubjub.py: double; T of p is not read)
ZC_HD void jj_double(uint32_t* r, const uint32_t* p) {
  constexpr int W = ZC_JJ_W;
  const uint32_t *X1 = p, *Y1 = p + W, *Z1 = p + 2 * W;
  uint32_t a[W], b[W], c[W], e[W], u[W];
  fp_mont_mul_inl<FrP>(a, X1, X1);
  fp_mont_mul_inl<FrP>(b, Y1, Y1);
  fp_mont_mul_inl<FrP>(u, Z1, Z1);
  fp_add<FrP>(c, u, u);                     // c = 2 Z1^2
  fp_add<FrP>(u, X1, Y1);
  fp_mont_mul_inl<FrP>(e, u, u);
  fp_sub<FrP>(e, e, a);
  fp_sub<FrP>(e, e, b);                     // e = (X1 + Y1)^2 - a - b
  fp_add<FrP>(u, a, b);
  fp_sub<FrP>(a, b, a);                     // g = b - a
  fp_sub<FrP>(c, a, c);                     // f = g - c
#pragma unroll
  for (int i = 0; i < W; ++i) b[i] = 0;
  fp_sub<FrP>(b, b, u);                     // h = 0 - (a + b)
  fp_mont_mul_inl<FrP>(r, e, c);            // X3 = e f
  fp_mont_mul_inl<FrP>(r + W, a, b);        // Y3 = g h
  fp_mont_mul_inl<FrP>(r + 2 * W, c, a);    // Z3 = f g
  fp_mont_mul_inl<FrP>(r + 3 * W, e, b);    // T3 = e h
}
