// Short-Weierstrass group law in Jacobian coordinates (y^2 = x^3 + b),
// generic over the coordinate field E (FqE for G1, Fq2E for G2).
//
// A point is 3*E::W words: X, Y, Z; infinity <=> Z == 0.  The formulas and
// their degenerate-case handling are those of the fused TPU kernels
// (zerochain_tpu/ec/pallas_ec.py: _double_planes, _add_planes, _madd_planes):
// dbl-2009-l, add-2007-bl and its Z2 in {0, 1} specialisation, with
//   P = inf -> Q;  Q = inf -> P;  P = Q -> double(P);  P = -Q -> (1, 1, 0).
// The TPU kernels compute every case and select by mask; a thread here
// branches, which gives the same words because every field result is
// canonical.  r may alias p or q.
#pragma once
#include "fq2.cuh"

template <class E>
ZC_HD void jac_copy(uint32_t* r, const uint32_t* p) {
  for (int i = 0; i < 3 * E::W; ++i) r[i] = p[i];
}

template <class E>
ZC_HD void jac_set_identity(uint32_t* r) {
  E::set_one(r);
  E::set_one(r + E::W);
  E::set_zero(r + 2 * E::W);
}

template <class E>
ZC_HD bool jac_is_identity(const uint32_t* p) { return E::is_zero(p + 2 * E::W); }

template <class E>
ZC_NOINLINE void jac_double(uint32_t* r, const uint32_t* p) {
  constexpr int W = E::W;
  const uint32_t *X = p, *Y = p + W, *Z = p + 2 * W;
  uint32_t a[W], b[W], c[W], t[W], d[W], e[W], f[W], x3[W], y3[W], z3[W];
  E::sqr(a, X);
  E::sqr(b, Y);
  E::sqr(c, b);
  E::add(t, X, b);
  E::sqr(t, t);
  E::sub(d, t, a);
  E::sub(d, d, c);
  E::add(d, d, d);
  E::add(e, a, a);
  E::add(e, e, a);
  E::sqr(f, e);
  E::add(t, d, d);
  E::sub(x3, f, t);
  E::add(c, c, c);
  E::add(c, c, c);
  E::add(c, c, c);  // 8c
  E::sub(t, d, x3);
  E::mul(t, e, t);
  E::sub(y3, t, c);
  E::mul(z3, Y, Z);
  E::add(z3, z3, z3);
  for (int i = 0; i < W; ++i) { r[i] = x3[i]; r[W + i] = y3[i]; r[2 * W + i] = z3[i]; }
}

// Shared tail of add and madd once u1, s1, h, rr = s2 - s1 are known.
// z3 must already hold the Z coordinate.
template <class E>
ZC_HD void jac_add_tail(uint32_t* r, const uint32_t* u1, const uint32_t* s1,
                        const uint32_t* h, const uint32_t* rr, const uint32_t* z3) {
  constexpr int W = E::W;
  uint32_t i[W], j[W], r2[W], v[W], x3[W], y3[W], t[W];
  E::add(i, h, h);
  E::sqr(i, i);
  E::mul(j, h, i);
  E::add(r2, rr, rr);
  E::mul(v, u1, i);
  E::sqr(x3, r2);
  E::sub(x3, x3, j);
  E::add(t, v, v);
  E::sub(x3, x3, t);
  E::mul(j, s1, j);  // s1 * j
  E::sub(t, v, x3);
  E::mul(t, r2, t);
  E::add(j, j, j);
  E::sub(y3, t, j);
  for (int k = 0; k < W; ++k) { r[k] = x3[k]; r[W + k] = y3[k]; r[2 * W + k] = z3[k]; }
}

template <class E>
ZC_NOINLINE void jac_add(uint32_t* r, const uint32_t* p, const uint32_t* q) {
  constexpr int W = E::W;
  if (jac_is_identity<E>(p)) { jac_copy<E>(r, q); return; }
  if (jac_is_identity<E>(q)) { jac_copy<E>(r, p); return; }
  const uint32_t *X1 = p, *Y1 = p + W, *Z1 = p + 2 * W;
  const uint32_t *X2 = q, *Y2 = q + W, *Z2 = q + 2 * W;
  uint32_t z1z1[W], z2z2[W], u1[W], u2[W], s1[W], s2[W], h[W], rr[W], z3[W];
  E::sqr(z1z1, Z1);
  E::sqr(z2z2, Z2);
  E::mul(u1, X1, z2z2);
  E::mul(u2, X2, z1z1);
  E::mul(s1, Y1, Z2);
  E::mul(s1, s1, z2z2);
  E::mul(s2, Y2, Z1);
  E::mul(s2, s2, z1z1);
  E::sub(h, u2, u1);
  E::sub(rr, s2, s1);
  if (E::is_zero(h)) {
    if (E::is_zero(rr)) jac_double<E>(r, p);
    else jac_set_identity<E>(r);
    return;
  }
  E::add(z3, Z1, Z2);
  E::sqr(z3, z3);
  E::sub(z3, z3, z1z1);
  E::sub(z3, z3, z2z2);
  E::mul(z3, z3, h);
  jac_add_tail<E>(r, u1, s1, h, rr, z3);
}

// Mixed add: q's Z is 0 (infinity) or one.
template <class E>
ZC_NOINLINE void jac_madd(uint32_t* r, const uint32_t* p, const uint32_t* q) {
  constexpr int W = E::W;
  if (jac_is_identity<E>(p)) { jac_copy<E>(r, q); return; }
  if (jac_is_identity<E>(q)) { jac_copy<E>(r, p); return; }
  const uint32_t *X1 = p, *Y1 = p + W, *Z1 = p + 2 * W;
  const uint32_t *X2 = q, *Y2 = q + W;
  uint32_t z1z1[W], u2[W], s2[W], h[W], rr[W], z3[W];
  E::sqr(z1z1, Z1);
  E::mul(u2, X2, z1z1);
  E::mul(s2, Y2, Z1);
  E::mul(s2, s2, z1z1);
  E::sub(h, u2, X1);
  E::sub(rr, s2, Y1);
  if (E::is_zero(h)) {
    if (E::is_zero(rr)) jac_double<E>(r, p);
    else jac_set_identity<E>(r);
    return;
  }
  E::mul(z3, Z1, h);
  E::add(z3, z3, z3);
  uint32_t x1[W], y1[W];  // r may alias p
  for (int k = 0; k < W; ++k) { x1[k] = X1[k]; y1[k] = Y1[k]; }
  jac_add_tail<E>(r, x1, y1, h, rr, z3);
}
