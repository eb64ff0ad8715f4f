// Short-Weierstrass group law in Jacobian coordinates (y^2 = x^3 + b),
// generic over the coordinate field E (FqE for G1, Fq2E for G2), on values.
//
// A point is Jac<E>: X, Y, Z, each an E::V; infinity <=> Z = 0.  The
// formulas and their degenerate-case handling are those of the fused TPU
// kernels (zerochain_tpu/ec/pallas_ec.py: _double_planes, _add_planes,
// _madd_planes): dbl-2009-l, add-2007-bl and its Z2 in {0, 1}
// specialisation, with
//   P = inf -> Q;  Q = inf -> P;  P = Q -> double(P);  P = -Q -> (1, 1, 0).
// The TPU kernels compute every case and select by mask; a thread here
// branches.  Coordinates are lazy (field.cuh): every zero test takes the
// class, and jac_scatter writes canonical words, so the words that leave a
// thread equal those of any other correct implementation.
//
// Design: the formulas take and return values and are inlined into the
// kernels; the one thing out of line is the Fq multiply (fq_mul, one
// instance an image), called on values.  No array of a point or of a
// temporary has its address taken, so the operands of every multiply pass
// in registers and the G1 kernels have 0-byte frames; a G2 full add, two
// 72-word points beside its temporaries, passes 255 registers and spills
// (PERF.md).  Inlining a formula costs its additions and the calls' register
// moves; the multiplies, ~600 instructions each, are not repeated at every
// site (a G1 mixed add with its 11 multiplies inlined is several times that
// size, which is what made the inlined form of earlier versions slow).
//
// Points move between planes and values by jac_gather / jac_scatter: word j
// of a point (coordinate j / W, then component, then word) is word j % 12 of
// plane j / 12.  The loops are unrolled, so every index is a constant.
#pragma once
#include "fq2.cuh"

template <class E>
struct Jac {
  typename E::V x, y, z;
};

template <class E>
ZC_HD typename E::V& jac_coord(Jac<E>& p, int k) { return k == 0 ? p.x : k == 1 ? p.y : p.z; }
template <class E>
ZC_HD const typename E::V& jac_coord(const Jac<E>& p, int k) {
  return k == 0 ? p.x : k == 1 ? p.y : p.z;
}

// Word j of the point's 3 * E::W words.
template <class E>
ZC_HD uint32_t& jac_word(Jac<E>& p, int j) {
  return E::word(jac_coord(p, j / E::W), (j % E::W) / 12, j % 12);
}
template <class E>
ZC_HD uint32_t jac_word(const Jac<E>& p, int j) {
  return E::word(jac_coord(p, j / E::W), (j % E::W) / 12, j % 12);
}

// The point whose word w of plane k is get(k, w).
template <class E, class Get>
ZC_HD Jac<E> jac_gather(Get get) {
  Jac<E> p;
#pragma unroll
  for (int j = 0; j < 3 * E::W; ++j) jac_word(p, j) = get(j / 12, j % 12);
  return p;
}

template <class E>
ZC_HD Jac<E> jac_canon(const Jac<E>& p) {
  return {E::canon(p.x), E::canon(p.y), E::canon(p.z)};
}

// put(k, w, word): the canonical words of p, plane by plane.
template <class E, class Put>
ZC_HD void jac_scatter(const Jac<E>& p, Put put) {
  const Jac<E> c = jac_canon(p);
#pragma unroll
  for (int j = 0; j < 3 * E::W; ++j) put(j / 12, j % 12, jac_word(c, j));
}

template <class E>
ZC_HD Jac<E> jac_identity() {
  return {E::one(), E::one(), E::zero()};
}

template <class E>
ZC_HD bool jac_is_identity(const Jac<E>& p) { return E::is_zero(p.z); }

// dbl-2009-l: 2M + 5S (no case: infinity gives Z = 0).
template <class E>
ZC_HD Jac<E> jac_double(const Jac<E>& p) {
  using V = typename E::V;
  const V a = E::sqr(p.x), b = E::sqr(p.y), c = E::sqr(b);
  V d = E::sub(E::sub(E::sqr(E::add(p.x, b)), a), c);
  d = E::add(d, d);
  const V e = E::add(E::add(a, a), a);
  const V x3 = E::sub(E::sqr(e), E::add(d, d));
  V c8 = E::add(c, c);
  c8 = E::add(c8, c8);
  c8 = E::add(c8, c8);
  const V y3 = E::sub(E::mul(e, E::sub(d, x3)), c8);
  const V z3 = E::mul(p.y, p.z);
  return {x3, y3, E::add(z3, z3)};
}

// Shared tail of add and madd once u1, s1, h, rr = s2 - s1 and Z3 are known.
template <class E>
ZC_HD Jac<E> jac_add_tail(const typename E::V& u1, const typename E::V& s1,
                          const typename E::V& h, const typename E::V& rr,
                          const typename E::V& z3) {
  using V = typename E::V;
  const V i = E::sqr(E::add(h, h));
  const V j = E::mul(h, i);
  const V r2 = E::add(rr, rr);
  const V v = E::mul(u1, i);
  const V x3 = E::sub(E::sub(E::sqr(r2), j), E::add(v, v));
  const V s1j = E::mul(s1, j);
  const V y3 = E::sub(E::mul(r2, E::sub(v, x3)), E::add(s1j, s1j));
  return {x3, y3, z3};
}

// add-2007-bl: 11M + 5S.  The products are taken in the order that ends the
// operands' coordinates soonest (p stays for P = Q).
template <class E>
ZC_HD Jac<E> jac_add(const Jac<E>& p, const Jac<E>& q) {
  using V = typename E::V;
  if (jac_is_identity(p)) return q;
  if (jac_is_identity(q)) return p;
  const V z2z2 = E::sqr(q.z);
  const V u1 = E::mul(p.x, z2z2);
  const V s1 = E::mul(E::mul(p.y, q.z), z2z2);
  const V z1z1 = E::sqr(p.z);
  const V zs = E::sub(E::sub(E::sqr(E::add(p.z, q.z)), z1z1), z2z2);
  const V h = E::sub(E::mul(q.x, z1z1), u1);
  const V rr = E::sub(E::mul(E::mul(q.y, p.z), z1z1), s1);
  if (E::is_zero(h)) return E::is_zero(rr) ? jac_double(p) : jac_identity<E>();
  return jac_add_tail<E>(u1, s1, h, rr, E::mul(zs, h));
}

// Mixed add, q's Z in {0 (infinity), one}: 7M + 4S.
template <class E>
ZC_HD Jac<E> jac_madd(const Jac<E>& p, const Jac<E>& q) {
  using V = typename E::V;
  if (jac_is_identity(p)) return q;
  if (jac_is_identity(q)) return p;
  const V z1z1 = E::sqr(p.z);
  const V u2 = E::mul(q.x, z1z1);
  const V s2 = E::mul(E::mul(q.y, p.z), z1z1);
  const V h = E::sub(u2, p.x), rr = E::sub(s2, p.y);
  if (E::is_zero(h)) return E::is_zero(rr) ? jac_double(p) : jac_identity<E>();
  const V z3 = E::mul(p.z, h);
  return jac_add_tail<E>(p.x, p.y, h, rr, E::add(z3, z3));
}

// k * p for k >= 1, MSB-first double-and-add.
template <class E>
ZC_HD Jac<E> jac_small_mul(const Jac<E>& p, int k) {
  int top = 30;
  while (!((k >> top) & 1)) --top;
  Jac<E> r = p;
#pragma unroll 1
  for (int b = top - 1; b >= 0; --b) {
    r = jac_double(r);
    if ((k >> b) & 1) r = jac_add(r, p);
  }
  return r;
}

#ifdef __CUDACC__
// The point of lane (lane ^ s) of the warp, by shuffles of its words.
template <class E>
__device__ __forceinline__ Jac<E> jac_shfl_xor(const Jac<E>& p, int s) {
  Jac<E> r;
#pragma unroll
  for (int j = 0; j < 3 * E::W; ++j) jac_word(r, j) = __shfl_xor_sync(0xffffffffu, jac_word(p, j), s);
  return r;
}
#endif
