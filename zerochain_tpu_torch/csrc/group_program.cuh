// Point chains spread over a group of lanes: the double-and-add ladder, the
// Horner window combine and the bucket fold of ec_kernels.cu, one group of L
// lanes per point (per row for the fold).
//
// A chain step (add-2007-bl and dbl-2009-l over Fq or Fq2) is lowered, once
// and on the host, to a straight-line PROGRAM of Fq operations (Montgomery
// multiply, add, subtract) on numbered SLOTS of 12 words.  An Fq2 multiply
// becomes its three Karatsuba products and an Fq2 squaring its two, each a
// separate Fq operation.  The operations are packed into STAGES by their
// depth in the dependency graph: the operations of a stage are independent,
// so the L lanes of a group take them in turn (operation i of a stage on
// lane i mod L), and a warp barrier ends the stage.  A stage holds only
// multiplies or only additions, so the lanes of a warp take the same branch.
//
// The slots of a group live in shared memory: a G2 ladder holds two points
// of 72 words plus the step's temporaries, which registers cannot hold and
// a one-thread-per-point kernel keeps in local memory.  A
// lane loads the two operands of its operation into registers, multiplies
// there (fp_mont_mul_inl, inlined: no call, no local-memory operands) and
// stores the result.  Temporary slots are reused once their last reader's
// stage has ended (a register allocation, done on the host with the schedule).
//
// The cases of the complete addition (P = inf, Q = inf, P = Q, P = -Q) are
// decided after the general formula, by selecting words, as the TPU kernels
// do; the doubling that P = Q needs is run only when a group of the warp
// needs it (a warp vote), so the warp never diverges around it.  Every field
// result is canonical, so the words equal those of the plain versions
// (cuda_ec.ladder_plain, cuda_ec.horner_plain) whichever lane computes them.
//
// The program construction and the group bodies also compile as plain C++
// (one lane per group, the barriers fall away), which is how
// tests/torch_csrc_host_check.cpp steps through them without the CUDA
// toolkit.
#pragma once
#include <stdint.h>

#include <algorithm>
#include <vector>

#include "jacobian.cuh"

#ifdef __CUDA_ARCH__
#define ZP_SYNC(mask) __syncwarp(mask)
#define ZP_ANY(mask, x) __any_sync(mask, x)
#else
#define ZP_SYNC(mask) ((void)(mask))
#define ZP_ANY(mask, x) ((void)(mask), (x))
#endif

enum : uint8_t { ZP_MUL = 0, ZP_ADD = 1, ZP_SUB = 2 };

// The programs of a set, and the pinned E-slots (an E-slot is one
// coordinate: one Fq slot for G1, two for G2) they read and write.
enum : int { ZP_STEP = 0, ZP_ADDP = 1, ZP_DBLA = 2, ZP_N_PROGS = 3 };
//   STEP: R = ACC + CUR (general formula, H and RR kept), CN = 2 * CUR
//   ADDP: R = ACC + CUR (general formula, H and RR kept)
//   DBLA: DA = 2 * ACC
//   TOT (the fold's total) is read and written by the fold alone.
enum : int {
  ZP_ACC = 0, ZP_CUR = 3, ZP_R = 6, ZP_CN = 9, ZP_H = 12, ZP_RR = 13,
  ZP_DA = 14, ZP_TOT = 17, ZP_PINNED = 20
};

constexpr int ZP_MAX_OPS = 448;
constexpr int ZP_MAX_STAGES = 192;

struct ZpOp {
  uint8_t op, d, a, b;  // slot d = slot a (op) slot b
};

struct ZpSet {
  int32_t n_slots;                      // Fq slots one group needs
  uint16_t prog_stage[ZP_N_PROGS + 1];  // program p: stages [prog_stage[p], prog_stage[p + 1])
  uint16_t stage_end[ZP_MAX_STAGES];    // stage s: ops [stage_end[s - 1], stage_end[s])
  ZpOp ops[ZP_MAX_OPS];
};

// ---------------------------------------------------------------------
// Executing a program: every lane of the group calls this.
// ---------------------------------------------------------------------
struct ZpGroup {
  uint32_t* s;     // the group's slots, 12 words each
  int lane, L;     // this lane, the group's lanes
  unsigned mask;   // the lanes of the warp that take part
};

ZC_HD void zp_run(const ZpSet* ps, int prog, const ZpGroup& g) {
  const int s0 = ps->prog_stage[prog], s1 = ps->prog_stage[prog + 1];
  for (int st = s0; st < s1; ++st) {
    const int b = st ? ps->stage_end[st - 1] : 0, e = ps->stage_end[st];
    for (int i = b + g.lane; i < e; i += g.L) {
      const ZpOp o = ps->ops[i];
      uint32_t x[12], y[12], r[12];
#pragma unroll
      for (int w = 0; w < 12; ++w) {
        x[w] = g.s[o.a * 12 + w];
        y[w] = g.s[o.b * 12 + w];
      }
      if (o.op == ZP_MUL) fp_mont_mul_inl<FqP>(r, x, y);
      else if (o.op == ZP_ADD) fp_add<FqP>(r, x, y);
      else fp_sub<FqP>(r, x, y);
#pragma unroll
      for (int w = 0; w < 12; ++w) g.s[o.d * 12 + w] = r[w];
    }
    ZP_SYNC(g.mask);
  }
}

// Word j of plane k of the identity (1, 1, 0): X and Y are one (c0 = R mod
// p, c1 = 0 for Fq2), Z is zero.
ZC_HD uint32_t zp_identity_word(int nc, int k, int j) {
  return (k < 2 * nc && k % nc == 0) ? FqP::one(j) : 0u;
}

ZC_HD bool zp_is_zero(const uint32_t* s, int fq_slot, int nc) {
  uint32_t acc = 0;
  for (int w = 0; w < 12 * nc; ++w) acc |= s[fq_slot * 12 + w];
  return acc == 0;
}

// After ADDP or STEP: ACC <- take ? ACC + CUR (all cases) : ACC, and for
// STEP also CUR <- CN.  The case order is cuda_ec.add_plain's: P = inf -> Q;
// Q = inf -> P; P = Q -> 2P; P = -Q -> inf.
template <class E>
ZC_HD void zp_finish_add(const ZpSet* ps, const ZpGroup& g, bool take, bool step) {
  constexpr int NC = E::W / 12, PW = 3 * E::W;
  uint32_t* S = g.s;
  const bool p_inf = zp_is_zero(S, (ZP_ACC + 2) * NC, NC);
  const bool q_inf = zp_is_zero(S, (ZP_CUR + 2) * NC, NC);
  const bool h0 = zp_is_zero(S, ZP_H * NC, NC);
  const bool r0 = zp_is_zero(S, ZP_RR * NC, NC);
  const bool same = take && h0 && r0 && !p_inf && !q_inf;
  if (ZP_ANY(g.mask, same)) zp_run(ps, ZP_DBLA, g);
  int src;  // E-slot of the new ACC, -1 for the identity
  if (!take) src = ZP_ACC;
  else if (p_inf) src = ZP_CUR;
  else if (q_inf) src = ZP_ACC;
  else if (h0) src = r0 ? ZP_DA : -1;
  else src = ZP_R;
  // each word is read and written by one lane only
  for (int w = g.lane; w < PW; w += g.L) {
    const int k = w / 12, j = w % 12;
    const uint32_t v = src < 0 ? zp_identity_word(NC, k, j) : S[(src * NC + k) * 12 + j];
    if (step) S[(ZP_CUR * NC + k) * 12 + j] = S[(ZP_CN * NC + k) * 12 + j];
    S[(ZP_ACC * NC + k) * 12 + j] = v;
  }
  ZP_SYNC(g.mask);
}

// The little-endian double-and-add of cuda_ec.ladder_plain for point pt:
// ACC = identity, CUR = base; per bit ACC = bit ? ACC + CUR : ACC and
// CUR = 2 * CUR.  base/out: coordinate planes, word j of point i at
// j * count + i; bits: (n_bits, count), 0 or 1.
template <class E>
ZC_HD void zp_ladder(const ZpSet* ps, const ZpGroup& g,
                     const uint32_t* const* base, uint32_t* const* out,
                     const uint8_t* bits, int n_bits, long long count,
                     long long pt, bool write) {
  constexpr int NC = E::W / 12, PW = 3 * E::W;
  uint32_t* S = g.s;
  for (int w = g.lane; w < PW; w += g.L) {
    const int k = w / 12, j = w % 12;
    S[(ZP_CUR * NC + k) * 12 + j] = base[k][j * count + pt];
    S[(ZP_ACC * NC + k) * 12 + j] = zp_identity_word(NC, k, j);
  }
  ZP_SYNC(g.mask);
  for (int i = 0; i < n_bits; ++i) {
    zp_run(ps, ZP_STEP, g);
    zp_finish_add<E>(ps, g, bits[i * count + pt] != 0, true);
  }
  if (write)
    for (int w = g.lane; w < PW; w += g.L) {
      const int k = w / 12, j = w % 12;
      out[k][j * count + pt] = S[(ZP_ACC * NC + k) * 12 + j];
    }
}

// The MSB-first window combine of cuda_ec.horner_plain for point pt:
// ACC = T[nw - 1]; for w = nw - 2 .. 0: ACC = 2^c * ACC + T[w].
// tot: planes (12, nw, count); out: planes (12, count).
template <class E>
ZC_HD void zp_horner(const ZpSet* ps, const ZpGroup& g,
                     const uint32_t* const* tot, uint32_t* const* out,
                     int nw, int c, long long count, long long pt, bool write) {
  constexpr int NC = E::W / 12, PW = 3 * E::W;
  uint32_t* S = g.s;
  for (int w = g.lane; w < PW; w += g.L) {
    const int k = w / 12, j = w % 12;
    S[(ZP_ACC * NC + k) * 12 + j] = tot[k][((long long)j * nw + nw - 1) * count + pt];
  }
  ZP_SYNC(g.mask);
  for (int win = nw - 2; win >= 0; --win) {
    for (int r = 0; r < c; ++r) {
      zp_run(ps, ZP_DBLA, g);
      for (int w = g.lane; w < PW; w += g.L) {
        const int k = w / 12, j = w % 12;
        S[(ZP_ACC * NC + k) * 12 + j] = S[(ZP_DA * NC + k) * 12 + j];
      }
      ZP_SYNC(g.mask);
    }
    for (int w = g.lane; w < PW; w += g.L) {
      const int k = w / 12, j = w % 12;
      S[(ZP_CUR * NC + k) * 12 + j] = tot[k][((long long)j * nw + win) * count + pt];
    }
    ZP_SYNC(g.mask);
    zp_run(ps, ZP_ADDP, g);
    zp_finish_add<E>(ps, g, true, false);
  }
  if (write)
    for (int w = g.lane; w < PW; w += g.L) {
      const int k = w / 12, j = w % 12;
      out[k][j * count + pt] = S[(ZP_ACC * NC + k) * 12 + j];
    }
}

// The running-sum bucket fold of cuda_ec.bucket_fold_plain for row `row`:
// RUN = TOT = identity; for v = nb - 1 .. 1: RUN = RUN + B[v], then
// TOT = TOT + RUN, each an ADDP with its cases.  RUN lives in ACC; for the
// second add ACC and CUR take TOT and RUN and are put back after it.
// bk: planes (12, count, nb); out: planes (12, count).
template <class E>
ZC_HD void zp_fold(const ZpSet* ps, const ZpGroup& g,
                   const uint32_t* const* bk, uint32_t* const* out,
                   int nb, long long count, long long row, bool write) {
  constexpr int NC = E::W / 12, PW = 3 * E::W;
  uint32_t* S = g.s;
  const int acc = ZP_ACC * NC * 12, cur = ZP_CUR * NC * 12, tot = ZP_TOT * NC * 12;
  for (int w = g.lane; w < PW; w += g.L) {
    const uint32_t id = zp_identity_word(NC, w / 12, w % 12);
    S[acc + w] = id;
    S[tot + w] = id;
  }
  ZP_SYNC(g.mask);
  for (int v = nb - 1; v >= 1; --v) {
    for (int w = g.lane; w < PW; w += g.L)
      S[cur + w] = bk[w / 12][((long long)(w % 12) * count + row) * nb + v];
    ZP_SYNC(g.mask);
    zp_run(ps, ZP_ADDP, g);
    zp_finish_add<E>(ps, g, true, false);       // RUN + B[v]
    for (int w = g.lane; w < PW; w += g.L) {  // each word by one lane
      S[cur + w] = S[acc + w];
      S[acc + w] = S[tot + w];
    }
    ZP_SYNC(g.mask);
    zp_run(ps, ZP_ADDP, g);
    zp_finish_add<E>(ps, g, true, false);       // TOT + RUN
    for (int w = g.lane; w < PW; w += g.L) {
      S[tot + w] = S[acc + w];
      S[acc + w] = S[cur + w];
    }
    ZP_SYNC(g.mask);
  }
  if (write)
    for (int w = g.lane; w < PW; w += g.L)
      out[w / 12][(long long)(w % 12) * count + row] = S[tot + w];
}

// ---------------------------------------------------------------------
// Building the programs (host code, run once per group and device).
// ---------------------------------------------------------------------

// Values in SSA form: a value is a pinned input slot or one operation.
struct ZpBuild {
  struct V { int op, a, b, pin; };  // op < 0: an input already in slot pin
  std::vector<V> v;
  int input(int slot) { v.push_back({-1, -1, -1, slot}); return (int)v.size() - 1; }
  int emit(int op, int a, int b) { v.push_back({op, a, b, -1}); return (int)v.size() - 1; }
  void output(int x, int slot) { v[x].pin = slot; }
};

// The coordinate field over Fq values: nc = 1 (Fq) or 2 (Fq2, c0 + c1 u,
// u^2 = -1), with fq2.cuh's formulas.
struct ZpE {
  ZpBuild& B;
  int nc;
  struct EV { int c[2]; };
  EV in(int eslot) {
    EV r{{-1, -1}};
    for (int k = 0; k < nc; ++k) r.c[k] = B.input(eslot * nc + k);
    return r;
  }
  void out(const EV& x, int eslot) {
    for (int k = 0; k < nc; ++k) B.output(x.c[k], eslot * nc + k);
  }
  EV lin(int op, const EV& x, const EV& y) {
    EV r{{-1, -1}};
    for (int k = 0; k < nc; ++k) r.c[k] = B.emit(op, x.c[k], y.c[k]);
    return r;
  }
  EV add(const EV& x, const EV& y) { return lin(ZP_ADD, x, y); }
  EV sub(const EV& x, const EV& y) { return lin(ZP_SUB, x, y); }
  EV mul(const EV& x, const EV& y) {
    if (nc == 1) return EV{{B.emit(ZP_MUL, x.c[0], y.c[0]), -1}};
    const int aa = B.emit(ZP_MUL, x.c[0], y.c[0]);
    const int bb = B.emit(ZP_MUL, x.c[1], y.c[1]);
    const int sx = B.emit(ZP_ADD, x.c[0], x.c[1]);
    const int sy = B.emit(ZP_ADD, y.c[0], y.c[1]);
    const int o = B.emit(ZP_MUL, sx, sy);
    const int s = B.emit(ZP_ADD, aa, bb);
    return EV{{B.emit(ZP_SUB, aa, bb), B.emit(ZP_SUB, o, s)}};
  }
  EV sqr(const EV& x) {
    if (nc == 1) return EV{{B.emit(ZP_MUL, x.c[0], x.c[0]), -1}};
    const int ab = B.emit(ZP_MUL, x.c[0], x.c[1]);
    const int s = B.emit(ZP_ADD, x.c[0], x.c[1]);
    const int d = B.emit(ZP_SUB, x.c[0], x.c[1]);
    return EV{{B.emit(ZP_MUL, s, d), B.emit(ZP_ADD, ab, ab)}};
  }
};

// dbl-2009-l (jac_double): out = 2 * (in), no cases (infinity propagates).
inline void zp_formula_double(ZpE& E, int in, int out) {
  const ZpE::EV X = E.in(in), Y = E.in(in + 1), Z = E.in(in + 2);
  const ZpE::EV a = E.sqr(X), b = E.sqr(Y), c = E.sqr(b);
  ZpE::EV d = E.sub(E.sub(E.sqr(E.add(X, b)), a), c);
  d = E.add(d, d);
  const ZpE::EV e = E.add(E.add(a, a), a);
  const ZpE::EV x3 = E.sub(E.sqr(e), E.add(d, d));
  ZpE::EV c8 = E.add(c, c);
  c8 = E.add(c8, c8);
  c8 = E.add(c8, c8);
  const ZpE::EV y3 = E.sub(E.mul(e, E.sub(d, x3)), c8);
  const ZpE::EV yz = E.mul(Y, Z);
  E.out(x3, out);
  E.out(y3, out + 1);
  E.out(E.add(yz, yz), out + 2);
}

// add-2007-bl (jac_add) without its cases: R = P + Q, and H = u2 - u1,
// RR = s2 - s1, from which the cases are decided.
inline void zp_formula_add(ZpE& E, int p, int q, int r, int h_out, int rr_out) {
  const ZpE::EV X1 = E.in(p), Y1 = E.in(p + 1), Z1 = E.in(p + 2);
  const ZpE::EV X2 = E.in(q), Y2 = E.in(q + 1), Z2 = E.in(q + 2);
  const ZpE::EV z1z1 = E.sqr(Z1), z2z2 = E.sqr(Z2);
  const ZpE::EV u1 = E.mul(X1, z2z2), u2 = E.mul(X2, z1z1);
  const ZpE::EV s1 = E.mul(E.mul(Y1, Z2), z2z2);
  const ZpE::EV s2 = E.mul(E.mul(Y2, Z1), z1z1);
  const ZpE::EV h = E.sub(u2, u1), rr = E.sub(s2, s1);
  const ZpE::EV zs = E.sqr(E.add(Z1, Z2));
  const ZpE::EV z3 = E.mul(E.sub(E.sub(zs, z1z1), z2z2), h);
  const ZpE::EV i = E.sqr(E.add(h, h));
  const ZpE::EV j = E.mul(h, i);
  const ZpE::EV r2 = E.add(rr, rr);
  const ZpE::EV v = E.mul(u1, i);
  const ZpE::EV x3 = E.sub(E.sub(E.sqr(r2), j), E.add(v, v));
  const ZpE::EV s1j = E.mul(s1, j);
  const ZpE::EV y3 = E.sub(E.mul(r2, E.sub(v, x3)), E.add(s1j, s1j));
  E.out(x3, r);
  E.out(y3, r + 1);
  E.out(z3, r + 2);
  E.out(h, h_out);
  E.out(rr, rr_out);
}

// Schedule one program and allocate its slots.  A multiply's level is one
// more than its operands' highest level, an addition's the highest; the
// multiplies of level k form one stage, and the additions of level k (which
// may read each other: a chain) form stages of their own between the
// multiply stages k and k + 1, by their depth within the level.  So the
// number of multiply stages is the formula's multiply depth.  Pinned values
// keep their slot; a temporary takes a free slot at or above `base` and
// frees it after the stage of its last reader.  Appends to ps at (*n_ops,
// *n_stages).  Returns false if the set's capacity is exceeded.
inline bool zp_compile(const ZpBuild& B, int base, ZpSet* ps, int* n_ops,
                       int* n_stages) {
  const int n = (int)B.v.size();
  std::vector<char> live(n, 0);
  for (int x = n - 1; x >= 0; --x) {
    const ZpBuild::V& v = B.v[x];
    if (v.op >= 0 && v.pin >= 0) live[x] = 1;
    if (live[x] && v.op >= 0) live[v.a] = live[v.b] = 1;
  }
  std::vector<int> lvl(n, 0), sub(n, 0);  // multiply level; depth among additions of a level
  int max_lvl = 0, max_sub = 0;
  for (int x = 0; x < n; ++x) {
    const ZpBuild::V& v = B.v[x];
    if (v.op < 0 || !live[x]) continue;
    const int l = std::max(lvl[v.a], lvl[v.b]);
    if (v.op == ZP_MUL) {
      lvl[x] = l + 1;
    } else {
      lvl[x] = l;
      for (int o : {v.a, v.b})
        if (B.v[o].op >= 0 && B.v[o].op != ZP_MUL && lvl[o] == l)
          sub[x] = std::max(sub[x], sub[o]);
      sub[x] += 1;
      max_sub = std::max(max_sub, sub[x]);
    }
    max_lvl = std::max(max_lvl, lvl[x]);
  }
  std::vector<std::vector<int>> stages;
  for (int l = 0; l <= max_lvl; ++l) {
    std::vector<int> st;
    if (l > 0) {
      for (int x = 0; x < n; ++x)
        if (live[x] && B.v[x].op == ZP_MUL && lvl[x] == l) st.push_back(x);
      if (!st.empty()) stages.push_back(st);
    }
    for (int d = 1; d <= max_sub; ++d) {
      st.clear();
      for (int x = 0; x < n; ++x)
        if (live[x] && B.v[x].op >= 0 && B.v[x].op != ZP_MUL && lvl[x] == l && sub[x] == d)
          st.push_back(x);
      if (!st.empty()) stages.push_back(st);
    }
  }
  std::vector<int> last(n, -1), stage_of(n, -1);
  for (int s = 0; s < (int)stages.size(); ++s)
    for (int x : stages[s]) {
      stage_of[x] = s;
      last[B.v[x].a] = std::max(last[B.v[x].a], s);
      last[B.v[x].b] = std::max(last[B.v[x].b], s);
    }
  std::vector<int> slot(n, -1);
  for (int x = 0; x < n; ++x)
    if (B.v[x].pin >= 0) slot[x] = B.v[x].pin;
  std::vector<int> free_slots;
  int next = base;
  for (int s = 0; s < (int)stages.size(); ++s) {
    for (int x : stages[s]) {
      if (slot[x] >= 0) continue;
      if (!free_slots.empty()) { slot[x] = free_slots.back(); free_slots.pop_back(); }
      else slot[x] = next++;
    }
    for (int x = 0; x < n; ++x)  // temporaries whose last reader was in stage s
      if (last[x] == s && B.v[x].pin < 0 && B.v[x].op >= 0) free_slots.push_back(slot[x]);
  }
  if (next > 255 || *n_stages + (int)stages.size() > ZP_MAX_STAGES) return false;
  for (auto& st : stages) {
    for (int x : st) {
      if (*n_ops >= ZP_MAX_OPS) return false;
      const ZpBuild::V& v = B.v[x];
      ps->ops[(*n_ops)++] = ZpOp{(uint8_t)v.op, (uint8_t)slot[x],
                                 (uint8_t)slot[v.a], (uint8_t)slot[v.b]};
    }
    ps->stage_end[(*n_stages)++] = (uint16_t)*n_ops;
  }
  ps->n_slots = std::max(ps->n_slots, (int32_t)next);
  return true;
}

// The programs STEP, ADDP, DBLA for G1 (nc = 1) or G2 (nc = 2).
inline bool zp_build_set(int nc, ZpSet* ps) {
  *ps = ZpSet{};
  ps->n_slots = ZP_PINNED * nc;
  int n_ops = 0, n_stages = 0;
  for (int p = 0; p < ZP_N_PROGS; ++p) {
    ps->prog_stage[p] = (uint16_t)n_stages;
    ZpBuild B;
    ZpE E{B, nc};
    if (p != ZP_DBLA) zp_formula_add(E, ZP_ACC, ZP_CUR, ZP_R, ZP_H, ZP_RR);
    if (p == ZP_STEP) zp_formula_double(E, ZP_CUR, ZP_CN);
    if (p == ZP_DBLA) zp_formula_double(E, ZP_ACC, ZP_DA);
    if (!zp_compile(B, ZP_PINNED * nc, ps, &n_ops, &n_stages)) return false;
  }
  ps->prog_stage[ZP_N_PROGS] = (uint16_t)n_stages;
  return true;
}
