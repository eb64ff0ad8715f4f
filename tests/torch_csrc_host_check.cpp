// Host build of the port's CUDA device code (zerochain_tpu_torch/csrc): the
// headers, the per-thread steps of totals_kernel.cu, column_scan_kernel.cu,
// split_tail_kernel.cu and the bucket sums of hs_kernel.cu, the one-lane chain programs of
// group_program.cuh, the Fermat inverse of ff_kernels.cu, the per-lane
// Jubjub chains of jubjub_kernels.cu, the NTT passes and pointwise step of
// ntt_kernel.cu, the witness gadgets' per-thread step and program
// interpreter of witness_kernel.cu and the pairing's stage body of
// pairing_kernel.cu compile as plain C++,
// so their arithmetic can be held against the plain PyTorch versions where
// there is no CUDA toolkit.  Driven by tests/test_torch_csrc_host.py.
//
// stdin, one record after the other:
//   fq|fr|fs  a b            -> mont_mul, add, sub                 (hex words)
//   fql       a b            -> the lazy Fq values of a * b, a + b, a - b, -a (raw),
//                               then canonical, then is_zero(a), is_zero(a - b)
//   g1|g2     p q            -> add, double(p), madd, add in place (hex words)
//   k3 g2 N M nb T R  planes digits order -> the window totals, one line a plane
//   cs g2 M T  planes               -> the column scan in place, one line a plane
//   lad g2 n_bits count  planes bits -> the ladder, one line a plane
//   hor g2 nw c count  planes        -> the Horner combine, one line a plane
//   fold g2 nb count  planes         -> the bucket fold, one line a plane
//   bs g2 N M nb T  planes keys order -> the bucket sums, one line a plane
//   sl g2 N M nb  planes digits order -> the lane pass: lane totals, then slots, one line a plane
//   st g2 N M nb T  lanes slots digits -> the split tail, one line a plane
//   fqi|fri|fsi a                    -> a^(p-2)                        (hex words)
//   jj        p q                    -> jj_add, jj_double(p), jj_add in place
//   jvar n_bits lanes  bx by bits    -> cur, then res, one line each
//   jfix n_win lanes  lx ly          -> the window sums, one line
//   ntt lg M tile_lg s0 k pre post  src tw [pre] [post]
//                                    -> one NTT pass (pre 0/1; post 0, 1 constant,
//                                       2 vector), the words it writes, one line
//   ntp count bc  a [b c] z          -> (a b - c) z, or a z where bc = 0, one line
//   wst n_jobs n_aux B, per job: kind aux_off n_steps n_bits n0 n2 chains index,
//       its point arrays (8, n0 | n0 | n2 | n2, chains, B) and, but for a fold,
//       its bytes (n0, chains, B) as ints
//                                    -> W1's steps of every job, then aux, one line
//   wgp n_ops n_stages n_slots n_aux n_ins B  ops stage_end aux ins
//                                    -> W2's program for every proof, one lane
//                                       a proof, then aux, one line
//   ppr n_ops n_stages n_progs n_seq n_slots n_consts n_in n_out B L
//       ops stage_end prog_stage seq consts ins
//                                    -> the pairing set's sequence for every
//                                       pairing, each stage stepped lane by
//                                       lane (L lanes), then outs, one line
// Threads are stepped through in order, a barrier being the end of a loop
// over the threads.  k3: T threads a row (T = 0: as many as the kernel gives
// the row for its non-zero count, R non-zero digits a thread at least),
// their locals summed as the kernel sums them (a butterfly over each warp's
// lanes, then the warps in order).  lad, hor, fold: one lane a group.  bs:
// T threads a row, each phase (fill, slices, merge) ending in a barrier.  sl:
// every lane of every program in turn.  st: T threads a program, each phase
// and each level of the scan and the tree ending in a barrier.
#include <cstdio>
#include <cstring>
#include <vector>

#include "column_scan_kernel.cu"
#include "ff_kernels.cu"
#include "group_program.cuh"
#include "hs_kernel.cu"
#include "jubjub_kernels.cu"
#include "ntt_kernel.cu"
#include "pairing_kernel.cu"
#include "split_tail_kernel.cu"
#include "totals_kernel.cu"
#include "witness_kernel.cu"

template <int N> static void rd(uint32_t* a) { for (int i = 0; i < N; i++) if (scanf("%x", &a[i]) != 1) a[i] = 0; }
template <int N> static void pr(const uint32_t* a) { for (int i = 0; i < N; i++) printf("%08x ", a[i]); printf("\n"); }

template <class F> static void field_ops() {
  uint32_t a[F::N], b[F::N], r[F::N];
  rd<F::N>(a); rd<F::N>(b);
  fp_mont_mul_inl<F>(r, a, b); pr<F::N>(r);
  fp_add<F>(r, a, b); pr<F::N>(r);
  fp_sub<F>(r, a, b); pr<F::N>(r);
}

// The lazy Fq values: inputs anywhere in [0, 2p).
static void field_lazy() {
  Fq a, b;
  rd<12>(a.w); rd<12>(b.w);
  const Fq v[4] = {fq_mul(a, b), fq_add(a, b), fq_sub(a, b), fq_neg(a)};
  for (const Fq& x : v) pr<12>(x.w);
  for (const Fq& x : v) pr<12>(fq_canon(x).w);
  printf("%d %d\n", (int)fq_is_zero(a), (int)fq_is_zero(fq_sub(a, b)));
}

template <class F> static void field_inv() {
  uint32_t a[F::N], r[F::N];
  rd<F::N>(a);
  fp_inv_fermat<F>(r, a); pr<F::N>(r);
}

static void edwards_ops() {
  uint32_t p[ZC_JJ_PW], q[ZC_JJ_PW], r[ZC_JJ_PW];
  rd<ZC_JJ_PW>(p); rd<ZC_JJ_PW>(q);
  jj_add(r, p, q); pr<ZC_JJ_PW>(r);
  jj_double(r, p); pr<ZC_JJ_PW>(r);
  jj_add(p, p, q); pr<ZC_JJ_PW>(p);
}

static std::vector<uint32_t> read_words(long long n) {
  std::vector<uint32_t> v(n);
  for (auto& x : v) if (scanf("%x", &x) != 1) x = 0;
  return v;
}

static void print_words(const std::vector<uint32_t>& v) {
  for (auto x : v) printf("%08x ", x);
  printf("\n");
}

static void jj_var(int n_bits, long long lanes) {
  auto bx = read_words(8 * lanes), by = read_words(8 * lanes);
  std::vector<uint8_t> bits(n_bits * lanes);
  for (auto& b : bits) { int v = 0; if (scanf("%d", &v) != 1) v = 0; b = (uint8_t)(v != 0); }
  std::vector<uint32_t> cur(24 * n_bits * lanes), res(cur.size());
  JjVarArgs a{bx.data(), by.data(), bits.data(), cur.data(), res.data(), n_bits, lanes};
  for (long long lane = 0; lane < lanes; lane++) jj_var_lane(a, lane);
  print_words(cur);
  print_words(res);
}

static void jj_fixed(int n_win, long long lanes) {
  auto lx = read_words(8 * n_win * lanes), ly = read_words(8 * n_win * lanes);
  std::vector<uint32_t> out(24 * (n_win - 1) * lanes);
  JjFixedArgs a{lx.data(), ly.data(), out.data(), n_win, lanes};
  for (long long lane = 0; lane < lanes; lane++) jj_fixed_lane(a, lane);
  print_words(out);
}

// A point's 3 * E::W words (plane by plane) <-> its value; stored canonical.
template <class E> static Jac<E> jload(const uint32_t* w) {
  return jac_gather<E>([&](int k, int i) { return w[k * 12 + i]; });
}
template <class E> static void jstore(uint32_t* w, const Jac<E>& p) {
  jac_scatter(p, [&](int k, int i, uint32_t x) { w[k * 12 + i] = x; });
}

// p and q may arrive with coordinates in [p, 2p) (the lazy values the
// kernels carry between operations); every result is stored canonical.
template <class E> static void point_ops() {
  constexpr int PW = 3 * E::W;
  uint32_t p[PW], q[PW], r[PW];
  rd<PW>(p); rd<PW>(q);
  const Jac<E> P = jload<E>(p), Q = jload<E>(q);
  jstore<E>(r, jac_add(P, Q)); pr<PW>(r);
  jstore<E>(r, jac_double(P)); pr<PW>(r);
  jstore<E>(r, jac_madd(P, Q)); pr<PW>(r);
  Jac<E> A = P;
  A = jac_add(A, Q);
  jstore<E>(p, A); pr<PW>(p);
}

// The sum of T threads' locals in the kernel's order: per warp of (at most)
// 32 lanes a butterfly of xor shuffles on canonical words, then the warps'
// lane 0 in order.
template <class E> static Jac<E> reduce_threads(std::vector<Jac<E>>& loc, int T) {
  const int lanes = T < 32 ? T : 32;
  std::vector<Jac<E>> nxt(loc.size());
  for (auto& x : loc) x = jac_canon(x);
  for (int s = 1; s < lanes; s <<= 1) {
    for (int t = 0; t < T; t++) {
      const int u = (t & ~31) | ((t & 31) ^ s);
      nxt[t] = jac_canon(jac_add(loc[t], loc[u]));
    }
    loc.swap(nxt);
  }
  Jac<E> res = loc[0];
  for (int w = 1; w * 32 < T; w++) res = jac_add(res, loc[w * 32]);
  return res;
}

template <class E> static void totals(int N, long long M, int nb, int T, int min_run) {
  constexpr int NP = 3 * E::W / 12, PW = 3 * E::W;
  std::vector<std::vector<uint32_t>> planes(NP, std::vector<uint32_t>(12 * N)),
      outs(NP, std::vector<uint32_t>(12 * M));
  std::vector<int32_t> dg(M * N), od(M * N);
  for (auto& p : planes) for (auto& x : p) if (scanf("%x", &x) != 1) x = 0;
  for (auto& x : dg) if (scanf("%d", &x) != 1) x = 0;
  for (auto& x : od) if (scanf("%d", &x) != 1) x = 0;
  TotalsArgs a;
  for (int k = 0; k < NP; k++) { a.planes[k] = planes[k].data(); a.out[k] = outs[k].data(); }
  a.digits = dg.data(); a.order = od.data(); a.N = N; a.nb = nb; a.M = M;
  for (long long m = 0; m < M; m++) {
    const int nnz = totals_nnz(a, m);
    const int TT = T > 0 ? T : 32 * totals_row_warps(nnz, min_run);
    std::vector<Jac<E>> loc(TT);
    std::vector<uint32_t> rows(totals_row_slots(nb) * PW, 0xdeadbeefu);
    std::vector<int32_t> drops(totals_row_slots(nb), 0);
    const TotalsSlots<E> sc{rows.data(), drops.data()};
    for (int t = 0; t < TT; t++) totals_scan<E>(a, m, nnz, t, TT, sc);
    for (int t = 0; t < TT; t++) loc[t] = totals_drops<E>(a, m, nnz, t, TT, sc);
    totals_write<E>(a, m, reduce_threads<E>(loc, TT));
  }
  for (auto& o : outs) { for (auto x : o) printf("%08x ", x); printf("\n"); }
}

template <class E> static const ZpSet* program_set() {
  static ZpSet ps;
  static bool built = zp_build_set(E::W / 12, &ps);
  if (!built) { printf("program set too large\n"); exit(3); }
  return &ps;
}

template <class E> static std::vector<std::vector<uint32_t>> read_planes(long long words) {
  std::vector<std::vector<uint32_t>> planes(3 * E::W / 12, std::vector<uint32_t>(words));
  for (auto& p : planes) for (auto& x : p) if (scanf("%x", &x) != 1) x = 0;
  return planes;
}

template <class E> static void print_planes(std::vector<std::vector<uint32_t>>& planes) {
  for (auto& p : planes) { for (auto x : p) printf("%08x ", x); printf("\n"); }
}

template <class E> static void ladder(int n_bits, long long count) {
  auto planes = read_planes<E>(12 * count);
  auto outs = planes;
  std::vector<uint8_t> bits(n_bits * count);
  for (auto& b : bits) { int v = 0; if (scanf("%d", &v) != 1) v = 0; b = (uint8_t)(v != 0); }
  const uint32_t* in[6]; uint32_t* out[6];
  for (size_t k = 0; k < planes.size(); k++) { in[k] = planes[k].data(); out[k] = outs[k].data(); }
  const ZpSet* ps = program_set<E>();
  std::vector<uint32_t> slots(ps->n_slots * 12);
  for (long long pt = 0; pt < count; pt++)
    zp_ladder<E>(ps, ZpGroup{slots.data(), 0, 1, 1u}, in, out, bits.data(), n_bits, count, pt, true);
  print_planes<E>(outs);
}

template <class E> static void horner(int nw, int c, long long count) {
  auto planes = read_planes<E>(12 * nw * count);
  std::vector<std::vector<uint32_t>> outs(planes.size(), std::vector<uint32_t>(12 * count));
  const uint32_t* in[6]; uint32_t* out[6];
  for (size_t k = 0; k < planes.size(); k++) { in[k] = planes[k].data(); out[k] = outs[k].data(); }
  const ZpSet* ps = program_set<E>();
  std::vector<uint32_t> slots(ps->n_slots * 12);
  for (long long pt = 0; pt < count; pt++)
    zp_horner<E>(ps, ZpGroup{slots.data(), 0, 1, 1u}, in, out, nw, c, count, pt, true);
  print_planes<E>(outs);
}

template <class E> static void fold(int nb, long long count) {
  auto planes = read_planes<E>(12 * count * nb);
  std::vector<std::vector<uint32_t>> outs(planes.size(), std::vector<uint32_t>(12 * count));
  const uint32_t* in[6]; uint32_t* out[6];
  for (size_t k = 0; k < planes.size(); k++) { in[k] = planes[k].data(); out[k] = outs[k].data(); }
  const ZpSet* ps = program_set<E>();
  std::vector<uint32_t> slots(ps->n_slots * 12);
  for (long long row = 0; row < count; row++)
    zp_fold<E>(ps, ZpGroup{slots.data(), 0, 1, 1u}, in, out, nb, count, row, true);
  print_planes<E>(outs);
}

template <class E> static void bucket_sums(int N, long long M, int nb, int T) {
  auto planes = read_planes<E>(12 * N);
  std::vector<std::vector<uint32_t>> outs(planes.size(), std::vector<uint32_t>(12 * M * nb));
  std::vector<int32_t> keys(M * N), order(M * N);
  for (auto& x : keys) if (scanf("%d", &x) != 1) x = 0;
  for (auto& x : order) if (scanf("%d", &x) != 1) x = 0;
  std::vector<uint32_t> carry(M * T * 2 * 3 * E::W, 0xdeadbeefu);
  BucketArgs a;
  for (size_t k = 0; k < planes.size(); k++) { a.planes[k] = planes[k].data(); a.out[k] = outs[k].data(); }
  a.keys = keys.data(); a.order = order.data(); a.carry = carry.data();
  a.N = N; a.nb = nb; a.M = M;
  for (long long m = 0; m < M; m++) {
    int lo, hi;
    bs_range(a, m, &lo, &hi);
    for (int t = 0; t < T; t++) bs_fill<E>(a, m, t, T);
    for (int t = 0; t < T; t++) bs_slice<E>(a, m, lo, hi, t, T);
    for (int t = 0; t < T; t++) bs_merge<E>(a, m, lo, hi, t, T);
  }
  print_planes<E>(outs);
}

template <class E> static void split_lanes(int N, long long M, int nb) {
  auto planes = read_planes<E>(12 * N);
  std::vector<std::vector<uint32_t>> lanes(planes.size(), std::vector<uint32_t>(12 * M * ZC_ST_LANES)),
      slots(planes.size(), std::vector<uint32_t>(12 * M * nb, 0xdeadbeefu));
  std::vector<int32_t> digits(M * N), order(M * N);
  for (auto& x : digits) if (scanf("%d", &x) != 1) x = 0;
  for (auto& x : order) if (scanf("%d", &x) != 1) x = 0;
  SplitArgs a = {};
  for (size_t k = 0; k < planes.size(); k++) {
    a.planes[k] = planes[k].data(); a.lanes[k] = lanes[k].data(); a.slots[k] = slots[k].data();
  }
  a.digits = digits.data(); a.order = order.data();
  a.N = N; a.nb = nb; a.M = M;
  for (long long m = 0; m < M; m++)
    for (int vl = 0; vl < ZC_ST_LANES; vl++) sl_lane<E>(a, m, vl);
  print_planes<E>(lanes);
  print_planes<E>(slots);
}

template <class E> static void split_tail(int N, long long M, int nb, int T) {
  auto lanes = read_planes<E>(12 * M * ZC_ST_LANES);
  auto slots = read_planes<E>(12 * M * nb);
  std::vector<std::vector<uint32_t>> outs(lanes.size(), std::vector<uint32_t>(12 * M));
  std::vector<int32_t> digits(M * N);
  for (auto& x : digits) if (scanf("%d", &x) != 1) x = 0;
  int S = 1;
  while (S < T || S < nb - 1) S <<= 1;
  std::vector<uint32_t> scratch(M * (2 * S + 2 * nb) * 3 * E::W, 0xdeadbeefu);
  SplitArgs a = {};
  for (size_t k = 0; k < lanes.size(); k++) {
    a.lanes[k] = lanes[k].data(); a.slots[k] = slots[k].data(); a.out[k] = outs[k].data();
  }
  a.digits = digits.data(); a.scratch = scratch.data();
  a.N = N; a.nb = nb; a.S = S; a.M = M;
  for (long long m = 0; m < M; m++) {
    const int nnz = st_count(a, m, 1);
    for (int t = 0; t < T; t++) st_fold<E>(a, m, nnz, t, T);
    for (int k = 0; (1 << k) < T; k++) for (int t = 0; t < T; t++) st_scan<E>(a, m, k, t);
    for (int t = 0; t < T; t++) st_picks<E>(a, m, nnz, st_scan_buf(T), t, T);
    for (int t = 0; t < T; t++) st_buckets<E>(a, m, t, T);
    for (int h = S >> 1; h >= 1; h >>= 1) for (int t = 0; t < T; t++) st_tree<E>(a, m, h, t, T);
    st_write<E>(a, m);
  }
  print_planes<E>(outs);
}

template <class E> static void column_scan(long long M, int T) {
  constexpr int NP = 3 * E::W / 12;
  const long long n = M * T * ZC_CS_LANES;
  std::vector<std::vector<uint32_t>> planes(NP, std::vector<uint32_t>(12 * n));
  for (auto& p : planes) for (auto& x : p) if (scanf("%x", &x) != 1) x = 0;
  uint32_t* ptrs[NP];
  for (int k = 0; k < NP; k++) ptrs[k] = planes[k].data();
  for (long long m = 0; m < M; m++)
    for (int vl = 0; vl < ZC_CS_LANES; vl++) column_scan_lane<E>(ptrs, n, T, m, vl);
  for (auto& p : planes) { for (auto x : p) printf("%08x ", x); printf("\n"); }
}

static void ntt_pass_host(int lg, long long M, int tile_lg, int s0, int k,
                          int pre_mode, int post_mode) {
  const long long d = 1LL << lg;
  const std::vector<uint32_t> src = read_words(8 * (M << lg));
  const std::vector<uint32_t> tw = read_words(8 * (d > 1 ? d - 1 : 1));
  const std::vector<uint32_t> pre = read_words(pre_mode ? 8 * d : 0);
  const std::vector<uint32_t> post = read_words(post_mode == 1 ? 8 : post_mode ? 8 * d : 0);
  NttPassArgs A = ntt_args(M, lg, s0, k, tile_lg);
  A.tw = tw.data();
  A.pre = pre_mode ? pre.data() : nullptr;
  A.post = post_mode ? post.data() : nullptr;
  A.post_const = post_mode == 1;
  std::vector<uint32_t> dst(src.size(), 0), tile(8 * A.pitch);
  const long long blocks = (A.groups + (1LL << A.glg) - 1) >> A.glg;
  for (long long blk = 0; blk < blocks; blk++) {
    for (int t = 0; t < A.n_tile; t++) ntt_load(A, src.data(), tile.data(), blk, ntt_elem(A, t, false));
    for (int j = 0; j < k; j++)
      for (int b = 0; b < A.n_tile / 2; b++) ntt_butterfly(A, tile.data(), blk, j, b);
    for (int t = 0; t < A.n_tile; t++) ntt_store(A, tile.data(), dst.data(), blk, ntt_elem(A, t, s0 == 0));
  }
  print_words(dst);
}

static void ntt_pointwise_host(long long count, int bc) {
  const std::vector<uint32_t> a = read_words(8 * count);
  const std::vector<uint32_t> b = read_words(bc ? 8 * count : 0), c = read_words(bc ? 8 * count : 0);
  const std::vector<uint32_t> z = read_words(8);
  std::vector<uint32_t> out(8 * count);
  for (long long i = 0; i < count; i++)
    ntt_pointwise_elem(a.data(), bc ? b.data() : nullptr, bc ? c.data() : nullptr,
                       z.data(), out.data(), count, i);
  print_words(out);
}

static void wit_steps_host(int n_jobs, long long n_aux, long long B) {
  std::vector<std::vector<uint32_t>> words;
  std::vector<std::vector<uint8_t>> bytes;
  words.reserve(4 * n_jobs);
  bytes.reserve(n_jobs);
  static WitStepArgs a;
  std::vector<uint32_t> aux(8 * n_aux * B);
  a.aux = aux.data();
  a.n_aux = n_aux;
  a.B = B;
  a.n_jobs = n_jobs;
  for (int i = 0; i < n_jobs; i++) {
    WitJob& j = a.jobs[i];
    long long n0, n2, chains, index;
    if (scanf("%d %d %d %d %lld %lld %lld %lld", &j.kind, &j.aux_off, &j.n_steps,
              &j.n_bits, &n0, &n2, &chains, &index) != 8) return;
    j.step_stride = chains * B;
    for (int k = 0; k < 4; k++) {
      const long long n = k < 2 ? n0 : n2;
      words.push_back(read_words(8 * n * chains * B));
      j.p[k] = words.back().data() + index * B;
      j.wstride[k] = n * chains * B;
    }
    bytes.emplace_back(j.kind == WS_FOLD ? 0 : n0 * chains * B);
    for (auto& v : bytes.back()) { int x = 0; if (scanf("%d", &x) != 1) x = 0; v = (uint8_t)x; }
    j.p[4] = bytes.back().data() + index * B;
  }
  for (int i = 0; i < n_jobs; i++)
    for (long long s = 0; s < a.jobs[i].n_steps; s++)
      for (long long b = 0; b < B; b++) wit_step(a, a.jobs[i], s, b);
  print_words(aux);
}

static void wit_program_host(int n_ops, int n_stages, int n_slots, long long n_aux,
                             long long n_ins, long long B) {
  std::vector<int32_t> ops(4 * n_ops), ends(n_stages);
  for (auto& v : ops) if (scanf("%d", &v) != 1) v = 0;
  for (auto& v : ends) if (scanf("%d", &v) != 1) v = 0;
  std::vector<uint32_t> aux = read_words(8 * n_aux * B), ins = read_words(8 * n_ins * B);
  std::vector<uint32_t> slots(8 * n_slots);
  const WitProg g{ops.data(), ends.data(), n_stages, n_slots, aux.data(), n_aux,
                  ins.data(), n_ins, B};
  for (long long b = 0; b < B; b++) wg_run(g, slots.data(), b, 0, 1);
  print_words(aux);
}

static void pairing_set_host(int n_ops, int n_stages, int n_progs, int n_seq, int n_slots,
                             int n_consts, long long n_in, long long n_out, long long B, int L) {
  std::vector<int32_t> ops(4 * n_ops), ends(n_stages), pstage(n_progs + 1), seq(2 * n_seq);
  for (auto* v : {&ops, &ends, &pstage, &seq})
    for (auto& x : *v) if (scanf("%d", &x) != 1) x = 0;
  const std::vector<uint32_t> consts = read_words(12 * n_consts), ins = read_words(12 * n_in * B);
  std::vector<uint32_t> outs(12 * n_out * B), slots(12 * PP_MAX_SLOTS);
  const PpArgs g{(const PpOp*)ops.data(), ends.data(), pstage.data(), seq.data(), n_seq,
                 n_slots, n_consts, consts.data(), ins.data(), outs.data(), n_in, n_out, B};
  for (long long b = 0; b < B; b++)
    for (int e = 0; e < n_seq; e++)
      for (int st = pstage[seq[2 * e]]; st < pstage[seq[2 * e] + 1]; st++)
        for (int lane = 0; lane < L; lane++) pp_stage(g, st, seq[2 * e + 1], slots.data(), b, lane, L);
  print_words(outs);
}

int main() {
  char op[16];
  while (scanf("%15s", op) == 1) {
    if (!strcmp(op, "fq")) field_ops<FqP>();
    else if (!strcmp(op, "fr")) field_ops<FrP>();
    else if (!strcmp(op, "fs")) field_ops<FsP>();
    else if (!strcmp(op, "fql")) field_lazy();
    else if (!strcmp(op, "fqi")) field_inv<FqP>();
    else if (!strcmp(op, "fri")) field_inv<FrP>();
    else if (!strcmp(op, "fsi")) field_inv<FsP>();
    else if (!strcmp(op, "jj")) edwards_ops();
    else if (!strcmp(op, "jvar")) {
      int n_bits; long long lanes;
      if (scanf("%d %lld", &n_bits, &lanes) != 2) return 2;
      jj_var(n_bits, lanes);
    } else if (!strcmp(op, "jfix")) {
      int n_win; long long lanes;
      if (scanf("%d %lld", &n_win, &lanes) != 2) return 2;
      jj_fixed(n_win, lanes);
    }
    else if (!strcmp(op, "ntt")) {
      int lg, tile_lg, s0, k, pre, post; long long M;
      if (scanf("%d %lld %d %d %d %d %d", &lg, &M, &tile_lg, &s0, &k, &pre, &post) != 7) return 2;
      ntt_pass_host(lg, M, tile_lg, s0, k, pre, post);
    } else if (!strcmp(op, "wst")) {
      int n_jobs; long long n_aux, B;
      if (scanf("%d %lld %lld", &n_jobs, &n_aux, &B) != 3 || n_jobs > WIT_MAX_JOBS) return 2;
      wit_steps_host(n_jobs, n_aux, B);
    } else if (!strcmp(op, "wgp")) {
      int n_ops, n_stages, n_slots; long long n_aux, n_ins, B;
      if (scanf("%d %d %d %lld %lld %lld", &n_ops, &n_stages, &n_slots, &n_aux, &n_ins, &B) != 6)
        return 2;
      wit_program_host(n_ops, n_stages, n_slots, n_aux, n_ins, B);
    } else if (!strcmp(op, "ppr")) {
      int n_ops, n_stages, n_progs, n_seq, n_slots, n_consts, L; long long n_in, n_out, B;
      if (scanf("%d %d %d %d %d %d %lld %lld %lld %d", &n_ops, &n_stages, &n_progs, &n_seq,
                &n_slots, &n_consts, &n_in, &n_out, &B, &L) != 10 || n_slots > PP_MAX_SLOTS)
        return 2;
      pairing_set_host(n_ops, n_stages, n_progs, n_seq, n_slots, n_consts, n_in, n_out, B, L);
    } else if (!strcmp(op, "ntp")) {
      int bc; long long count;
      if (scanf("%lld %d", &count, &bc) != 2) return 2;
      ntt_pointwise_host(count, bc);
    }
    else if (!strcmp(op, "g1")) point_ops<FqE>();
    else if (!strcmp(op, "g2")) point_ops<Fq2E>();
    else if (!strcmp(op, "k3")) {
      int g2, N, nb, T, R; long long M;
      if (scanf("%d %d %lld %d %d %d", &g2, &N, &M, &nb, &T, &R) != 6) return 2;
      if (g2) totals<Fq2E>(N, M, nb, T, R); else totals<FqE>(N, M, nb, T, R);
    } else if (!strcmp(op, "lad")) {
      int g2, n_bits; long long count;
      if (scanf("%d %d %lld", &g2, &n_bits, &count) != 3) return 2;
      if (g2) ladder<Fq2E>(n_bits, count); else ladder<FqE>(n_bits, count);
    } else if (!strcmp(op, "hor")) {
      int g2, nw, c; long long count;
      if (scanf("%d %d %d %lld", &g2, &nw, &c, &count) != 4) return 2;
      if (g2) horner<Fq2E>(nw, c, count); else horner<FqE>(nw, c, count);
    } else if (!strcmp(op, "fold")) {
      int g2, nb; long long count;
      if (scanf("%d %d %lld", &g2, &nb, &count) != 3) return 2;
      if (g2) fold<Fq2E>(nb, count); else fold<FqE>(nb, count);
    } else if (!strcmp(op, "bs")) {
      int g2, N, nb, T; long long M;
      if (scanf("%d %d %lld %d %d", &g2, &N, &M, &nb, &T) != 5) return 2;
      if (g2) bucket_sums<Fq2E>(N, M, nb, T); else bucket_sums<FqE>(N, M, nb, T);
    } else if (!strcmp(op, "sl")) {
      int g2, N, nb; long long M;
      if (scanf("%d %d %lld %d", &g2, &N, &M, &nb) != 4) return 2;
      if (g2) split_lanes<Fq2E>(N, M, nb); else split_lanes<FqE>(N, M, nb);
    } else if (!strcmp(op, "st")) {
      int g2, N, nb, T; long long M;
      if (scanf("%d %d %lld %d %d", &g2, &N, &M, &nb, &T) != 5) return 2;
      if (g2) split_tail<Fq2E>(N, M, nb, T); else split_tail<FqE>(N, M, nb, T);
    } else if (!strcmp(op, "cs")) {
      int g2, T; long long M;
      if (scanf("%d %lld %d", &g2, &M, &T) != 3) return 2;
      if (g2) column_scan<Fq2E>(M, T); else column_scan<FqE>(M, T);
    } else return 2;
  }
  return 0;
}
