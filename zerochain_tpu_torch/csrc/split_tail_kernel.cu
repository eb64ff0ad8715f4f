// The split tail of the suffix MSM for one chunk, in two kernels.  For each
// (window, proof) program m whose digits d[m, :] arrive sorted by |d|
// descending with their point indices order[m, :], the pair returns
//   out[m] = sum_{t=1}^{nb-1} prefix[c_t - 1],   c_t = #{i : |d_i| >= t},
// (the identity where c_t = 0), prefix being the inclusive running sum of the
// sorted points with Y negated where the digit is negative: the suffix-sum
// form of sum_i d_i * P[order[m, i]].  The sorted row is 1024 lanes of
// D = N / 1024 positions (lane vl holds vl*D .. vl*D + D - 1, the logical
// order of cuda_scan.logical_to_phys).
//
//   zc_split_lanes (the lane pass, P4 redesigned): each lane scanned down its
//     depths with mixed adds as far as the row's non-zero digits reach; out:
//     the lane totals (identity for a lane with none) and, in slot v, the
//     in-lane prefix at the pick position of magnitude v (the position p with
//     |d_p| = v > |d_p+1|, which is c_t - 1 for t in (|d_p+1|, v]), or the
//     identity where no position is one.
//   zc_split_tail: one CTA a program: the lane offsets (an exclusive scan of
//     the lane totals), each bucket's pick (its lane's offset plus the
//     in-lane prefix) and the sum of the buckets.
//
// Replaces: zerochain_tpu/msm/pallas_scan.py, `_column_scan_kernel` (public
// wrapper column_scan), together with the JAX split tail around it
// (zerochain_tpu/msm/suffix.py, the `use_cm` branch of
// SuffixMsm._partials_body): a column-major sorted copy of the chunk, the
// depth scan written back at every depth, a Hillis-Steele scan of the 1024
// lane totals, a gather and an add for the picks, and a reduction of the
// buckets by circular doubling.
//
// Bound on this card: integer operations.  The lane pass costs one mixed
// add (11 Fq multiplies for G1, 29 for G2) per non-zero position past its
// lane's first; its bytes are the chunk's points, the digits and the order
// once, and 1024 + nb points a program written.  The tail costs full adds
// (16 / 43 multiplies): the scan of the lanes that hold non-zero digits, one
// add a pick and the sum of the buckets; its bytes are what the lane pass
// wrote, the digits, and one point a program.
//
// Design, against what held the composed tail back:
//   - no column-major copy: a lane's points are loaded BY INDEX through
//     `order`, Y negated where the digit is negative, as K3 and bucket_sums
//     do (the chunk stays in L2);
//   - the lane pass stops at the row's first zero digit: a lane past the
//     non-zero count ends at once (no pick lies there, and no total of it
//     offsets a pick), which on the prover's digits skips about a third of
//     G1's positions and half of B2's.  One thread a lane, so the grid holds
//     a million short chains, as column_scan's did;
//   - only what the tail reads is written: 1024 lane totals and nb slots a
//     program, not the 16 depths of every lane;
//   - the lane offsets are a scan in O(lanes) adds (one CTA of T threads a
//     program, T a power of two up to 128): thread t folds the totals of its
//     lanes [t*L, t*L + L), L = ceil(nl / T) over the nl lanes that hold
//     non-zero digits, noting the running fold at each lane that holds a
//     pick; the T segment totals are scanned in log2 T levels (Kogge-Stone,
//     ping-pong between two areas); a lane's offset is the sum of the
//     segments before its own plus its noted fold, formed only for lanes
//     that hold a pick; then one add a pick.  Full adds, because these sums
//     have any Z;
//   - every add of the tail runs in step across a warp: the picks are taken
//     a thread per pick slot, not by the thread that owns the lane (whose
//     picks fall at different positions of its lanes, so that a warp would
//     run its threads' adds one after another);
//   - bucket t takes the pick of slot |d_(c_t - 1)|, and the nb - 1 buckets
//     are summed as a tree of halves (one add a node, log2 steps), not by
//     circular doubling.
// The tail's intermediate points live in a global scratch area of the
// program, which stays in L1/L2; __syncthreads() orders its phases, and no
// phase writes an entry that another thread touches in it.  Every add takes
// its operands as register values loaded from there, and writes canonical
// words back.
//
// The adds are jacobian.cuh's, on values, with the multiply out of line on
// values: the lane pass and the G1 tail have no local-memory frame (the
// form on word arrays and pointers had frames of up to 3,408 bytes); the G2
// tail, whose full adds hold two 72-word points beside their temporaries,
// spills (ptxas; PERF.md).  The lane loop is inline: the fault of the inlined G2 column scan of that form (a
// lane of a warp doubling beside general adds, tools/column_scan_inline.py)
// came with its local memory; chip_smoke.py plants such a lane in its check
// of the lane pass.
//
// Both kernels are plain functions of (program, lane) and (program, thread),
// so the same code can be stepped through on a CPU, thread by thread,
// without the CUDA toolkit.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "jacobian.cuh"

constexpr int ZC_ST_MAX_PLANES = 6;
constexpr int ZC_ST_LANES = 1024;
constexpr int ZC_ST_MAX_THREADS = 128;

struct SplitArgs {
  const uint32_t* planes[ZC_ST_MAX_PLANES];  // the chunk's points, each (12, N), Z in {0, one}
  const int32_t* digits;                     // (M, N), |d| descending per row, |d| < nb
  const int32_t* order;                      // (M, N), indices into the planes
  uint32_t* lanes[ZC_ST_MAX_PLANES];         // each (12, M, 1024): the lane totals
  uint32_t* slots[ZC_ST_MAX_PLANES];         // each (12, M, nb): the in-lane prefixes at the picks
  uint32_t* out[ZC_ST_MAX_PLANES];           // each (12, M)
  uint32_t* scratch;                         // the tail's: M * (2 * S + 2 * nb) points
  int N, nb, S;  // S: entries of the tail's scan / tree area, a power of two >= T, nb - 1
  long long M;
};

ZC_HD int st_abs(int v) { return v < 0 ? -v : v; }

// Point i of a (12, count) array of planes, as a value; and back (canonical).
template <class E>
ZC_HD Jac<E> st_get(const uint32_t* const* planes, long long count, long long i) {
  return jac_gather<E>([&](int k, int w) { return planes[k][w * count + i]; });
}
template <class E>
ZC_HD void st_put(uint32_t* const* planes, long long count, long long i, const Jac<E>& q) {
  jac_scatter(q, [&](int k, int w, uint32_t x) { planes[k][w * count + i] = x; });
}

// #{i : |d_i| >= t} of row m by bisection (t = 1: the non-zero count).
ZC_HD int st_count(const SplitArgs& a, long long m, int t) {
  const int32_t* dg = a.digits + m * a.N;
  int lo = 0, hi = a.N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (st_abs(dg[mid]) >= t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The slot of position p < nnz of row m if p is a pick, else -1: p is
// c_t - 1 for t in (|d_p+1|, |d_p|] when |d_p| > |d_p+1| (d_N = 0).
ZC_HD int st_pick(const SplitArgs& a, long long m, int p) {
  const int32_t* dg = a.digits + m * a.N;
  const int v = st_abs(dg[p]);
  const int next = p + 1 < a.N ? st_abs(dg[p + 1]) : 0;
  return v > next && v < a.nb ? v : -1;
}

// ---------------------------------------------------------------- lane pass
// Lane vl of program m: its in-lane prefixes down to the row's first zero
// digit, the one at each pick to its slot, the last to the lane totals; and,
// for vl < nb, slot vl <- the identity unless a pick has magnitude vl.
template <class E>
ZC_HD void sl_lane(const SplitArgs& a, long long m, int vl) {
  const int D = a.N / ZC_ST_LANES;
  const int32_t* dg = a.digits + m * a.N;
  const int32_t* od = a.order + m * a.N;
  Jac<E> run = jac_identity<E>();
  if (vl < a.nb) {
    const int c = vl ? st_count(a, m, vl) : 0;
    if (c == 0 || st_abs(dg[c - 1]) != vl) st_put<E>(a.slots, a.M * a.nb, m * a.nb + vl, run);
  }
#pragma unroll 1
  for (int p = vl * D; p < vl * D + D && dg[p] != 0; ++p) {
    Jac<E> q = st_get<E>(a.planes, a.N, od[p]);
    if (dg[p] < 0) q.y = E::neg(q.y);
    run = p == vl * D ? q : jac_madd(run, q);
    const int v = st_pick(a, m, p);
    if (v >= 0) st_put<E>(a.slots, a.M * a.nb, m * a.nb + v, run);
  }
  st_put<E>(a.lanes, a.M * ZC_ST_LANES, m * ZC_ST_LANES + vl, run);
}

// ---------------------------------------------------------------- the tail
// Scratch of program m: two scan / tree areas of S points (a ping-pong
// pair for the scan), then the segment-relative lane offsets (nb points, at
// the slot of a lane's first pick), then the picks (nb points), each point
// 3 * E::W words.
template <class E>
ZC_HD uint32_t* st_area(const SplitArgs& a, long long m, int buf, int i) {
  return a.scratch + (m * (2LL * a.S + 2LL * a.nb) + (long long)buf * a.S + i) * (3 * E::W);
}
template <class E>
ZC_HD uint32_t* st_rel(const SplitArgs& a, long long m, int v) {
  return st_area<E>(a, m, 2, v);
}
template <class E>
ZC_HD uint32_t* st_picked(const SplitArgs& a, long long m, int v) {
  return st_area<E>(a, m, 2, a.nb + v);
}

template <class E>
ZC_HD Jac<E> st_ld(const uint32_t* x) {
  return jac_gather<E>([&](int k, int w) { return x[k * 12 + w]; });
}
template <class E>
ZC_HD void st_st(uint32_t* x, const Jac<E>& p) {
  jac_scatter(p, [&](int k, int w, uint32_t v) { x[k * 12 + w] = v; });
}

// Lanes a thread folds: L = ceil(nl / T) of the nl = ceil(nnz / D) lanes
// that hold non-zero digits; thread t takes [t*L, t*L + L).
ZC_HD int st_len(const SplitArgs& a, int nnz, int T) {
  const int D = a.N / ZC_ST_LANES;
  const int nl = (nnz + D - 1) / D;
  return (nl + T - 1) / T;
}

// The slot of the first pick of lane `lane` (positions below nnz), or -1.
ZC_HD int st_first_pick(const SplitArgs& a, long long m, int nnz, int lane) {
  const int D = a.N / ZC_ST_LANES;
  for (int p = lane * D; p < lane * D + D && p < nnz; ++p) {
    const int v = st_pick(a, m, p);
    if (v >= 0) return v;
  }
  return -1;
}

// Phase 1: thread t folds the totals of its lanes, noting the fold so far
// at the first pick of each lane that holds one; its segment's total goes
// to area 0, entry t.
template <class E>
ZC_HD void st_fold(const SplitArgs& a, long long m, int nnz, int t, int T) {
  const int D = a.N / ZC_ST_LANES;
  const int len = st_len(a, nnz, T), nl = (nnz + D - 1) / D;
  Jac<E> rel = jac_identity<E>();
#pragma unroll 1
  for (int lane = t * len; lane < t * len + len && lane < nl; ++lane) {
    const int v = st_first_pick(a, m, nnz, lane);
    if (v >= 0) st_st<E>(st_rel<E>(a, m, v), rel);
    rel = jac_add(rel, st_get<E>(a.lanes, a.M * ZC_ST_LANES, m * ZC_ST_LANES + lane));
  }
  st_st<E>(st_area<E>(a, m, 0, t), rel);
}

// Phase 2, one level k (d = 2^k < T) of the inclusive scan of the T segment
// totals, from area k % 2 into area (k + 1) % 2: entry t <- entry t - d plus
// entry t where t >= d.  After log2 T levels, area (log2 T) % 2 holds it.
template <class E>
ZC_HD void st_scan(const SplitArgs& a, long long m, int k, int t) {
  const int d = 1 << k;
  Jac<E> x = st_ld<E>(st_area<E>(a, m, k & 1, t));
  if (t >= d) x = jac_add(st_ld<E>(st_area<E>(a, m, k & 1, t - d)), x);
  st_st<E>(st_area<E>(a, m, (k + 1) & 1, t), x);
}

// Phase 3: the picks, slots v = t + 1, t + 1 + T, ...: where a position p
// has |d_p| = v > |d_p+1|, its lane's offset is the sum of the segments
// before the lane's (the scan's entry before it) plus the lane's noted fold,
// and the pick is that offset plus the lane pass's in-lane prefix at p.
// Every thread with a pick adds in step with the others of its warp.
template <class E>
ZC_HD void st_picks(const SplitArgs& a, long long m, int nnz, int scan_buf,
                    int t, int T) {
  const int D = a.N / ZC_ST_LANES;
  const int len = st_len(a, nnz, T);
#pragma unroll 1
  for (int v = t + 1; v < a.nb; v += T) {
    const int c = st_count(a, m, v);
    if (c == 0 || st_abs(a.digits[m * a.N + c - 1]) != v) continue;
    const int lane = (c - 1) / D, seg = lane / len;
    Jac<E> off = st_ld<E>(st_rel<E>(a, m, st_first_pick(a, m, nnz, lane)));
    if (seg > 0) off = jac_add(st_ld<E>(st_area<E>(a, m, scan_buf, seg - 1)), off);
    st_st<E>(st_picked<E>(a, m, v),
             jac_add(off, st_get<E>(a.slots, a.M * a.nb, m * a.nb + v)));
  }
}

// Phase 4: area 0, entry b <- bucket b + 1's pick (that of magnitude |d| at
// position c_(b+1) - 1), the identity where c_(b+1) = 0 and for b >= nb - 1.
template <class E>
ZC_HD void st_buckets(const SplitArgs& a, long long m, int t, int T) {
  constexpr int PW = 3 * E::W;
  for (int b = t; b < a.S; b += T) {
    uint32_t* x = st_area<E>(a, m, 0, b);
    const int c = b + 1 < a.nb ? st_count(a, m, b + 1) : 0;
    const int v = c ? st_abs(a.digits[m * a.N + c - 1]) : 0;
    if (c == 0 || v >= a.nb) {
      st_st<E>(x, jac_identity<E>());
    } else {
      const uint32_t* y = st_picked<E>(a, m, v);
      for (int j = 0; j < PW; ++j) x[j] = y[j];
    }
  }
}

// Phase 5, one level of the bucket tree in area 0: entry i += entry i + h,
// i < h.
template <class E>
ZC_HD void st_tree(const SplitArgs& a, long long m, int h, int t, int T) {
#pragma unroll 1
  for (int i = t; i < h; i += T)
    st_st<E>(st_area<E>(a, m, 0, i),
             jac_add(st_ld<E>(st_area<E>(a, m, 0, i)), st_ld<E>(st_area<E>(a, m, 0, i + h))));
}

template <class E>
ZC_HD void st_write(const SplitArgs& a, long long m) {
  st_put<E>(a.out, a.M, m, st_ld<E>(st_area<E>(a, m, 0, 0)));
}

// The area that holds the scan of T segment totals: log2 T levels from area 0.
ZC_HD int st_scan_buf(int T) {
  int k = 0;
  while ((1 << k) < T) ++k;
  return k & 1;
}

#ifdef __CUDACC__
namespace {

constexpr int ZC_SL_THREADS = 128;  // lanes a CTA of the lane pass

template <class E>
__global__ void __launch_bounds__(ZC_SL_THREADS) split_lanes_kernel(SplitArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.M * ZC_ST_LANES) return;
  sl_lane<E>(a, i / ZC_ST_LANES, (int)(i % ZC_ST_LANES));
}

template <class E>
__global__ void __launch_bounds__(ZC_ST_MAX_THREADS) split_tail_kernel(SplitArgs a) {
  const long long m = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const int nnz = st_count(a, m, 1);
  st_fold<E>(a, m, nnz, t, T);
  __syncthreads();
  for (int k = 0; (1 << k) < T; ++k) {
    st_scan<E>(a, m, k, t);
    __syncthreads();
  }
  st_picks<E>(a, m, nnz, st_scan_buf(T), t, T);
  __syncthreads();
  st_buckets<E>(a, m, t, T);
  __syncthreads();
  for (int h = a.S >> 1; h >= 1; h >>= 1) {
    st_tree<E>(a, m, h, t, T);
    __syncthreads();
  }
  if (t == 0) st_write<E>(a, m);
}

bool st_bad(int N, long long M, int nb) {
  return N < ZC_ST_LANES || N % ZC_ST_LANES || M < 1 || M * ZC_ST_LANES > 0x7fffffffLL ||
         nb < 2 || nb > ZC_ST_LANES;
}

}  // namespace

// g2: 0 for G1 (3 planes a point), 1 for G2 (6).  planes: the chunk's points,
// (12, N) words each, Z in {0, one}; digits, order: (M, N) int32, |digit|
// descending and below nb along each row; lanes, slots: the outputs, (12, M,
// 1024) and (12, M, nb) words each.  N: a multiple of 1024; nb: 2 .. 1024.
// Returns the CUDA launch error.
extern "C" int zc_split_lanes(int g2, const void* const* planes, const void* digits,
                              const void* order, void* const* lanes, void* const* slots,
                              int N, long long M, int nb, void* stream) {
  if (st_bad(N, M, nb)) return (int)cudaErrorInvalidValue;
  const int np = g2 ? 6 : 3;
  SplitArgs a = {};
  for (int k = 0; k < np; ++k) {
    a.planes[k] = (const uint32_t*)planes[k];
    a.lanes[k] = (uint32_t*)lanes[k];
    a.slots[k] = (uint32_t*)slots[k];
  }
  a.digits = (const int32_t*)digits;
  a.order = (const int32_t*)order;
  a.N = N;
  a.nb = nb;
  a.M = M;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(M * ZC_ST_LANES / ZC_SL_THREADS);
  if (g2) split_lanes_kernel<Fq2E><<<blocks, ZC_SL_THREADS, 0, s>>>(a);
  else split_lanes_kernel<FqE><<<blocks, ZC_SL_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// lanes, slots: zc_split_lanes's outputs; digits: (M, N) int32 as there; out:
// (12, M) words each; scratch: M * (2 * S + 2 * nb) points (times 36 * ncomp
// words).  threads: a power of two, 1 .. 128; S: a power of two >= threads
// and >= nb - 1.  Returns the CUDA launch error.
extern "C" int zc_split_tail(int g2, const void* const* lanes, const void* const* slots,
                             const void* digits, void* const* out, void* scratch,
                             int N, long long M, int nb, int threads, int S,
                             void* stream) {
  if (st_bad(N, M, nb) || threads < 1 || threads > ZC_ST_MAX_THREADS ||
      (threads & (threads - 1)) || S < threads || S < nb - 1 || (S & (S - 1)))
    return (int)cudaErrorInvalidValue;
  const int np = g2 ? 6 : 3;
  SplitArgs a = {};
  for (int k = 0; k < np; ++k) {
    a.lanes[k] = (uint32_t*)lanes[k];
    a.slots[k] = (uint32_t*)slots[k];
    a.out[k] = (uint32_t*)out[k];
  }
  a.digits = (const int32_t*)digits;
  a.scratch = (uint32_t*)scratch;
  a.N = N;
  a.nb = nb;
  a.S = S;
  a.M = M;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2) split_tail_kernel<Fq2E><<<(unsigned)M, threads, 0, s>>>(a);
  else split_tail_kernel<FqE><<<(unsigned)M, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
