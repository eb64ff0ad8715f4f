// window_totals: for each (window, proof) program m, the bucket sum
//   out[m] = sum_i d[m,i] * P[order[m,i]]
// over one chunk of N points whose digits d[m,:] arrive sorted by |d|
// descending, as one Jacobian point.  G1 and G2, signed or unsigned digits.
//
// Replaces: zerochain_tpu/msm/pallas_scan.py, `_totals_kernel` (public
// wrapper window_totals).  That kernel walks a column-major sorted COPY of the
// chunk per program, scans it in 1024 virtual lanes, and picks the bucket
// prefixes with one-hot matrix products; none of that layout is needed here.
//
// What is computed: with c[t] = #{i : |d_i| >= t}, the sum equals
// sum_{t>=1} prefix[c[t]-1], where prefix is the inclusive running sum of
// the (sign-applied) sorted points.  Grouping equal prefixes,
//   out = sum_pos (|d_pos| - |d_pos+1|) * prefix[pos],      d_N := 0,
// so only positions where the magnitude drops contribute, and positions
// with digit 0 (the tail) are never touched.
//
// Bound on this card: integer operations.  A program costs one mixed add
// (11 field multiplies) per non-zero digit; the bytes are one 108- or
// 216-byte point per add.
//
// What held it back, in the form on pointers: every mixed add, add and
// double was an out-of-line function on word arrays, and so was the field
// multiply under them, so the running sum, the loaded point, the local
// total and every temporary lived in local memory (ptxas: 3,168-byte
// frames on the add path) and every multiply read its operands through L1
// from there: at 512 threads an SM that is ~1.5 MB of local memory against
// 256 KB of L1.  Now (jacobian.cuh) the formulas are inlined on register
// values and the multiply alone is out of line, called on values (0-byte
// frames on the G1 path).  Second, each drop's add ran where the drop fell:
// the lanes of a warp reach their drops at different steps, so one lane's
// add idled the 31 others (on the prover's digits the drops' adds were a
// fifth of G1's time and two fifths of G2's; PERF.md).  Now the slice is
// walked twice (below): the mixed adds first, storing the running
// sum at each drop, then the drops, a lane's next one in each round, in
// step across the warp.  A G2 point is 72 words: the second walk's adds and
// the warp sums spill in G2 (ptxas); holding their operands in shared
// memory instead removed most of that and made the G2 chunk slower.
//
// Design: thread t of the T threads a row gets owns the slice [t*len,
// (t+1)*len) of the row's non-zero prefix (found by bisection).  Write S_t
// for the sum of its points and L_t for its weighted running sums, with the
// drop of its last position taken against the next slice.  The row's total
// is sum_t (L_t + (|d_first(t)| - |d_first(t+1)|) * O_t) with the offsets
// O_t = sum_{u<t} S_u, which would need a scan across the threads; summed
// over t the second term telescopes to sum_t |d_first(t+1)| * S_t, so
//   total = sum_t (L_t + |d_first(t+1)| * S_t),
// which is what each thread computes ALONE if it takes the drop of its last
// position as |d_last| itself (|d_last| - |d_first(t+1)| + |d_first(t+1)|).
// No scan and no offset: every thread
//   1. loads its points BY INDEX through `order` (no sorted copy of the
//      chunk exists; Z's first word tells infinity from one), negates Y
//      where the digit is negative, and runs down its slice with mixed
//      adds, storing the running sum at every drop to a slot of the row in
//      global scratch (a slot by magnitude, one a thread for its last
//      position) and the drop amount beside it;
//   2. adds (|d_pos| - |d_pos+1|) * stored sum to a local total for each of
//      its drops in position order (|d_last| at its last position; a drop
//      of k > 1 costs a k-fold double-and-add, k <= 2^(c-1)), the warp's
//      lanes a drop each a round;
//   3. the locals are summed: a butterfly of warp shuffles, then the warps
//      of a row through a scratch buffer.
// Threads per row follow the row's non-zero count, not N: one warp for up to
// 32 * min_run non-zero digits, two warps for up to twice that, else four.
// A CTA is one warp, (row, part) = (blockIdx / 4, blockIdx % 4); the warps a
// row does not need end at once, so short rows leave the card's warp slots
// to others.  A row of several warps sums their partials, in part order,
// in the warp that finishes last (a counter per row).  No buckets in memory:
// zero-heavy digits only shorten slices.
//
// The per-thread step and the row's warp count are plain functions of
// (program, thread), so the same code can be stepped through on a CPU,
// thread by thread, without the CUDA toolkit.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "jacobian.cuh"

constexpr int ZC_MAX_PLANES = 6;

struct TotalsArgs {
  const uint32_t* planes[ZC_MAX_PLANES];  // point coordinates, each (12, N)
  const int32_t* digits;                  // (M, N), |d| descending per row, |d| < nb
  const int32_t* order;                   // (M, N), indices into the planes
  uint32_t* out[ZC_MAX_PLANES];           // each (12, M)
  int N, nb;
  long long M;
};

ZC_HD int zc_abs(int v) { return v < 0 ? -v : v; }

constexpr int ZC_K3_WARPS = 4;  // warps of the longest rows

// The length of the row's non-zero prefix (the row is sorted by magnitude).
ZC_HD int totals_nnz(const TotalsArgs& a, long long m) {
  const int32_t* dg = a.digits + m * a.N;
  int lo = 0, hi = a.N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (dg[mid] != 0) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Warps for a row of nnz non-zero digits: 1, 2 or 4.
ZC_HD int totals_row_warps(int nnz, int min_run) {
  const int per_warp = 32 * min_run;
  return nnz <= per_warp ? 1 : nnz <= 2 * per_warp ? 2 : ZC_K3_WARPS;
}

#ifdef __CUDA_ARCH__
#define ZC_K3_ANY(x) __any_sync(0xffffffffu, (x))
#else
#define ZC_K3_ANY(x) (x)
#endif

// Point idx of the chunk's planes.  Z is 0 or one (the prover's points are
// normalised), so its first word tells which, and the other words are not
// read.
template <class E>
ZC_HD Jac<E> totals_point(const TotalsArgs& a, long long idx) {
  Jac<E> q;
#pragma unroll
  for (int j = 0; j < 2 * E::W; ++j) jac_word(q, j) = a.planes[j / 12][(long long)(j % 12) * a.N + idx];
  q.z = a.planes[2 * E::W / 12][idx] ? E::one() : E::zero();
  return q;
}

// Where the drops' running sums wait between the two phases: a row's slots,
// one point each, in global scratch (cached in L1/L2), and the row's drop
// amounts, zero where no drop was stored.  A drop inside a thread's slice
// is at the last position of a magnitude v, which no other slice holds:
// slot v (1 <= v < nb).  The drop at the end of thread t's slice (|d_last|):
// slot nb + t.
template <class E>
struct TotalsSlots {
  uint32_t* rows;  // the row's slots
  int32_t* drops;  // the row's drop amounts, by slot
  ZC_HD void set(int s, const Jac<E>& p) const {
    uint32_t* x = rows + (long long)s * 3 * E::W;
#pragma unroll
    for (int j = 0; j < 3 * E::W; ++j) x[j] = jac_word(p, j);
  }
  ZC_HD Jac<E> get(int s) const {
    const uint32_t* x = rows + (long long)s * 3 * E::W;
    return jac_gather<E>([&](int k, int w) { return x[k * 12 + w]; });
  }
};

// Slots of a row: nb magnitudes and up to 4 warps of threads.
ZC_HOST_HD long long totals_row_slots(int nb) { return (long long)nb + 32 * ZC_K3_WARPS; }

// Step 1: thread t of T on row m (nnz non-zero digits): the running sum
// down its slice, with mixed adds, stored at every drop (the last drop being
// |d_last|, at the slice's end).
template <class E>
ZC_HD void totals_scan(const TotalsArgs& a, long long m, int nnz, int t, int T,
                       const TotalsSlots<E>& sc) {
  const int32_t* dg = a.digits + m * a.N;
  const int32_t* od = a.order + m * a.N;
  const int len = (nnz + T - 1) / T;
  const long long start = (long long)t * len < nnz ? (long long)t * len : nnz;
  const long long end = start + len < nnz ? start + len : nnz;
  Jac<E> run = jac_identity<E>();
#pragma unroll 1
  for (long long pos = start; pos < end; ++pos) {
    const int d = dg[pos];
    Jac<E> q = totals_point<E>(a, od[pos]);
    if (d < 0) q.y = E::neg(q.y);
    run = jac_madd(run, q);
    if (pos + 1 == end) {
      sc.set(a.nb + t, run);
    } else if (zc_abs(d) != zc_abs(dg[pos + 1])) {
      sc.set(zc_abs(d), run);
      sc.drops[zc_abs(d)] = zc_abs(d) - zc_abs(dg[pos + 1]);
    }
  }
}

// Step 2: thread t's local total, the sum over its drops in slice order of
// drop * the stored running sum.  Its internal drops are at the magnitudes
// |d_last| < v <= |d_first| of its slice that the row holds (a stored drop
// amount), taken from the largest, one a round; the warp runs rounds while
// any lane has a magnitude left, so the lanes' adds run together (added at
// its position, one lane's drop idled the 31 others).  Then the drop at the
// slice's end, in step on every lane.
template <class E>
ZC_HD Jac<E> totals_drops(const TotalsArgs& a, long long m, int nnz, int t, int T,
                          const TotalsSlots<E>& sc) {
  const int32_t* dg = a.digits + m * a.N;
  const int len = (nnz + T - 1) / T;
  const long long start = (long long)t * len < nnz ? (long long)t * len : nnz;
  const long long end = start + len < nnz ? start + len : nnz;
  const int hi = start < end ? zc_abs(dg[start]) : 0;
  const int lo = start < end ? zc_abs(dg[end - 1]) : 0;
  Jac<E> local = jac_identity<E>();
#pragma unroll 1
  for (int v = hi; ZC_K3_ANY(v > lo); --v) {
    const int drop = v > lo ? sc.drops[v] : 0;
    if (drop > 0) {
      const Jac<E> r = sc.get(v);
      local = jac_add(local, drop == 1 ? r : jac_small_mul(r, drop));
    }
  }
  if (start < end) {
    const Jac<E> r = sc.get(a.nb + t);
    local = jac_add(local, lo == 1 ? r : jac_small_mul(r, lo));
  }
  return local;
}

template <class E>
ZC_HD void totals_write(const TotalsArgs& a, long long m, const Jac<E>& pt) {
  jac_scatter(pt, [&](int k, int w, uint32_t x) { a.out[k][(long long)w * a.M + m] = x; });
}

#ifdef __CUDACC__
namespace {

template <class E>
__global__ void __launch_bounds__(32)
totals_kernel(TotalsArgs a, uint32_t* part, uint32_t* rows, int32_t* drops, int* done,
              int min_run) {
  constexpr int PW = 3 * E::W;
  const long long m = blockIdx.x / ZC_K3_WARPS;
  const int k = blockIdx.x % ZC_K3_WARPS, lane = threadIdx.x;
  const int nnz = totals_nnz(a, m);
  const int warps = totals_row_warps(nnz, min_run);
  if (k >= warps) return;
  const int t = k * 32 + lane, T = 32 * warps;
  const TotalsSlots<E> sc{rows + m * totals_row_slots(a.nb) * PW,
                          drops + m * totals_row_slots(a.nb)};
  totals_scan<E>(a, m, nnz, t, T, sc);
  Jac<E> local = jac_canon(totals_drops<E>(a, m, nnz, t, T, sc));
#pragma unroll 1
  for (int s = 1; s < 32; s <<= 1) local = jac_canon(jac_add(local, jac_shfl_xor(local, s)));
  if (lane != 0) return;
  if (warps == 1) {
    totals_write<E>(a, m, local);
    return;
  }
  uint32_t* mine = part + (m * ZC_K3_WARPS + k) * PW;
#pragma unroll
  for (int j = 0; j < PW; ++j) mine[j] = jac_word(local, j);
  __threadfence();
  if (atomicAdd(done + m, 1) != warps - 1) return;
  __threadfence();  // the last warp of the row sums the parts in order
  const uint32_t* row = part + m * ZC_K3_WARPS * PW;
  local = jac_gather<E>([&](int kk, int w) { return __ldcg(row + kk * 12 + w); });
#pragma unroll 1
  for (int j = 1; j < warps; ++j)
    local = jac_add(local, jac_gather<E>([&](int kk, int w) {
              return __ldcg(row + j * PW + kk * 12 + w);
            }));
  totals_write<E>(a, m, local);
}

}  // namespace

// Words of the scratch `part` that zc_window_totals needs for M rows and
// digits below nb: 4 partial points a row, the rows' drop slots, then their
// drop amounts.
template <class E>
long long totals_part_words(long long M, int nb) {
  constexpr long long PW = 3 * E::W;
  return M * ZC_K3_WARPS * PW + M * totals_row_slots(nb) * (PW + 1);
}

extern "C" long long zc_window_totals_part_words(int g2, long long M, int nb) {
  return g2 ? totals_part_words<Fq2E>(M, nb) : totals_part_words<FqE>(M, nb);
}

template <class E>
cudaError_t totals_launch(const TotalsArgs& a, uint32_t* part, int* done, int min_run,
                          cudaStream_t s) {
  constexpr long long PW = 3 * E::W;
  const long long M = a.M;
  uint32_t* rows = part + M * ZC_K3_WARPS * PW;
  int32_t* drops = (int32_t*)(rows + M * totals_row_slots(a.nb) * PW);
  const cudaError_t e = cudaMemsetAsync(drops, 0, M * totals_row_slots(a.nb) * sizeof(int32_t), s);
  if (e != cudaSuccess) return e;
  totals_kernel<E><<<(unsigned)(M * ZC_K3_WARPS), 32, 0, s>>>(a, part, rows, drops, done,
                                                              min_run);
  return cudaGetLastError();
}

// g2: 0 for G1 (3 planes), 1 for G2 (6 planes).  planes/out: coordinate
// planes of the chunk's points ((12, N) words each, Z in {0, one}) and of the
// result ((12, M) each).  digits, order: (M, N) int32, |digit| < nb.  part:
// scratch of zc_window_totals_part_words(g2, M, nb) words; done: M int32
// zeros.  min_run: non-zero digits per thread at least before a row takes
// more warps.  Returns the CUDA launch error.
extern "C" int zc_window_totals(int g2, const void* const* planes,
                                const void* digits, const void* order,
                                void* const* out, void* part, void* done,
                                int N, long long M, int nb, int min_run, void* stream) {
  const int np = g2 ? 6 : 3;
  TotalsArgs a;
  for (int k = 0; k < ZC_MAX_PLANES; ++k) {
    a.planes[k] = k < np ? (const uint32_t*)planes[k] : nullptr;
    a.out[k] = k < np ? (uint32_t*)out[k] : nullptr;
  }
  a.digits = (const int32_t*)digits;
  a.order = (const int32_t*)order;
  a.N = N;
  a.nb = nb;
  a.M = M;
  if (min_run < 1 || M < 1 || nb < 2 || M * ZC_K3_WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(g2 ? totals_launch<Fq2E>(a, (uint32_t*)part, (int*)done, min_run, s)
                  : totals_launch<FqE>(a, (uint32_t*)part, (int*)done, min_run, s));
}
#endif  // __CUDACC__
