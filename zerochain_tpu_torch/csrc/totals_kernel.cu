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
//      chunk exists), negates Y where the digit is negative, and runs down
//      its slice with mixed adds, adding (|d_pos| - |d_pos+1|) * running sum
//      to a local total at every drop (|d_last| at its last position; a drop
//      of k > 1 costs a k-fold double-and-add, k <= 2^(c-1));
//   2. the locals are summed: a butterfly of warp shuffles, then the warps
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
  const int32_t* digits;                  // (M, N), |d| descending per row
  const int32_t* order;                   // (M, N), indices into the planes
  uint32_t* out[ZC_MAX_PLANES];           // each (12, M)
  int N;
  long long M;
};

ZC_HD int zc_abs(int v) { return v < 0 ? -v : v; }

// r = k * p for 1 <= k (MSB-first double-and-add).  r must not alias p.
template <class E>
ZC_HD void jac_small_mul(uint32_t* r, const uint32_t* p, int k) {
  int top = 30;
  while (!((k >> top) & 1)) --top;
  jac_copy<E>(r, p);
  for (int b = top - 1; b >= 0; --b) {
    jac_double<E>(r, r);
    if ((k >> b) & 1) jac_add<E>(r, r, p);
  }
}

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

// Step 1: thread t of T on row m (nnz non-zero digits): local <- the sum
// over its slice of drop * running sum, the last drop being |d_last|.
template <class E>
ZC_HD void totals_slice(const TotalsArgs& a, long long m, int nnz, int t,
                        int T, uint32_t* local) {
  constexpr int W = E::W;
  constexpr int NP = 3 * W / 12;
  const int N = a.N;
  const int32_t* dg = a.digits + m * N;
  const int32_t* od = a.order + m * N;
  const int len = (nnz + T - 1) / T;
  const long long start = (long long)t * len < nnz ? (long long)t * len : nnz;
  const long long end = start + len < nnz ? start + len : nnz;
  uint32_t run[3 * W], q[3 * W], tmp[3 * W];
  jac_set_identity<E>(run);
  jac_set_identity<E>(local);
  for (long long pos = start; pos < end; ++pos) {
    const int d = dg[pos];
    const long long idx = od[pos];
    for (int k = 0; k < NP; ++k)
      for (int w = 0; w < 12; ++w) q[k * 12 + w] = a.planes[k][(long long)w * N + idx];
    if (d < 0) E::neg(q + W, q + W);
    jac_madd<E>(run, run, q);
    const int drop = zc_abs(d) - (pos + 1 < end ? zc_abs(dg[pos + 1]) : 0);
    if (drop == 1) {
      jac_add<E>(local, local, run);
    } else if (drop > 1) {
      jac_small_mul<E>(tmp, run, drop);
      jac_add<E>(local, local, tmp);
    }
  }
}

template <class E>
ZC_HD void totals_write(const TotalsArgs& a, long long m, const uint32_t* pt) {
  constexpr int NP = 3 * E::W / 12;
  for (int k = 0; k < NP; ++k)
    for (int w = 0; w < 12; ++w) a.out[k][(long long)w * a.M + m] = pt[k * 12 + w];
}

#ifdef __CUDACC__
namespace {

template <class E>
__global__ void __launch_bounds__(32)
totals_kernel(TotalsArgs a, uint32_t* part, int* done, int min_run) {
  constexpr int PW = 3 * E::W;
  const long long m = blockIdx.x / ZC_K3_WARPS;
  const int k = blockIdx.x % ZC_K3_WARPS, lane = threadIdx.x;
  const int nnz = totals_nnz(a, m);
  const int warps = totals_row_warps(nnz, min_run);
  if (k >= warps) return;
  uint32_t local[PW], other[PW];
  totals_slice<E>(a, m, nnz, k * 32 + lane, 32 * warps, local);
  for (int s = 1; s < 32; s <<= 1) {
    for (int w = 0; w < PW; ++w) other[w] = __shfl_xor_sync(0xffffffffu, local[w], s);
    jac_add<E>(local, local, other);
  }
  if (lane != 0) return;
  if (warps == 1) {
    totals_write<E>(a, m, local);
    return;
  }
  uint32_t* mine = part + (m * ZC_K3_WARPS + k) * PW;
  for (int w = 0; w < PW; ++w) mine[w] = local[w];
  __threadfence();
  if (atomicAdd(done + m, 1) != warps - 1) return;
  __threadfence();  // the last warp of the row sums the parts in order
  const uint32_t* row = part + m * ZC_K3_WARPS * PW;
  for (int w = 0; w < PW; ++w) local[w] = __ldcg(row + w);
  for (int j = 1; j < warps; ++j) {
    for (int w = 0; w < PW; ++w) other[w] = __ldcg(row + j * PW + w);
    jac_add<E>(local, local, other);
  }
  totals_write<E>(a, m, local);
}

}  // namespace

// g2: 0 for G1 (3 planes), 1 for G2 (6 planes).  planes/out: coordinate
// planes of the chunk's points ((12, N) words each, Z in {0, one}) and of the
// result ((12, M) each).  digits, order: (M, N) int32.  part: scratch of
// M * 4 points (M * 4 * 3 * 12 * ncomp words); done: M int32 zeros.
// min_run: non-zero digits per thread at least before a row takes more
// warps.  Returns the CUDA launch error.
extern "C" int zc_window_totals(int g2, const void* const* planes,
                                const void* digits, const void* order,
                                void* const* out, void* part, void* done,
                                int N, long long M, int min_run, void* stream) {
  const int np = g2 ? 6 : 3;
  TotalsArgs a;
  for (int k = 0; k < ZC_MAX_PLANES; ++k) {
    a.planes[k] = k < np ? (const uint32_t*)planes[k] : nullptr;
    a.out[k] = k < np ? (uint32_t*)out[k] : nullptr;
  }
  a.digits = (const int32_t*)digits;
  a.order = (const int32_t*)order;
  a.N = N;
  a.M = M;
  if (min_run < 1 || M < 1 || M * ZC_K3_WARPS > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(M * ZC_K3_WARPS);
  uint32_t* pt = (uint32_t*)part;
  int* dn = (int*)done;
  if (g2) totals_kernel<Fq2E><<<blocks, 32, 0, s>>>(a, pt, dn, min_run);
  else totals_kernel<FqE><<<blocks, 32, 0, s>>>(a, pt, dn, min_run);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
