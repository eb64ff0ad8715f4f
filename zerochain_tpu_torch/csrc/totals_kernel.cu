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
// Design: one CTA per program, T threads.  Thread t owns the run
// [t*len, (t+1)*len) of sorted positions (of the row's non-zero prefix,
// found by bisection) and
//   1. loads its points BY INDEX through `order` (no sorted copy of the
//      chunk exists), negates Y where the digit is negative, and scans the
//      run with mixed adds, adding (|d_pos| - |d_pos+1|) * running sum to a
//      local total at every drop (a drop of k > 1 costs a k-fold
//      double-and-add, k <= 2^(c-1));
//   2. the run totals are scanned across the block through shared memory
//      (Hillis-Steele, full adds), which gives every thread the sum of all
//      earlier runs, its offset;
//   3. the thread's contribution is local + (|d_first| - |d_next_first|) *
//      offset, and a tree reduction through shared memory adds them up.
// No atomics and no buckets in memory: zero-heavy digits only shorten runs.
//
// The per-thread steps are plain functions of (program, thread index), so
// the same code can be stepped through on a CPU, thread by thread, without
// the CUDA toolkit.
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

// Shared-memory point store, word-major so that a warp's accesses to one
// word fall into 32 different banks.
template <class E>
ZC_HD void sh_store(uint32_t* sh, int T, int tid, const uint32_t* pt) {
  for (int w = 0; w < 3 * E::W; ++w) sh[w * T + tid] = pt[w];
}
template <class E>
ZC_HD void sh_load(uint32_t* pt, const uint32_t* sh, int T, int tid) {
  for (int w = 0; w < 3 * E::W; ++w) pt[w] = sh[w * T + tid];
}

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

// Step 1: scan this thread's run.  run <- sum of its points, local <- its
// weighted prefix sums, *mrun <- weight of everything before the run.
template <class E>
ZC_HD void totals_scan_run(const TotalsArgs& a, long long m, int tid, int T,
                           uint32_t* run, uint32_t* local, int* mrun) {
  constexpr int W = E::W;
  constexpr int NP = 3 * W / 12;
  const int N = a.N;
  const int32_t* dg = a.digits + m * N;
  const int32_t* od = a.order + m * N;
  // The row is sorted by magnitude, so its non-zero digits are a prefix:
  // find its length by bisection and share only that prefix among the
  // threads (witness scalars leave most digits zero).
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (dg[mid] != 0) lo = mid + 1; else hi = mid;
  }
  const int nnz = lo;
  const int len = (nnz + T - 1) / T;
  const long long start = (long long)tid * len < nnz ? (long long)tid * len : nnz;
  const long long end = start + len < nnz ? start + len : nnz;
  jac_set_identity<E>(run);
  jac_set_identity<E>(local);
  const int first = start < N ? zc_abs(dg[start]) : 0;
  const int next_first = end < N ? zc_abs(dg[end]) : 0;
  *mrun = first - next_first;
  uint32_t q[3 * W], tmp[3 * W];
  for (long long pos = start; pos < end; ++pos) {
    const int d = dg[pos];
    const int mag = zc_abs(d);
    if (mag == 0) break;  // sorted: the rest of the row is zero
    const long long idx = od[pos];
    for (int k = 0; k < NP; ++k)
      for (int w = 0; w < 12; ++w) q[k * 12 + w] = a.planes[k][(long long)w * N + idx];
    if (d < 0) E::neg(q + W, q + W);
    jac_madd<E>(run, run, q);
    const int next_mag = pos + 1 < N ? zc_abs(dg[pos + 1]) : 0;
    const int drop = mag - next_mag;
    if (drop == 1) {
      jac_add<E>(local, local, run);
    } else if (drop > 1) {
      jac_small_mul<E>(tmp, run, drop);
      jac_add<E>(local, local, tmp);
    }
  }
}

// Step 3: contribution = local + mrun * offset.
template <class E>
ZC_HD void totals_contribution(uint32_t* contrib, const uint32_t* local,
                               const uint32_t* offset, int mrun) {
  if (mrun <= 0 || jac_is_identity<E>(offset)) {
    jac_copy<E>(contrib, local);
    return;
  }
  uint32_t tmp[3 * E::W];
  jac_small_mul<E>(tmp, offset, mrun);
  jac_add<E>(contrib, local, tmp);
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
__global__ void __launch_bounds__(128)
totals_kernel(TotalsArgs a) {
  extern __shared__ uint32_t sh[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const long long m = blockIdx.x;
  uint32_t run[3 * E::W], local[3 * E::W], other[3 * E::W];
  int mrun;
  totals_scan_run<E>(a, m, tid, T, run, local, &mrun);

  // inclusive scan of the run totals across the block
  sh_store<E>(sh, T, tid, run);
  __syncthreads();
  for (int s = 1; s < T; s <<= 1) {
    if (tid >= s) sh_load<E>(other, sh, T, tid - s);
    __syncthreads();
    if (tid >= s) {
      jac_add<E>(run, other, run);
      sh_store<E>(sh, T, tid, run);
    }
    __syncthreads();
  }
  if (tid > 0) sh_load<E>(other, sh, T, tid - 1);
  else jac_set_identity<E>(other);
  __syncthreads();

  totals_contribution<E>(run, local, other, mrun);
  sh_store<E>(sh, T, tid, run);
  __syncthreads();
  for (int s = T >> 1; s > 0; s >>= 1) {
    if (tid < s) {
      sh_load<E>(other, sh, T, tid + s);
      jac_add<E>(run, run, other);
      sh_store<E>(sh, T, tid, run);
    }
    __syncthreads();
  }
  if (tid == 0) totals_write<E>(a, m, run);
}

}  // namespace

// g2: 0 for G1 (3 planes), 1 for G2 (6 planes).  planes/out: coordinate
// planes of the chunk's points ((12, N) words each, Z in {0, one}) and of the
// result ((12, M) each).  digits, order: (M, N) int32.  threads: a power of
// two, at most 128.  Returns the CUDA launch error.
extern "C" int zc_window_totals(int g2, const void* const* planes,
                                const void* digits, const void* order,
                                void* const* out, int N, long long M,
                                int threads, void* stream) {
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
  if (threads < 1 || threads > 128 || (threads & (threads - 1))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t words = g2 ? 3 * Fq2E::W : 3 * FqE::W;
  const size_t shmem = words * threads * sizeof(uint32_t);
  if (g2) totals_kernel<Fq2E><<<(unsigned)M, threads, shmem, s>>>(a);
  else totals_kernel<FqE><<<(unsigned)M, threads, shmem, s>>>(a);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
