// The bucket ('hs') MSM's kernels over G1 or G2 points.
//
// zc_hs_bucket_sums: for each row m = (window, proof) of a chunk's sorted
// digits keys[m, :] with their permutation order[m, :], the bucket sums
//   bucket[m, v] = sum of P[order[m, i]] over the positions i with key v,
// v = 1 .. nb - 1, as Jacobian points; empty buckets and bucket 0 are the
// identity.
//
// Replaces: zerochain_tpu/ec/pallas_ec.py, `add2sel_kernel` (built by
// `build_add2sel`, public wrapper hs_add_select), with the composition the
// JAX `Msm` builds around it (zerochain_tpu/msm/pippenger.py: the sorted copy,
// log2(N) Hillis-Steele levels of that kernel, the scatter into buckets).
// The JAX package takes Hillis-Steele for the TPU compiler's sake (one Mosaic
// compile) at N log N adds; nothing of that layout is needed here.
//
// Bound on this card: integer operations.  A row costs one full Jacobian add
// (16 Fq multiplies for G1, 43 for G2) per non-zero digit that is not the
// first of its bucket; the bytes are the chunk's points, the digits and the
// order once, and the buckets written once.
//
// Design (one CTA per row, T threads, like K3 in totals_kernel.cu):
//   0. the threads fill the row's nb buckets with the identity;
//   1. bisection finds the row's non-zero digits [lo, hi) (bucket 0 is never
//      touched); thread t takes the slice [lo + t*S, lo + (t+1)*S) of it,
//      S = ceil((hi - lo) / T), loads its points BY INDEX through `order` (no
//      sorted copy, no rolled level; the chunk's points stay in L2) and folds
//      each run of equal digits with the full jac_add (the Msm takes any
//      Jacobian point, Z is not assumed in {0, 1}).  A run piece that lies
//      wholly inside the slice is its bucket and is written there; the piece
//      at the slice's head that continues a run of the previous slice goes to
//      the thread's carry slot 0, the piece at its tail that continues into the
//      next slice to slot 1 (a slice of one continuing run: slot 0);
//   2. after a barrier, the thread whose slot 1 holds the start of a run adds
//      the slot-0 pieces of the following slices in slice order until the run
//      ends, and writes the bucket.
// Each point costs one add (the Hillis-Steele levels add a point about log2
// of its run's length times); a run of L points costs S + L/S adds on the
// critical path, so a heavy bucket (the witness's booleans all land in bucket
// 1 of window 0) spans a few slices and sets no thread's time.
//
// zc_hs_add_select: one level of a segmented Hillis-Steele scan, one thread
// per point: out[i] = (f[i] | keep[i]) ? x[i] : add(xl[i], x[i]), where xl is
// x shifted by the level's distance, f marks segment starts and keep marks
// positions with no left neighbour at that distance.  The port of
// `add2sel_kernel` itself; the Msm no longer runs it.  It skips the add where
// the select keeps x, which gives the TPU kernel's words.
//
// The adds are jacobian.cuh's, on values: the running piece, the loaded
// point and the add's temporaries in registers, the multiply out of line on
// values.  Until this form every operand went through a 2,880-byte frame of
// out-of-line functions on pointers; now G1 has none, and G2, whose add
// holds two 72-word points beside its temporaries, spills a few hundred
// bytes (ptxas; PERF.md).  A carry slot or a bucket is written with
// canonical words.
//
// Coordinates arrive as limb-major planes (word w of point i at w*count + i).
// The bucket steps are plain functions of (row, thread), so the same code can
// be stepped through on a CPU, thread by thread, without the CUDA toolkit.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "jacobian.cuh"

constexpr int ZC_BS_MAX_PLANES = 6;  // 3 coordinates x up to 2 components
constexpr int ZC_BS_MAX_THREADS = 128;

struct BucketArgs {
  const uint32_t* planes[ZC_BS_MAX_PLANES];  // the chunk's points, each (12, N)
  const int32_t* keys;                       // (M, N), ascending per row
  const int32_t* order;                      // (M, N), indices into the planes
  uint32_t* out[ZC_BS_MAX_PLANES];           // each (12, M, nb)
  uint32_t* carry;                           // M * T * 2 points
  int N, nb;
  long long M;
};

// The row's positions with a digit in [1, nb): [*lo, *hi), by bisection.
ZC_HD void bs_range(const BucketArgs& a, long long m, int* lo, int* hi) {
  const int32_t* k = a.keys + m * a.N;
  for (int side = 0; side < 2; ++side) {
    const int bar = side ? a.nb : 1;
    int l = 0, h = a.N;
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (k[mid] < bar) l = mid + 1; else h = mid;
    }
    if (side) *hi = l; else *lo = l;
  }
}

// Thread t's slice [*s, *e) of [lo, hi) among T threads (empty past the end).
ZC_HD void bs_bounds(int lo, int hi, int t, int T, int* s, int* e) {
  const long long len = (hi - lo + T - 1) / T;
  const long long s0 = lo + (long long)t * len;
  *s = s0 < hi ? (int)s0 : hi;
  *e = s0 + len < hi ? (int)(s0 + len) : hi;
}

template <class E>
ZC_HD Jac<E> bs_load(const BucketArgs& a, long long idx) {
  return jac_gather<E>([&](int k, int w) { return a.planes[k][(long long)w * a.N + idx]; });
}

template <class E>
ZC_HD void bs_write(const BucketArgs& a, long long m, int v, const Jac<E>& pt) {
  jac_scatter(pt, [&](int k, int w, uint32_t x) {
    a.out[k][((long long)w * a.M + m) * a.nb + v] = x;
  });
}

template <class E>
ZC_HD uint32_t* bs_carry(const BucketArgs& a, long long m, int t, int T, int slot) {
  return a.carry + (((m * T) + t) * 2 + slot) * (3 * E::W);
}

template <class E>
ZC_HD Jac<E> bs_get_carry(const BucketArgs& a, long long m, int t, int T, int slot) {
  const uint32_t* c = bs_carry<E>(a, m, t, T, slot);
  return jac_gather<E>([&](int k, int w) { return c[k * 12 + w]; });
}

template <class E>
ZC_HD void bs_put_carry(const BucketArgs& a, long long m, int t, int T, int slot,
                        const Jac<E>& pt) {
  uint32_t* c = bs_carry<E>(a, m, t, T, slot);
  jac_scatter(pt, [&](int k, int w, uint32_t x) { c[k * 12 + w] = x; });
}

// Step 0: buckets t, t + T, ... of row m <- the identity.
template <class E>
ZC_HD void bs_fill(const BucketArgs& a, long long m, int t, int T) {
  for (int v = t; v < a.nb; v += T) bs_write<E>(a, m, v, jac_identity<E>());
}

// The piece [p0, p1) of the run of `key` in slice [s, e): its bucket, or the
// carry slot 0 (continues a run from before the slice) or 1 (runs on past it).
template <class E>
ZC_HD void bs_flush(const BucketArgs& a, long long m, int t, int T, int lo, int hi,
                    int s, int e, int p0, int p1, int key, const Jac<E>& acc) {
  const int32_t* k = a.keys + m * a.N;
  if (p0 == s && s > lo && k[s - 1] == key) bs_put_carry<E>(a, m, t, T, 0, acc);
  else if (p1 == e && e < hi && k[e] == key) bs_put_carry<E>(a, m, t, T, 1, acc);
  else bs_write<E>(a, m, key, acc);
}

// Step 1: thread t of T folds the runs of its slice.
template <class E>
ZC_HD void bs_slice(const BucketArgs& a, long long m, int lo, int hi, int t, int T) {
  int s, e;
  bs_bounds(lo, hi, t, T, &s, &e);
  if (s >= e) return;
  const int32_t* k = a.keys + m * a.N;
  const int32_t* od = a.order + m * a.N;
  int p0 = s, key = k[s];
  Jac<E> acc = bs_load<E>(a, od[s]);
#pragma unroll 1
  for (int pos = s + 1; pos < e; ++pos) {
    const int kp = k[pos];
    if (kp != key) {
      bs_flush<E>(a, m, t, T, lo, hi, s, e, p0, pos, key, acc);
      acc = bs_load<E>(a, od[pos]);
      p0 = pos;
      key = kp;
    } else {
      acc = jac_add(acc, bs_load<E>(a, od[pos]));
    }
  }
  bs_flush<E>(a, m, t, T, lo, hi, s, e, p0, e, key, acc);
}

// Step 2: if thread t's slot 1 starts a run, the run's bucket is slot 1 plus
// the slot-0 pieces of the following slices, in order.
template <class E>
ZC_HD void bs_merge(const BucketArgs& a, long long m, int lo, int hi, int t, int T) {
  int s, e;
  bs_bounds(lo, hi, t, T, &s, &e);
  if (s >= e || e >= hi) return;
  const int32_t* k = a.keys + m * a.N;
  const int key = k[e - 1];
  if (k[e] != key) return;                                    // no run goes on
  if (s > lo && k[s - 1] == key && k[s] == key) return;       // it began before
  Jac<E> acc = bs_get_carry<E>(a, m, t, T, 1);
#pragma unroll 1
  for (int u = t + 1;; ++u) {
    int su, eu;
    bs_bounds(lo, hi, u, T, &su, &eu);
    acc = jac_add(acc, bs_get_carry<E>(a, m, u, T, 0));
    if (!(eu < hi && k[eu - 1] == key && k[eu] == key)) break;
  }
  bs_write<E>(a, m, key, acc);
}

#ifdef __CUDACC__
namespace {

template <class E>
__global__ void __launch_bounds__(ZC_BS_MAX_THREADS)
bucket_kernel(BucketArgs a) {
  const long long m = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  int lo, hi;
  bs_range(a, m, &lo, &hi);
  bs_fill<E>(a, m, t, T);
  __syncthreads();
  bs_slice<E>(a, m, lo, hi, t, T);
  __syncthreads();  // the carries are in global memory: visible to the block
  bs_merge<E>(a, m, lo, hi, t, T);
}

struct HsArgs {
  const uint32_t* xl[ZC_BS_MAX_PLANES];
  const uint32_t* x[ZC_BS_MAX_PLANES];
  const uint8_t* f;
  const uint8_t* keep;
  uint32_t* out[ZC_BS_MAX_PLANES];
};

template <class E>
__device__ __forceinline__ Jac<E> load_point(const uint32_t* const* planes,
                                             long long count, long long i) {
  return jac_gather<E>([&](int k, int w) { return planes[k][w * count + i]; });
}

template <class E>
__global__ void __launch_bounds__(128)
hs_kernel(HsArgs a, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  Jac<E> R = load_point<E>(a.x, count, i);
  if (!(a.f[i] | a.keep[i])) R = jac_add(load_point<E>(a.xl, count, i), R);
  jac_scatter(R, [&](int k, int w, uint32_t x) { a.out[k][w * count + i] = x; });
}

}  // namespace

// g2: 0 for G1 (3 planes per point), 1 for G2 (6 planes: X.c0, X.c1, Y.c0,
// ...).  planes: the chunk's points, (12, N) words each; keys, order: (M, N)
// int32, keys ascending per row and in [0, nb); out: (12, M, nb) words each;
// carry: scratch of M * threads * 2 points (M * threads * 2 * 36 * ncomp
// words).  threads: 1 .. 128 a row.  Returns the CUDA launch error.
extern "C" int zc_hs_bucket_sums(int g2, const void* const* planes, const void* keys,
                                 const void* order, void* const* out, void* carry,
                                 int N, long long M, int nb, int threads,
                                 void* stream) {
  const int np = g2 ? 6 : 3;
  if (N < 1 || M < 1 || M > 0x7fffffffLL || nb < 1 || threads < 1 ||
      threads > ZC_BS_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  BucketArgs a;
  for (int k = 0; k < ZC_BS_MAX_PLANES; ++k) {
    a.planes[k] = k < np ? (const uint32_t*)planes[k] : nullptr;
    a.out[k] = k < np ? (uint32_t*)out[k] : nullptr;
  }
  a.keys = (const int32_t*)keys;
  a.order = (const int32_t*)order;
  a.carry = (uint32_t*)carry;
  a.N = N;
  a.nb = nb;
  a.M = M;
  cudaStream_t s = (cudaStream_t)stream;
  if (g2) bucket_kernel<Fq2E><<<(unsigned)M, threads, 0, s>>>(a);
  else bucket_kernel<FqE><<<(unsigned)M, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: the planes of xl, then of x, then of the output, each (12, count)
// words.  f, keep: count bytes each, nonzero = set.  Returns the CUDA launch
// error.
extern "C" int zc_hs_add_select(int g2, const void* const* ptrs, const void* f,
                                const void* keep, long long count,
                                void* stream) {
  const int np = g2 ? 6 : 3;
  HsArgs a;
  for (int k = 0; k < ZC_BS_MAX_PLANES; ++k) {
    a.xl[k] = k < np ? (const uint32_t*)ptrs[k] : nullptr;
    a.x[k] = k < np ? (const uint32_t*)ptrs[np + k] : nullptr;
    a.out[k] = k < np ? (uint32_t*)ptrs[2 * np + k] : nullptr;
  }
  a.f = (const uint8_t*)f;
  a.keep = (const uint8_t*)keep;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  if (g2) hs_kernel<Fq2E><<<blocks, threads, 0, s>>>(a, count);
  else hs_kernel<FqE><<<blocks, threads, 0, s>>>(a, count);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
