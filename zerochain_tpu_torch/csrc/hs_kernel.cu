// hs_add_select: one level of a segmented Hillis-Steele scan over G1 or G2
// points, one thread per point:
//   out[i] = (f[i] | keep[i]) ? x[i] : add(xl[i], x[i])
// where xl is x shifted by the level's distance, f marks segment starts and
// keep marks positions with no left neighbour at that distance.
//
// Replaces: zerochain_tpu/ec/pallas_ec.py, `add2sel_kernel` (built by
// `build_add2sel`, public wrapper hs_add_select).
//
// Bound on this card: integer operations.  A G1 add is 16 Fq multiplies
// (4,800 32-bit multiply-adds) for 9*48 bytes of points and two mask bytes
// moved; a G2 add is 43 Fq multiplies for twice the bytes.
//
// Design: the step is the full Jacobian add (jac_add of jacobian.cuh): an HS
// level adds two partial sums, so neither operand has Z in {0, 1}.  The TPU
// kernel computes the add everywhere and selects; a thread here skips the add
// where the select keeps x, which gives the same words.  Coordinates arrive
// as limb-major planes (word w of point i at w*count + i), so loads and
// stores are coalesced.
#include <cuda_runtime.h>

#include "jacobian.cuh"

namespace {

constexpr int MAX_PLANES = 6;  // 3 coordinates x up to 2 components

struct HsArgs {
  const uint32_t* xl[MAX_PLANES];
  const uint32_t* x[MAX_PLANES];
  const uint8_t* f;
  const uint8_t* keep;
  uint32_t* out[MAX_PLANES];
};

template <class E>
__device__ void load_point(uint32_t* dst, const uint32_t* const* planes,
                           long long count, long long i) {
  constexpr int NP = 3 * E::W / 12;
  for (int k = 0; k < NP; ++k)
    for (int w = 0; w < 12; ++w) dst[k * 12 + w] = planes[k][w * count + i];
}

template <class E>
__global__ void __launch_bounds__(128)
hs_kernel(HsArgs a, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  constexpr int NP = 3 * E::W / 12;
  uint32_t X[3 * E::W], R[3 * E::W];
  load_point<E>(X, a.x, count, i);
  if (a.f[i] | a.keep[i]) {
    jac_copy<E>(R, X);
  } else {
    uint32_t XL[3 * E::W];
    load_point<E>(XL, a.xl, count, i);
    jac_add<E>(R, XL, X);
  }
  for (int k = 0; k < NP; ++k)
    for (int w = 0; w < 12; ++w) a.out[k][w * count + i] = R[k * 12 + w];
}

}  // namespace

// g2: 0 for G1 (3 planes per point), 1 for G2 (6 planes: X.c0, X.c1, Y.c0,
// ...).  ptrs: the planes of xl, then of x, then of the output, each
// (12, count) words.  f, keep: count bytes each, nonzero = set.  Returns the
// CUDA launch error.
extern "C" int zc_hs_add_select(int g2, const void* const* ptrs, const void* f,
                                const void* keep, long long count,
                                void* stream) {
  const int np = g2 ? 6 : 3;
  HsArgs a;
  for (int k = 0; k < MAX_PLANES; ++k) {
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
