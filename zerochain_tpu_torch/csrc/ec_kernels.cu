// Jacobian point add and double for G1 (over Fq) and G2 (over Fq2), one
// thread per point.
//
// Replaces: zerochain_tpu/ec/pallas_ec.py, the kernels built by
// `_build_kernels` (add_kernel, double_kernel; public wrappers g1_add,
// g1_double, g2_add, g2_double).
//
// Bound on this card: integer operations.  A G1 add is 16 Fq multiplies
// (4,608 32-bit multiply-adds) for 9*48 bytes moved; a G2 add is three times
// that for twice the bytes.
//
// Design: each coordinate arrives as its own limb-major plane (word w of
// point i at w*count + i), so loads and stores are coalesced; the whole
// formula runs in the thread's registers and local memory.  The field
// multiply is an out-of-line function (one instance per kernel image) to
// keep code size and compile time down; a G2 point is 72 words, so two
// operands and the temporaries spill to local memory, which is accepted.
#include <cuda_runtime.h>

#include "jacobian.cuh"

namespace {

constexpr int MAX_PLANES = 6;  // 3 coordinates x up to 2 components

struct Planes {
  const uint32_t* p[MAX_PLANES];
  const uint32_t* q[MAX_PLANES];
  uint32_t* out[MAX_PLANES];
};

template <class E>
__device__ void load_point(uint32_t* dst, const uint32_t* const* planes,
                           long long count, long long i) {
  constexpr int NP = 3 * E::W / 12;
  for (int k = 0; k < NP; ++k)
    for (int w = 0; w < 12; ++w) dst[k * 12 + w] = planes[k][w * count + i];
}

template <class E, bool IS_ADD>
__global__ void __launch_bounds__(128)
ec_kernel(Planes pl, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  constexpr int NP = 3 * E::W / 12;
  uint32_t P[3 * E::W], R[3 * E::W];
  load_point<E>(P, pl.p, count, i);
  if (IS_ADD) {
    uint32_t Q[3 * E::W];
    load_point<E>(Q, pl.q, count, i);
    jac_add<E>(R, P, Q);
  } else {
    jac_double<E>(R, P);
  }
  for (int k = 0; k < NP; ++k)
    for (int w = 0; w < 12; ++w) pl.out[k][w * count + i] = R[k * 12 + w];
}

}  // namespace

// g2: 0 for G1 (3 planes per point), 1 for G2 (6 planes: X.c0, X.c1, Y.c0,
// ...).  op: 0 add, 1 double.  ptrs: the planes of p, then of q (ignored for
// double), then of the output, each (12, count) words.  Returns the CUDA
// launch error.
extern "C" int zc_ec_op(int g2, int op, const void* const* ptrs,
                        long long count, void* stream) {
  const int np = g2 ? 6 : 3;
  Planes pl;
  for (int k = 0; k < np; ++k) {
    pl.p[k] = (const uint32_t*)ptrs[k];
    pl.q[k] = (const uint32_t*)ptrs[np + k];
    pl.out[k] = (uint32_t*)ptrs[2 * np + k];
  }
  for (int k = np; k < MAX_PLANES; ++k) { pl.p[k] = pl.q[k] = nullptr; pl.out[k] = nullptr; }
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  if (!g2 && op == 0) ec_kernel<FqE, true><<<blocks, threads, 0, s>>>(pl, count);
  else if (!g2 && op == 1) ec_kernel<FqE, false><<<blocks, threads, 0, s>>>(pl, count);
  else if (g2 && op == 0) ec_kernel<Fq2E, true><<<blocks, threads, 0, s>>>(pl, count);
  else if (g2 && op == 1) ec_kernel<Fq2E, false><<<blocks, threads, 0, s>>>(pl, count);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
