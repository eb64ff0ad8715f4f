// column_scan: the inclusive group prefix down the depth axis of a
// column-major point array, in place.  For M programs of N = T*1024 points,
// physical position j = t*1024 + vl of program m holds
//   sum_{t' <= t} P[m, t'*1024 + vl]
// afterwards: 1024 independent lanes per program, each scanned over T depths.
//
// Replaces: zerochain_tpu/msm/pallas_scan.py, `_column_scan_kernel` (public
// wrapper column_scan).
//
// Bound on this card: integer operations.  A lane costs T-1 mixed adds (11 Fq
// multiplies for G1, 29 for G2); the bytes are each point read once and
// written once.
//
// Design: one thread per (program, lane), T-1 sequential mixed adds with the
// running sum kept in the thread.  The mixed add (jac_madd) is right because
// every input point has Z in {0, one}: the prover normalises the CRS at init,
// and a padding point (Z = 0) passes the running sum through.  Lanes are the
// fastest axis, so a warp's loads and stores of one depth are coalesced.
//
// column_scan_lane is a plain function of (program, lane), so the same code
// can be stepped through on a CPU without the CUDA toolkit.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "jacobian.cuh"

constexpr int ZC_CS_MAX_PLANES = 6;
constexpr int ZC_CS_LANES = 1024;

struct ColumnScanArgs {
  uint32_t* planes[ZC_CS_MAX_PLANES];  // each (12, M, T*1024), in place
  int T;
  long long M;
};

// The scan of lane vl of program m, in place.  Kept out of line on the card:
// inlined into the kernel (nvcc 12.9, sm_90a), the G2 instance faults with an
// illegal address whenever one lane of a warp takes the doubling branch of
// jac_madd (P = Q) while the others take the general add, from 1 program x 2
// depths on; warps whose lanes agree run right, and so does this out-of-line
// form on every input.  The source indexes no array by data.  The inlined
// G2 SASS addresses 552 local loads and stores through uniform registers
// (shared by the warp) that jac_double also loads constants into; this form
// has none in its G2 kernel.  chip_smoke.py plants such a lane in its check.
template <class E>
ZC_NOINLINE void column_scan_lane(uint32_t* const* planes, long long plane,
                                  int T, long long m, int vl) {
  constexpr int NP = 3 * E::W / 12;
  uint32_t run[3 * E::W], cur[3 * E::W], res[3 * E::W];
  const long long row = m * T * ZC_CS_LANES + vl;
  for (int k = 0; k < NP; ++k)
    for (int w = 0; w < 12; ++w) run[k * 12 + w] = planes[k][w * plane + row];
  for (int t = 1; t < T; ++t) {
    const long long at = row + (long long)t * ZC_CS_LANES;
    for (int k = 0; k < NP; ++k)
      for (int w = 0; w < 12; ++w) cur[k * 12 + w] = planes[k][w * plane + at];
    jac_madd<E>(res, run, cur);
    for (int k = 0; k < NP; ++k)
      for (int w = 0; w < 12; ++w) {
        run[k * 12 + w] = res[k * 12 + w];
        planes[k][w * plane + at] = res[k * 12 + w];
      }
  }
}

#ifdef __CUDACC__
namespace {

template <class E>
__global__ void __launch_bounds__(128) column_scan_kernel(ColumnScanArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.M * ZC_CS_LANES) return;
  column_scan_lane<E>(a.planes, a.M * a.T * ZC_CS_LANES, a.T,
                      i / ZC_CS_LANES, (int)(i % ZC_CS_LANES));
}

}  // namespace

// g2: 0 for G1 (3 planes), 1 for G2 (6 planes).  planes: the coordinate
// planes, each (12, M, T*1024) words, scanned in place.  Returns the CUDA
// launch error.
extern "C" int zc_column_scan(int g2, void* const* planes, int T, long long M,
                              void* stream) {
  const int np = g2 ? 6 : 3;
  ColumnScanArgs a;
  for (int k = 0; k < ZC_CS_MAX_PLANES; ++k)
    a.planes[k] = k < np ? (uint32_t*)planes[k] : nullptr;
  a.T = T;
  a.M = M;
  if (T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 128;
  const unsigned blocks = (unsigned)((M * ZC_CS_LANES + threads - 1) / threads);
  if (g2) column_scan_kernel<Fq2E><<<blocks, threads, 0, s>>>(a);
  else column_scan_kernel<FqE><<<blocks, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
