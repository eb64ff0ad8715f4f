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
// running sum kept in the thread's registers.  The mixed add (jac_madd) is right because
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

// The scan of lane vl of program m, in place, with the running sum and the
// loaded point as register values (jacobian.cuh).  Kept inline.  The form
// before it (the lane on word arrays, the multiply and the adds out of line
// on pointers, a 2,848-byte frame) faulted in its G2 instance when inlined
// (nvcc 12.9, sm_90a) with an illegal address whenever one lane of a warp
// took the doubling branch of jac_madd (P = Q) while the others took the
// general add; that SASS addressed 552 local loads and stores through
// uniform registers, and only the out-of-line form ran right.  This form
// has no local memory to address; tools/column_scan_inline.py builds it
// inline and out of line and runs both on such lanes, and chip_smoke.py
// plants such a lane in its check.
template <class E>
ZC_HD void column_scan_lane(uint32_t* const* planes, long long plane,
                            int T, long long m, int vl) {
  const long long row = m * T * ZC_CS_LANES + vl;
  auto at = [&](long long i) {
    return jac_gather<E>([&](int k, int w) { return planes[k][w * plane + i]; });
  };
  Jac<E> run = at(row);
#pragma unroll 1
  for (int t = 1; t < T; ++t) {
    const long long i = row + (long long)t * ZC_CS_LANES;
    run = jac_madd(run, at(i));
    jac_scatter(run, [&](int k, int w, uint32_t x) { planes[k][w * plane + i] = x; });
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
