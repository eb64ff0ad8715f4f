// The witness stage's Jubjub chains, each in ONE launch, one thread a chain:
//
//   zc_jj_var_chain    the variable-base double-and-add of
//                      prover/witness.py: compute_var_mul_chains: per lane
//                      and step, sel = bit ? cur : identity, res += sel,
//                      record cur and res, cur = 2 cur (not after the last)
//   zc_jj_fixed_chain  the fixed-base window sums of
//                      compute_fixed_base_chains: per lane, from the first
//                      looked-up window point, add each next one and
//                      record the sum
//
// Replaces: the compiled loops of the JAX package
// (zerochain_tpu/prover_tpu/witness.py: the lax.scans of
// compute_fixed_base_chains and compute_var_mul_chains) over its field
// kernels (zerochain_tpu/ff/pallas_ff.py: `_kernels`), which the port ran as
// host loops of one field-kernel launch an operation (about 10,000 launches a
// witness).
//
// Bound on this card: latency.  A chain is serial (252 steps of 17 Fr
// multiplies, or 83 steps of 10), and a batch of 32 proofs has 160 or 192
// chains: 5-6 warps for 132 SMs.  The kernel's time is one lane's chain of
// dependent multiplies.
//
// Design: a thread owns one lane (chain x proof); its point, running sum and
// the step's temporaries stay in registers, the Fr multiply is inlined
// (edwards.cuh), and a CTA is one warp so the warps spread over the SMs.
// The selection is a word mask, so no lane of a warp branches.  Inputs and
// outputs are limb-major with the lane axis fastest (word w of step s of
// lane i at (w * n_steps + s) * lanes + i), so each store of a warp writes
// 32 neighbouring words.
//
// The per-lane bodies are plain functions of the lane, so they also build
// as plain C++ and can be stepped through on a CPU.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "edwards.cuh"

struct JjVarArgs {
  const uint32_t* bx;     // (8, lanes) affine base, Montgomery
  const uint32_t* by;
  const uint8_t* bits;    // (n_bits, lanes), 0 or 1
  uint32_t* cur;          // (3, 8, n_bits, lanes): X, Y, Z of cur per step
  uint32_t* res;          // (3, 8, n_bits, lanes): X, Y, Z of res per step
  int n_bits;
  long long lanes;
};

struct JjFixedArgs {
  const uint32_t* lx;     // (8, n_win, lanes) affine window points
  const uint32_t* ly;
  uint32_t* out;          // (3, 8, n_win - 1, lanes): X, Y, Z of each sum
  int n_win;
  long long lanes;
};

// X, Y, Z of P as step s of n in a (3, 8, n, lanes) output
ZC_HD void jj_store_xyz(uint32_t* out, const uint32_t* P, int n, int s,
                        long long lanes, long long lane) {
#pragma unroll
  for (int k = 0; k < 3 * ZC_JJ_W; ++k)
    out[((long long)k * n + s) * lanes + lane] = P[k];
}

ZC_HD void jj_var_lane(const JjVarArgs& a, long long lane) {
  constexpr int W = ZC_JJ_W;
  uint32_t x[W], y[W], cur[ZC_JJ_PW], res[ZC_JJ_PW], sel[ZC_JJ_PW];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    x[w] = a.bx[w * a.lanes + lane];
    y[w] = a.by[w * a.lanes + lane];
  }
  jj_from_affine(cur, x, y);
  jj_set_identity(res);
#pragma unroll 1
  for (int s = 0; s < a.n_bits; ++s) {
    const uint32_t m = a.bits[(long long)s * a.lanes + lane] ? 0xffffffffu : 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {  // bit ? cur : (0 : 1 : 1 : 0)
      sel[w] = cur[w] & m;
      sel[W + w] = (cur[W + w] & m) | (FrP::one(w) & ~m);
      sel[2 * W + w] = (cur[2 * W + w] & m) | (FrP::one(w) & ~m);
      sel[3 * W + w] = cur[3 * W + w] & m;
    }
    jj_add(res, res, sel);
    jj_store_xyz(a.cur, cur, a.n_bits, s, a.lanes, lane);
    jj_store_xyz(a.res, res, a.n_bits, s, a.lanes, lane);
    if (s + 1 < a.n_bits) jj_double(cur, cur);
  }
}

ZC_HD void jj_fixed_lane(const JjFixedArgs& a, long long lane) {
  constexpr int W = ZC_JJ_W;
  uint32_t x[W], y[W], acc[ZC_JJ_PW], q[ZC_JJ_PW];
  const long long step = (long long)a.n_win * a.lanes;  // one word plane
#pragma unroll
  for (int w = 0; w < W; ++w) {
    x[w] = a.lx[w * step + lane];
    y[w] = a.ly[w * step + lane];
  }
  jj_from_affine(acc, x, y);
#pragma unroll 1
  for (int k = 1; k < a.n_win; ++k) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      x[w] = a.lx[w * step + (long long)k * a.lanes + lane];
      y[w] = a.ly[w * step + (long long)k * a.lanes + lane];
    }
    jj_from_affine(q, x, y);
    jj_add(acc, acc, q);
    jj_store_xyz(a.out, acc, a.n_win - 1, k - 1, a.lanes, lane);
  }
}

#ifdef __CUDACC__
namespace {

constexpr int JJ_THREADS = 32;  // one warp a CTA: the few warps spread out

__global__ void __launch_bounds__(JJ_THREADS) jj_var_kernel(JjVarArgs a) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.lanes) jj_var_lane(a, lane);
}

__global__ void __launch_bounds__(JJ_THREADS) jj_fixed_kernel(JjFixedArgs a) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < a.lanes) jj_fixed_lane(a, lane);
}

unsigned blocks_for(long long lanes) {
  return (unsigned)((lanes + JJ_THREADS - 1) / JJ_THREADS);
}

}  // namespace

// bx, by: (8, lanes) words; bits: (n_bits, lanes) bytes; cur, res: (3, 8,
// n_bits, lanes) words each.  Returns the CUDA launch error.
extern "C" int zc_jj_var_chain(const void* bx, const void* by, const void* bits,
                               void* cur, void* res, int n_bits,
                               long long lanes, void* stream) {
  if (n_bits < 1 || lanes < 1) return (int)cudaErrorInvalidValue;
  JjVarArgs a{(const uint32_t*)bx, (const uint32_t*)by, (const uint8_t*)bits,
              (uint32_t*)cur, (uint32_t*)res, n_bits, lanes};
  jj_var_kernel<<<blocks_for(lanes), JJ_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// lx, ly: (8, n_win, lanes) words; out: (3, 8, n_win - 1, lanes) words.
extern "C" int zc_jj_fixed_chain(const void* lx, const void* ly, void* out,
                                 int n_win, long long lanes, void* stream) {
  if (n_win < 2 || lanes < 1) return (int)cudaErrorInvalidValue;
  JjFixedArgs a{(const uint32_t*)lx, (const uint32_t*)ly, (uint32_t*)out,
                n_win, lanes};
  jj_fixed_kernel<<<blocks_for(lanes), JJ_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
