// Jacobian point add and double for G1 (over Fq) and G2 (over Fq2), one
// thread per point; and the three chains the prover runs on few points, each
// in ONE launch: the double-and-add ladder (zc_ec_ladder), the Horner window
// combine (zc_ec_horner) and the bucket MSM's running-sum fold (zc_ec_fold),
// one group of lanes per point or row (group_program.cuh).
//
// Replaces: zerochain_tpu/ec/pallas_ec.py, the kernels built by
// `_build_kernels` (add_kernel, double_kernel; public wrappers g1_add,
// g1_double, g2_add, g2_double).  The JAX package runs the ladder
// (ec/weierstrass.py: scalar_mul_bits_jac), the Horner combine
// (msm/suffix.py) and the bucket fold (msm/pippenger.py: Msm._window_total,
// 255 steps of two adds) as compiled device loops over those group
// operations; the chain kernels are those loops.
//
// Bound on this card: integer operations.  A G1 add is 16 Fq multiplies
// (4,608 32-bit multiply-adds) for 9*48 bytes moved; a G2 add is three times
// that for twice the bytes.
//
// Design: each coordinate arrives as its own limb-major plane (word w of
// point i at w*count + i), so loads and stores are coalesced; the formula
// runs on register values (jacobian.cuh), with the field multiply out of
// line and called on values, one instance per kernel image (the form on
// pointers had 2,880-byte frames; G2's add, two 72-word points beside its
// temporaries, still spills a little: ptxas, PERF.md).
//
// The chains run 255 (ladder), 31 x 9 (Horner) or 255 x 2 (fold) dependent
// group operations on 32-1,024 points or rows: too few threads to fill the
// card, so a chain's time is its step's latency.  A group of L lanes (L = 32:
// one warp per point) runs each step as a program of Fq operations in stages,
// the independent multiplies of a stage on separate lanes, the operands in
// shared memory (group_program.cuh).  With L = 1 the same program runs on one
// lane per point, which is the one-thread-per-point form the wrapper can also
// pick.
#include <cuda_runtime.h>

#include "group_program.cuh"

namespace {

constexpr int MAX_PLANES = 6;  // 3 coordinates x up to 2 components

struct Planes {
  const uint32_t* p[MAX_PLANES];
  const uint32_t* q[MAX_PLANES];
  uint32_t* out[MAX_PLANES];
};

template <class E>
__device__ __forceinline__ Jac<E> load_point(const uint32_t* const* planes,
                                             long long count, long long i) {
  return jac_gather<E>([&](int k, int w) { return planes[k][w * count + i]; });
}

template <class E, bool IS_ADD>
__global__ void __launch_bounds__(128)
ec_kernel(Planes pl, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const Jac<E> P = load_point<E>(pl.p, count, i);
  const Jac<E> R = IS_ADD ? jac_add(P, load_point<E>(pl.q, count, i)) : jac_double(P);
  jac_scatter(R, [&](int k, int w, uint32_t x) { pl.out[k][w * count + i] = x; });
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

namespace {

constexpr int ZP_SMEM_LIMIT = 48 * 1024;  // without the opt-in attribute

template <class E>
__global__ void __launch_bounds__(32)
ladder_kernel(const ZpSet* ps, Planes pl, const uint8_t* bits, int n_bits,
              long long count, int L) {
  extern __shared__ uint32_t zp_sh[];
  const int gi = threadIdx.x / L;
  const long long g = (long long)blockIdx.x * (blockDim.x / L) + gi;
  const unsigned mask = blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;
  const ZpGroup grp{zp_sh + gi * ps->n_slots * 12, (int)(threadIdx.x % L), L, mask};
  // a group past the end repeats the last point, so that every lane of the
  // warp takes part in every barrier and vote, and writes nothing
  zp_ladder<E>(ps, grp, pl.p, pl.out, bits, n_bits, count,
               g < count ? g : count - 1, g < count);
}

template <class E>
__global__ void __launch_bounds__(32)
horner_kernel(const ZpSet* ps, Planes pl, int nw, int c, long long count, int L) {
  extern __shared__ uint32_t zp_sh[];
  const int gi = threadIdx.x / L;
  const long long g = (long long)blockIdx.x * (blockDim.x / L) + gi;
  const unsigned mask = blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;
  const ZpGroup grp{zp_sh + gi * ps->n_slots * 12, (int)(threadIdx.x % L), L, mask};
  zp_horner<E>(ps, grp, pl.p, pl.out, nw, c, count, g < count ? g : count - 1,
               g < count);
}

template <class E>
__global__ void __launch_bounds__(32)
fold_kernel(const ZpSet* ps, Planes pl, int nb, long long count, int L) {
  extern __shared__ uint32_t zp_sh[];
  const int gi = threadIdx.x / L;
  const long long g = (long long)blockIdx.x * (blockDim.x / L) + gi;
  const unsigned mask = blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;
  const ZpGroup grp{zp_sh + gi * ps->n_slots * 12, (int)(threadIdx.x % L), L, mask};
  zp_fold<E>(ps, grp, pl.p, pl.out, nb, count, g < count ? g : count - 1,
             g < count);
}

// Groups per block (one warp at most): as many as fit 32 lanes and the
// shared-memory limit.
int zp_groups_per_block(int L, int n_slots) {
  int gpb = 32 / L;
  while (gpb > 1 && gpb * n_slots * 48 > ZP_SMEM_LIMIT) gpb /= 2;
  return gpb;
}

bool zp_lanes_ok(int L) { return L >= 1 && L <= 32 && !(L & (L - 1)); }

Planes zp_planes(int np, const void* const* ptrs) {
  Planes pl;
  for (int k = 0; k < MAX_PLANES; ++k) {
    pl.p[k] = k < np ? (const uint32_t*)ptrs[k] : nullptr;
    pl.q[k] = nullptr;
    pl.out[k] = k < np ? (uint32_t*)ptrs[np + k] : nullptr;
  }
  return pl;
}

}  // namespace

// The program set of group_program.cuh for G1 (g2 = 0) or G2, written to
// out (cap bytes).  Returns its size in bytes, or -1.  The caller copies it
// to the device once and hands it to zc_ec_ladder / zc_ec_horner.
extern "C" int zc_ec_programs(int g2, void* out, int cap) {
  if (cap < (int)sizeof(ZpSet)) return -1;
  if (!zp_build_set(g2 ? 2 : 1, (ZpSet*)out)) return -1;
  return (int)sizeof(ZpSet);
}

// progs: the device copy of zc_ec_programs(g2); n_slots its first int.
// ptrs: the base's planes (12, count) then the output's.  bits: (n_bits,
// count) uint8, 0 or 1.  lanes: 1, 2, 4, ..., 32 lanes per point.
extern "C" int zc_ec_ladder(int g2, const void* progs, int n_slots,
                            const void* const* ptrs, const void* bits,
                            int n_bits, long long count, int lanes,
                            void* stream) {
  if (!zp_lanes_ok(lanes) || n_slots < 1 || count < 1) return (int)cudaErrorInvalidValue;
  const Planes pl = zp_planes(g2 ? 6 : 3, ptrs);
  const int gpb = zp_groups_per_block(lanes, n_slots);
  const unsigned blocks = (unsigned)((count + gpb - 1) / gpb);
  const size_t smem = (size_t)gpb * n_slots * 48;
  cudaStream_t s = (cudaStream_t)stream;
  const ZpSet* ps = (const ZpSet*)progs;
  const uint8_t* b = (const uint8_t*)bits;
  if (g2) ladder_kernel<Fq2E><<<blocks, gpb * lanes, smem, s>>>(ps, pl, b, n_bits, count, lanes);
  else ladder_kernel<FqE><<<blocks, gpb * lanes, smem, s>>>(ps, pl, b, n_bits, count, lanes);
  return (int)cudaGetLastError();
}

// ptrs: the totals' planes (12, nw, count) then the output's (12, count).
extern "C" int zc_ec_horner(int g2, const void* progs, int n_slots,
                            const void* const* ptrs, int nw, int c,
                            long long count, int lanes, void* stream) {
  if (!zp_lanes_ok(lanes) || n_slots < 1 || count < 1 || nw < 1 || c < 0)
    return (int)cudaErrorInvalidValue;
  const Planes pl = zp_planes(g2 ? 6 : 3, ptrs);
  const int gpb = zp_groups_per_block(lanes, n_slots);
  const unsigned blocks = (unsigned)((count + gpb - 1) / gpb);
  const size_t smem = (size_t)gpb * n_slots * 48;
  cudaStream_t s = (cudaStream_t)stream;
  const ZpSet* ps = (const ZpSet*)progs;
  if (g2) horner_kernel<Fq2E><<<blocks, gpb * lanes, smem, s>>>(ps, pl, nw, c, count, lanes);
  else horner_kernel<FqE><<<blocks, gpb * lanes, smem, s>>>(ps, pl, nw, c, count, lanes);
  return (int)cudaGetLastError();
}

// ptrs: the buckets' planes (12, count, nb) then the output's (12, count).
extern "C" int zc_ec_fold(int g2, const void* progs, int n_slots,
                          const void* const* ptrs, int nb, long long count,
                          int lanes, void* stream) {
  if (!zp_lanes_ok(lanes) || n_slots < 1 || count < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  const Planes pl = zp_planes(g2 ? 6 : 3, ptrs);
  const int gpb = zp_groups_per_block(lanes, n_slots);
  const unsigned blocks = (unsigned)((count + gpb - 1) / gpb);
  const size_t smem = (size_t)gpb * n_slots * 48;
  cudaStream_t s = (cudaStream_t)stream;
  const ZpSet* ps = (const ZpSet*)progs;
  if (g2) fold_kernel<Fq2E><<<blocks, gpb * lanes, smem, s>>>(ps, pl, nb, count, lanes);
  else fold_kernel<FqE><<<blocks, gpb * lanes, smem, s>>>(ps, pl, nb, count, lanes);
  return (int)cudaGetLastError();
}
