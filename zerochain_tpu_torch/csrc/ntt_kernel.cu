// The Fr NTT: a transform in ceil(lg d / 11) passes over device memory, each
// pass up to 11 radix-2 stages on a tile of 2,048 elements held in shared
// memory (zc_ntt_pass); and the quotient's pointwise step (a * b - c) / Z on
// the coset in one launch (zc_ntt_pointwise).
//
// Replaces: zerochain_tpu/ntt/ntt.py: NttPlan._fft, whose every stage is one
// batched Montgomery multiply, add and subtract over the whole (batch, d/2)
// plane through the Pallas field kernel (zerochain_tpu/ff/pallas_ff.py:
// _kernels).  The port ran that stage loop as three K1 launches and five
// copies a stage (the strided even / odd halves, the broadcast twiddle row,
// the stacked result): some 120 launches and a hundred passes over the
// whole tensor a transform at d = 32,768.
//
// Bound on this card: integer operations.  A transform of M rows of d
// elements does lg d * d/2 * M Montgomery multiplies of 2*8*8 + 8 = 136
// multiply-adds each (1.07e9 at d = 32,768, M = 32: 0.064 ms at 16.75e12/s)
// against reading and writing the (8, M, d) words once (0.020 ms at
// 3.35 TB/s).
//
// Design.  The DIT of NttPlan._fft after the bit reversal: stage s pairs
// the positions that differ in bit s, with the twiddle w^(d/2^(s+1) * l) of
// l = position mod 2^s.  Stages [s0, s0 + k) only pair positions that agree
// outside bits [s0, s0 + k), so they split the row into groups of 2^k
// elements at stride 2^s0, position = hi * 2^(s0+k) + mid * 2^s0 + lo.  A
// block loads 2^(11-k) groups into shared memory (word-plane-major, 8 planes
// of 2,048 words and a spare word every 32, so that a warp meets 32 banks
// whether it walks across the groups or along one), runs the k stages
// there, a barrier between stages, and writes the groups back; a later pass
// reads what the former wrote, in place.  A tile's groups have consecutive
// lo, so each word plane is read and written in runs of 2^(11-k) words.
// The first pass gathers through the bit reversal: its groups are numbered
// by c with hi = rev(c), which makes the source positions of a tile
// consecutive runs across the groups; its stores walk each group, whose
// destinations are consecutive.  The first pass's loads multiply by a
// pre-scale vector where one is given (the coset powers g^i), the last
// pass's stores by a post-scale vector or constant (n^-1; n^-1 g^i where an
// intt feeds a coset ntt; n^-1 g^-i for the icoset intt).  Every stored word
// is canonical, so the result equals the stage loop's word for word.
// Twiddles: all stages' tables in one (d - 1, 8) array, stage s from
// 2^s - 1, read through L2.
//
// The index maps and the three steps of a pass (load, butterfly, store) are
// ZC_HD functions over one element or one butterfly, so the host build
// steps a pass block by block with a smaller tile
// (tests/torch_csrc_host_check.cpp).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "field.cuh"

#define ZC_NTT_TILE_LG 11  // 2,048 elements (64 KB) a block
#define ZC_NTT_THREADS 256

// One pass: stages [s0, s0 + k) over (8, rows, 2^lg) word planes.
struct NttPassArgs {
  long long groups;     // rows << (lg - k)
  long long plane;      // rows << lg: words between two word planes
  int lg, s0, k, glg;   // log2 d; the stages; log2 of the groups a tile
  int n_tile, pitch;    // 2^(k + glg) elements a tile; words a tile's word plane
  const uint32_t* tw;   // (d - 1, 8): stage s's twiddles from 2^s - 1
  const uint32_t* pre;  // first pass: (d, 8), times pre[source position]; or null
  const uint32_t* post; // last pass: (d, 8) or (1, 8) (post_const); or null
  int post_const;
};

// The pass's shape; tile_lg >= k.
ZC_HOST_HD NttPassArgs ntt_args(long long rows, int lg, int s0, int k, int tile_lg) {
  NttPassArgs A;
  A.groups = rows << (lg - k);
  A.plane = rows << lg;
  A.lg = lg;
  A.s0 = s0;
  A.k = k;
  A.glg = tile_lg - k;
  A.n_tile = 1 << tile_lg;
  A.pitch = A.n_tile + (A.n_tile >> 5);
  A.tw = A.pre = A.post = nullptr;
  A.post_const = 0;
  return A;
}

// Tile element e = mid * 2^glg + gi (gi: the group in the tile) lives at
// word w * pitch + e + e / 32: one spare word every 32, so that a warp that
// walks a group (mid fastest, stride 2^glg) also meets 32 banks.
ZC_HD int ntt_slot(int e) { return e + (e >> 5); }

// The tile element of walk index t: the groups fastest (consecutive lo,
// consecutive sources in the first pass), or the elements of a group
// fastest (mid_fast: consecutive destinations in the first pass).
ZC_HD int ntt_elem(const NttPassArgs& A, int t, bool mid_fast) {
  if (!mid_fast) return t;
  return ((t & ((1 << A.k) - 1)) << A.glg) | (t >> A.k);
}

ZC_HD uint32_t ntt_rev(uint32_t x, int bits) {
#ifdef __CUDA_ARCH__
  return bits ? __brev(x) >> (32 - bits) : 0u;
#else
  uint32_t r = 0;
  for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1u) << (bits - 1 - i);
  return r;
#endif
}

// Group g's element mid: its row's offset (returned) and its position in the
// row as the pass writes it (*pos).
ZC_HD long long ntt_dst(const NttPassArgs& A, long long g, uint32_t mid,
                        uint32_t* pos) {
  const int s1 = A.s0 + A.k, hb = A.lg - s1;
  const uint32_t lo = (uint32_t)(g & ((1LL << A.s0) - 1));
  const long long rest = g >> A.s0;
  uint32_t hi = (uint32_t)(rest & ((1LL << hb) - 1));
  if (A.s0 == 0) hi = ntt_rev(hi, hb);  // the first pass: tiles of consecutive sources
  *pos = (hi << s1) | (mid << A.s0) | lo;
  return (rest >> hb) << A.lg;
}

ZC_HD void ntt_words(uint32_t* x, const uint32_t* p) {
#pragma unroll
  for (int w = 0; w < 8; ++w) x[w] = p[w];
}

// Tile element e of block blk from src, the first pass's through the bit
// reversal and the pre-scale.
ZC_HD void ntt_load(const NttPassArgs& A, const uint32_t* src, uint32_t* tile,
                    long long blk, int e) {
  const long long g = (blk << A.glg) + (e & ((1 << A.glg) - 1));
  if (g >= A.groups) return;
  uint32_t pos;
  const long long row = ntt_dst(A, g, (uint32_t)e >> A.glg, &pos);
  const uint32_t q = A.s0 == 0 ? ntt_rev(pos, A.lg) : pos;
  uint32_t x[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) x[w] = src[w * A.plane + row + q];
  if (A.pre) {
    uint32_t s[8];
    ntt_words(s, A.pre + 8 * (long long)q);
    fp_mont_mul_inl<FrP>(x, x, s);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) tile[w * A.pitch + ntt_slot(e)] = x[w];
}

// Butterfly b (n_tile / 2 of them) of the pass's stage s0 + j in the tile.
ZC_HD void ntt_butterfly(const NttPassArgs& A, uint32_t* tile, long long blk,
                         int j, int b) {
  const int gi = b & ((1 << A.glg) - 1);
  const long long g = (blk << A.glg) + gi;
  if (g >= A.groups) return;
  const uint32_t r = (uint32_t)b >> A.glg;
  const uint32_t low = r & ((1u << j) - 1);
  const uint32_t mid0 = ((r >> j) << (j + 1)) | low;
  const int e0 = (int)(mid0 << A.glg) | gi;
  const int e1 = e0 + (1 << (j + A.glg));
  const uint32_t lo = (uint32_t)(g & ((1LL << A.s0) - 1));
  const long long ti = ((1LL << (A.s0 + j)) - 1) + ((low << A.s0) | lo);
  uint32_t u[8], v[8], t[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    u[w] = tile[w * A.pitch + ntt_slot(e0)];
    v[w] = tile[w * A.pitch + ntt_slot(e1)];
  }
  ntt_words(t, A.tw + 8 * ti);
  fp_mont_mul_inl<FrP>(t, v, t);
  fp_add<FrP>(v, u, t);
  fp_sub<FrP>(u, u, t);
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    tile[w * A.pitch + ntt_slot(e0)] = v[w];
    tile[w * A.pitch + ntt_slot(e1)] = u[w];
  }
}

// Tile element e back to dst, the last pass's times the post-scale.
ZC_HD void ntt_store(const NttPassArgs& A, const uint32_t* tile, uint32_t* dst,
                     long long blk, int e) {
  const long long g = (blk << A.glg) + (e & ((1 << A.glg) - 1));
  if (g >= A.groups) return;
  uint32_t pos;
  const long long row = ntt_dst(A, g, (uint32_t)e >> A.glg, &pos);
  uint32_t x[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) x[w] = tile[w * A.pitch + ntt_slot(e)];
  if (A.post) {
    uint32_t s[8];
    ntt_words(s, A.post + (A.post_const ? 0 : 8 * (long long)pos));
    fp_mont_mul_inl<FrP>(x, x, s);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) dst[w * A.plane + row + pos] = x[w];
}

// out[i] = (a[i] * b[i] - c[i]) * z, or a[i] * z where b and c are null;
// count elements, word-plane-major.
ZC_HD void ntt_pointwise_elem(const uint32_t* a, const uint32_t* b,
                              const uint32_t* c, const uint32_t* z,
                              uint32_t* out, long long count, long long i) {
  uint32_t x[8], y[8], s[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) x[w] = a[w * count + i];
  if (b) {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      y[w] = b[w * count + i];
      s[w] = c[w * count + i];
    }
    fp_mont_mul_inl<FrP>(x, x, y);
    fp_sub<FrP>(x, x, s);
  }
  ntt_words(s, z);
  fp_mont_mul_inl<FrP>(x, x, s);
#pragma unroll
  for (int w = 0; w < 8; ++w) out[w * count + i] = x[w];
}

#ifdef __CUDACC__
namespace {

__global__ void __launch_bounds__(ZC_NTT_THREADS)
ntt_pass_kernel(NttPassArgs A, const uint32_t* src, uint32_t* dst) {
  extern __shared__ uint32_t tile[];
  const long long blk = blockIdx.x;
  for (int t = threadIdx.x; t < A.n_tile; t += blockDim.x)
    ntt_load(A, src, tile, blk, ntt_elem(A, t, false));
  for (int j = 0; j < A.k; ++j) {
    __syncthreads();
    for (int b = threadIdx.x; b < A.n_tile / 2; b += blockDim.x)
      ntt_butterfly(A, tile, blk, j, b);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < A.n_tile; t += blockDim.x)
    ntt_store(A, tile, dst, blk, ntt_elem(A, t, A.s0 == 0));
}

__global__ void __launch_bounds__(256)
ntt_pointwise_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                     const uint32_t* __restrict__ c, const uint32_t* __restrict__ z,
                     uint32_t* __restrict__ out, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) ntt_pointwise_elem(a, b, c, z, out, count, i);
}

}  // namespace

// Stages [s0, s0 + k) (k <= 11) of the transform of rows rows of 2^lg
// elements, (8, rows, 2^lg) int32 words, src -> dst (may be the same).  tw:
// the (2^lg - 1, 8) twiddles; pre (first pass only) a (2^lg, 8) vector or
// null; post (last pass only) a (2^lg, 8) vector, a (1, 8) constant
// (post_const) or null.  Returns the CUDA launch error.
extern "C" int zc_ntt_pass(const void* src, void* dst, long long rows, int lg,
                           int s0, int k, const void* tw, const void* pre,
                           const void* post, int post_const, void* stream) {
  if (rows < 0 || lg < 0 || lg > 30 || k < 0 || k > ZC_NTT_TILE_LG || s0 < 0 ||
      s0 + k > lg || (pre && s0 != 0) || (post && s0 + k != lg) || (k == 0 && lg))
    return (int)cudaErrorInvalidValue;
  NttPassArgs A = ntt_args(rows, lg, s0, k, ZC_NTT_TILE_LG);
  A.tw = (const uint32_t*)tw;
  A.pre = (const uint32_t*)pre;
  A.post = (const uint32_t*)post;
  A.post_const = post_const;
  const int smem = 8 * 4 * A.pitch;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  if (A.groups == 0) return 0;
  const long long blocks = (A.groups + (1LL << A.glg) - 1) >> A.glg;
  ntt_pass_kernel<<<(unsigned)blocks, ZC_NTT_THREADS, smem, (cudaStream_t)stream>>>(
      A, (const uint32_t*)src, (uint32_t*)dst);
  return (int)cudaGetLastError();
}

// out = (a * b - c) * z elementwise over count Fr elements (word-plane-major),
// or a * z where b and c are null; z: one element.  Returns the CUDA launch
// error.
extern "C" int zc_ntt_pointwise(const void* a, const void* b, const void* c,
                                const void* z, void* out, long long count,
                                void* stream) {
  if (count < 0 || (b == nullptr) != (c == nullptr))
    return (int)cudaErrorInvalidValue;
  if (count == 0) return 0;
  const int threads = 256;
  const long long blocks = (count + threads - 1) / threads;
  ntt_pointwise_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c,
      (const uint32_t*)z, (uint32_t*)out, count);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
