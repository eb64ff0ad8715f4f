// Elementwise Montgomery field kernels: mont_mul, mont_sqr, add, sub over
// Fq, Fr and Fs.
//
// Replaces: zerochain_tpu/ff/pallas_ff.py, the kernels built by `_kernels`
// (public wrappers mont_mul, mont_sqr, add, sub).  That kernel holds 12-bit
// limbs in (8,128) int32 planes because the TPU has no wide integer multiply;
// here an element is 12 or 8 native 32-bit words.
//
// Bound on this card: memory bandwidth, at every op.  One Fq multiply is
// 2*12*12 + 12 = 300 32x32->64 multiply-adds against 3*48 bytes moved, about
// 2 multiply-adds a byte (Fr: 136 against 96 bytes, 1.4 a byte), and an H100
// does about 5 integer multiply-adds in the time it moves one byte to or from
// HBM; add and sub do far less per byte still.
//
// Design: one thread per element with all words in registers and both loops
// unrolled; the layout is limb-major (word w of element i at w*count + i), so
// the threads of a warp read 32 neighbouring words in each load.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

enum Op { OP_MUL = 0, OP_SQR = 1, OP_ADD = 2, OP_SUB = 3 };

template <class F, int OP>
__global__ void __launch_bounds__(256)
ff_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
          uint32_t* __restrict__ out, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint32_t x[F::N], y[F::N], r[F::N];
#pragma unroll
  for (int w = 0; w < F::N; ++w) x[w] = a[w * count + i];
  if (OP == OP_SQR) {
#pragma unroll
    for (int w = 0; w < F::N; ++w) y[w] = x[w];
  } else {
#pragma unroll
    for (int w = 0; w < F::N; ++w) y[w] = b[w * count + i];
  }
  if (OP == OP_MUL || OP == OP_SQR) fp_mont_mul_inl<F>(r, x, y);
  if (OP == OP_ADD) fp_add<F>(r, x, y);
  if (OP == OP_SUB) fp_sub<F>(r, x, y);
#pragma unroll
  for (int w = 0; w < F::N; ++w) out[w * count + i] = r[w];
}

template <class F>
int launch(int op, const uint32_t* a, const uint32_t* b, uint32_t* out,
           long long count, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  switch (op) {
    case OP_MUL: ff_kernel<F, OP_MUL><<<blocks, threads, 0, stream>>>(a, b, out, count); break;
    case OP_SQR: ff_kernel<F, OP_SQR><<<blocks, threads, 0, stream>>>(a, b, out, count); break;
    case OP_ADD: ff_kernel<F, OP_ADD><<<blocks, threads, 0, stream>>>(a, b, out, count); break;
    case OP_SUB: ff_kernel<F, OP_SUB><<<blocks, threads, 0, stream>>>(a, b, out, count); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// field: 0 Fq, 1 Fr, 2 Fs.  op: 0 mont_mul, 1 mont_sqr, 2 add, 3 sub.
// a, b, out: count elements, limb-major.  Returns the CUDA launch error.
extern "C" int zc_ff_op(int field, int op, const void* a, const void* b,
                        void* out, long long count, void* stream) {
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  uint32_t* po = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return launch<FqP>(op, pa, pb, po, count, s);
    case 1: return launch<FrP>(op, pa, pb, po, count, s);
    case 2: return launch<FsP>(op, pa, pb, po, count, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
