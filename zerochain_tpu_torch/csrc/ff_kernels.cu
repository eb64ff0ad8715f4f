// Elementwise Montgomery field kernels: mont_mul, mont_sqr, add, sub over
// Fq, Fr and Fs (zc_ff_op), and the field inverse (zc_ff_inv).
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
//
// The inverse replaces what the JAX package composes of those kernels
// (limbs.batch_inv_mont: a Montgomery trick, prefix and suffix products at
// log depth and one Fermat power), which the port ran as ~420 launches an
// inversion.  Here one thread inverts one element by its own Fermat power
// a^(p-2), MSB-first square-and-multiply with the exponent in constant
// memory (every thread reads the same bit: no divergence) and the element
// in registers: 254 squarings and 163 multiplies for Fr, 380 and 228 for Fq.
// Bound: integer operations (~57,000 multiply-adds an Fr element); at the
// witness's 40,320 elements the card has enough threads, at a handful its
// time is one thread's chain of multiplies.  Zero maps to zero, as the
// Montgomery trick's masking does; the inverse is unique and canonical, so
// the words equal the plain version's.  fp_inv_fermat (fermat.cuh) also
// builds as plain C++.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "fermat.cuh"

#ifdef __CUDACC__
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

template <class F>
__global__ void __launch_bounds__(128)
ff_inv_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
              long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint32_t x[F::N];
#pragma unroll
  for (int w = 0; w < F::N; ++w) x[w] = a[w * count + i];
  fp_inv_fermat<F>(x, x);
#pragma unroll
  for (int w = 0; w < F::N; ++w) out[w * count + i] = x[w];
}

template <class F>
int launch_inv(const uint32_t* a, uint32_t* out, long long count,
               cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  ff_inv_kernel<F><<<blocks, threads, 0, stream>>>(a, out, count);
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

// field: 0 Fq, 1 Fr, 2 Fs.  a, out: count elements, limb-major; out = a^-1
// (0 for 0), Montgomery in and out.  Returns the CUDA launch error.
extern "C" int zc_ff_inv(int field, const void* a, void* out, long long count,
                         void* stream) {
  const uint32_t* pa = (const uint32_t*)a;
  uint32_t* po = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case 0: return launch_inv<FqP>(pa, po, count, s);
    case 1: return launch_inv<FrP>(pa, po, count, s);
    case 2: return launch_inv<FsP>(pa, po, count, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // __CUDACC__
