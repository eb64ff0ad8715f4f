// The witness stage's gadget arithmetic, written straight into the aux rows
// of one preallocated (8, n_aux, B) tensor (word w of row r of proof b at
// (w * n_aux + r) * B + b), Montgomery form, every word canonical:
//
//   zc_wit_steps     W1: the per-step aux of the scalar-multiplication chains,
//                    one thread a (step, chain, proof).  A job is one
//                    emission block (prover/cuda_witness.py: StepJob):
//                      VAR    a variable-base double-and-add chain
//                             (prover/witness.py: var-mul blocks): step 0
//                             the selection, step s the doubling aux T, A, C
//                             of cur[s-1], cur[s], the selection of cur[s]
//                             by bit s, the addition aux U, A, B, C of
//                             res[s-1] + selection and res[s];
//                      FIXED  a fixed-base window chain: window 0 the lookup
//                             and its precomputation bit, window j the
//                             lookup, the bit (where window j has 3 real
//                             bits), the addition aux and the window sum;
//                      FOLD   a one-hot fold (witness_anon.py): member i the
//                             selection, the addition aux of acc[i-1] +
//                             selection, and acc[i].
//                    The chains' points arrive normalised (affine); a thread
//                    does at most 9 Fr multiplies with d as a constant.
//   zc_wit_gadgets   W2: the per-proof gadgets (a witnessed point's squares,
//                    the standalone Edwards add, the not-small-order
//                    doublings and their ephemeral inverse) as a straight-
//                    line Fr program built on the host (cuda_witness.Program),
//                    one warp a proof.
//
// Replaces: zerochain_tpu/ff/pallas_ff.py, the kernels built by `_kernels`
// (mont_mul, add, sub), at the witness's shapes: the JAX package routes each
// gadget field op to them under one jax.jit (prover_tpu/witness.py:
// _maybe_forced); the port ran one K1 launch an op (~670 a witness) and one
// zc_ff_inv launch an inversion of 32-96 elements (19 a witness).
//
// W1.  Bound on this card: bytes.  A VAR step reads 4 points and a bit and
// writes 13 values (672 bytes) for 9 multiplies (1,224 multiply-adds):
// about 1.8 multiply-adds a byte, under the ~5 an H100 does a byte of HBM.
// Design: the job table is a kernel parameter (blockIdx.y picks the job, so
// a block never diverges on the kind), lanes run along the proof axis, so a
// warp's loads and stores of one word are 32 neighbouring words.
//
// W2.  Bound: latency.  A proof's gadgets are a few hundred multiplies of
// small width, and each inversion of a proof is serial.  The program's
// operations (Fr multiply, add, subtract, the zero selections of the
// batched inversion, loads from the aux or input rows, stores to the aux
// rows, constants, and one Fermat power) run on numbered SLOTS, packed into
// STAGES whose operations are independent: the 32 lanes of a warp take them
// in turn (operation i of a stage on lane i mod 32), a warp barrier ends the
// stage.  A stage holds only multiplies, only the cheap operations, or only
// Fermat powers, so the lanes of a warp take the same branch of the heavy
// code.  Slots live in shared memory, word-major (word w of slot k at
// w * n_slots + k: neighbouring slots on neighbouring banks).  The
// inversions of one depth of the gadget graph are one Montgomery trick built
// into the program: zeros replaced by one, a product tree, ONE Fermat power,
// the tree unwound, zeros selected back to zero, so every word equals the
// element's own inverse (zero for zero): about four Fermat powers a proof
// for ConfidentialTransfer.
//
// The per-thread and per-lane bodies are plain functions, so they also build
// as plain C++ (tests/torch_csrc_host_check.cpp).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "fermat.cuh"

// The program constants zero, one, Edwards d and 2d, Montgomery form (R = 2^256)
ZC_CONST uint32_t ZC_WIT_CONSTS[4][8] = {
    {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u},
    {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau, 0xecbc4ff5u,
     0x998c4fefu, 0xacc5056fu, 0x1824b159u},
    {0xb974f6b0u, 0x2a522455u, 0x0d9acab3u, 0xfc6cc9efu, 0xc27628d1u,
     0x7a08fb94u, 0xfe0e262eu, 0x57f8f6a8u},
    {0x72e9ed5fu, 0x54a448acu, 0x1b373967u, 0xa51befdbu, 0x7b4a799eu,
     0xc0d81f21u, 0xd27ecf14u, 0x3c0445feu}};
enum : int { WC_ZERO = 0, WC_ONE = 1, WC_D = 2, WC_D2 = 3 };

// ------------------------------------------------------------------- W1

enum : int32_t { WS_VAR = 0, WS_FIXED = 1, WS_FOLD = 2 };

// One emission block.  p[0..3] are the x / y word planes of its two point
// arrays (VAR: cur, res; FIXED: lookups, window sums; FOLD: selections,
// sums), already offset to the job's chain, word k of entry s of proof b at
// p[i][k * wstride[i] + s * step_stride + b]; p[4] the bytes (VAR: bits,
// FIXED: 3-bit digits) at p[4][s * step_stride + b].
struct WitJob {
  int32_t kind, aux_off, n_steps, n_bits;
  int64_t step_stride;
  const void* p[5];
  int64_t wstride[4];
};

constexpr int WIT_MAX_JOBS = 40;

struct WitStepArgs {
  uint32_t* aux;
  int64_t n_aux, B;
  int32_t n_jobs;
  WitJob jobs[WIT_MAX_JOBS];
};

ZC_HD void wit_load(uint32_t* v, const WitJob& j, int i, long long s, long long b) {
  const uint32_t* p = (const uint32_t*)j.p[i];
  const long long at = s * j.step_stride + b;
#pragma unroll
  for (int w = 0; w < 8; ++w) v[w] = p[w * j.wstride[i] + at];
}

ZC_HD void wit_store(const WitStepArgs& a, long long row, long long b, const uint32_t* v) {
#pragma unroll
  for (int w = 0; w < 8; ++w) a.aux[(w * a.n_aux + row) * a.B + b] = v[w];
}

ZC_HD void wit_const(uint32_t* v, int k) {
#pragma unroll
  for (int w = 0; w < 8; ++w) v[w] = ZC_WIT_CONSTS[k][w];
}

// U, A, B, C of the addition gadget of (x1, y1) + (x2, y2), stored at row:
// U = (x1 + y1)(x2 + y2), A = y2 x1, B = x2 y1, C = d A B.
ZC_HD void wit_add_aux(const WitStepArgs& a, long long row, long long b,
                       const uint32_t* x1, const uint32_t* y1,
                       const uint32_t* x2, const uint32_t* y2) {
  uint32_t s[8], t[8], u[8], aa[8];
  fp_add<FrP>(s, x1, y1);
  fp_add<FrP>(t, x2, y2);
  fp_mont_mul_inl<FrP>(u, s, t);
  wit_store(a, row, b, u);
  fp_mont_mul_inl<FrP>(aa, y2, x1);
  wit_store(a, row + 1, b, aa);
  fp_mont_mul_inl<FrP>(u, x2, y1);
  wit_store(a, row + 2, b, u);
  wit_const(t, WC_D);
  fp_mont_mul_inl<FrP>(t, t, aa);
  fp_mont_mul_inl<FrP>(t, t, u);
  wit_store(a, row + 3, b, t);
}

// T, A, C of the doubling gadget of (x, y), stored at row:
// T = (x + y)^2, A = x y, C = d A A.
ZC_HD void wit_dbl_aux(const WitStepArgs& a, long long row, long long b,
                       const uint32_t* x, const uint32_t* y) {
  uint32_t s[8], t[8], aa[8];
  fp_add<FrP>(s, x, y);
  fp_mont_mul_inl<FrP>(t, s, s);
  wit_store(a, row, b, t);
  fp_mont_mul_inl<FrP>(aa, x, y);
  wit_store(a, row + 1, b, aa);
  wit_const(t, WC_D);
  fp_mont_mul_inl<FrP>(t, t, aa);
  fp_mont_mul_inl<FrP>(t, t, aa);
  wit_store(a, row + 2, b, t);
}

// bit ? (x, y) : (0, 1), as word masks
ZC_HD void wit_select(uint32_t* sx, uint32_t* sy, const uint32_t* x,
                      const uint32_t* y, bool bit) {
  const uint32_t m = bit ? 0xffffffffu : 0u;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    sx[w] = x[w] & m;
    sy[w] = (y[w] & m) | (FrP::one(w) & ~m);
  }
}

// Step s of job j for proof b.
ZC_HD void wit_step(const WitStepArgs& a, const WitJob& j, long long s, long long b) {
  uint32_t x1[8], y1[8], x2[8], y2[8];
  const uint8_t* bytes = (const uint8_t*)j.p[4];
  if (j.kind == WS_VAR) {
    const bool bit = bytes[s * j.step_stride + b] != 0;
    wit_load(x2, j, 0, s, b);
    wit_load(y2, j, 1, s, b);
    wit_select(x2, y2, x2, y2, bit);
    if (s == 0) {
      wit_store(a, j.aux_off, b, x2);
      wit_store(a, j.aux_off + 1, b, y2);
      return;
    }
    const long long row = j.aux_off + 2 + 13 * (s - 1);
    wit_load(x1, j, 0, s - 1, b);
    wit_load(y1, j, 1, s - 1, b);
    wit_dbl_aux(a, row, b, x1, y1);
    wit_store(a, row + 5, b, x2);
    wit_store(a, row + 6, b, y2);
    wit_load(x1, j, 2, s - 1, b);
    wit_load(y1, j, 3, s - 1, b);
    wit_add_aux(a, row + 7, b, x1, y1, x2, y2);
    wit_load(x1, j, 0, s, b);
    wit_load(y1, j, 1, s, b);
    wit_store(a, row + 3, b, x1);
    wit_store(a, row + 4, b, y1);
    wit_load(x1, j, 2, s, b);
    wit_load(y1, j, 3, s, b);
    wit_store(a, row + 11, b, x1);
    wit_store(a, row + 12, b, y1);
  } else if (j.kind == WS_FIXED) {
    // window s: its lookup, its precomputation bit (digit bits 1 and 2)
    const uint32_t d = bytes[s * j.step_stride + b];
    uint32_t pc[8];
    wit_const(pc, ((d >> 1) & (d >> 2) & 1u) ? WC_ONE : WC_ZERO);
    wit_load(x2, j, 0, s, b);
    wit_load(y2, j, 1, s, b);
    if (s == 0) {
      wit_store(a, j.aux_off, b, x2);
      wit_store(a, j.aux_off + 1, b, y2);
      wit_store(a, j.aux_off + 2, b, pc);
      return;
    }
    long long row = j.aux_off + 3 + 9 * (s - 1);
    wit_store(a, row, b, x2);
    wit_store(a, row + 1, b, y2);
    row += 2;
    if (s < j.n_bits / 3) wit_store(a, row++, b, pc);  // 3 real bits
    if (s == 1) {  // after window 0: its lookup, else the last window sum
      wit_load(x1, j, 0, 0, b);
      wit_load(y1, j, 1, 0, b);
    } else {
      wit_load(x1, j, 2, s - 2, b);
      wit_load(y1, j, 3, s - 2, b);
    }
    wit_add_aux(a, row, b, x1, y1, x2, y2);
    wit_load(x1, j, 2, s - 1, b);
    wit_load(y1, j, 3, s - 1, b);
    wit_store(a, row + 4, b, x1);
    wit_store(a, row + 5, b, y1);
  } else {  // WS_FOLD
    const long long row = j.aux_off + 8 * s;
    wit_load(x2, j, 0, s, b);
    wit_load(y2, j, 1, s, b);
    wit_store(a, row, b, x2);
    wit_store(a, row + 1, b, y2);
    if (s == 0) {  // the fold starts from the (0, 1) zero_p witness
      wit_const(x1, WC_ZERO);
      wit_const(y1, WC_ONE);
    } else {
      wit_load(x1, j, 2, s - 1, b);
      wit_load(y1, j, 3, s - 1, b);
    }
    wit_add_aux(a, row + 2, b, x1, y1, x2, y2);
    wit_load(x1, j, 2, s, b);
    wit_load(y1, j, 3, s, b);
    wit_store(a, row + 6, b, x1);
    wit_store(a, row + 7, b, y1);
  }
}

// ------------------------------------------------------------------- W2

enum : int32_t {
  WG_MUL = 0, WG_ADD = 1, WG_SUB = 2, WG_NZ1 = 3, WG_ZSEL = 4,
  WG_LOAD = 5, WG_STORE = 6, WG_CONST = 7, WG_INV = 8
};
// An operation is 4 int32 (op, d, x, y):
//   MUL/ADD/SUB  slot d = slot x (op) slot y
//   NZ1          slot d = slot x == 0 ? one : slot x
//   ZSEL         slot d = slot x == 0 ? 0 : slot y
//   LOAD         slot d = row x of the aux (y = 0) or of the inputs (y = 1)
//   STORE        aux row d = slot x
//   CONST        slot d = constant x (ZC_WIT_CONSTS)
//   INV          slot d = slot x ^ (p - 2)

struct WitProg {
  const int32_t* ops;        // (n_ops, 4)
  const int32_t* stage_end;  // stage s: ops [stage_end[s - 1], stage_end[s])
  int32_t n_stages, n_slots;
  uint32_t* aux;
  int64_t n_aux;
  const uint32_t* ins;       // (8, n_ins, B), or null
  int64_t n_ins, B;
};

#ifdef __CUDA_ARCH__
#define WG_SYNC() __syncwarp()
#else
#define WG_SYNC() ((void)0)
#endif

// The program for proof b on lane `lane` of L; s: the proof's slots.
ZC_HD void wg_run(const WitProg& g, uint32_t* s, long long b, int lane, int L) {
  const int ns = g.n_slots;
  for (int st = 0; st < g.n_stages; ++st) {
    const int beg = st ? g.stage_end[st - 1] : 0, end = g.stage_end[st];
    for (int i = beg + lane; i < end; i += L) {
      const int op = g.ops[4 * i], d = g.ops[4 * i + 1];
      const int x = g.ops[4 * i + 2], y = g.ops[4 * i + 3];
      uint32_t u[8], v[8], r[8];
      if (op == WG_STORE) {
#pragma unroll
        for (int w = 0; w < 8; ++w) g.aux[(w * g.n_aux + d) * g.B + b] = s[w * ns + x];
        continue;
      }
      if (op == WG_LOAD) {
        const uint32_t* src = y ? g.ins : g.aux;
        const long long rows = y ? g.n_ins : g.n_aux;
#pragma unroll
        for (int w = 0; w < 8; ++w) r[w] = src[(w * rows + x) * g.B + b];
      } else if (op == WG_CONST) {
        wit_const(r, x);
      } else {
        uint32_t any = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          u[w] = s[w * ns + x];
          any |= u[w];
        }
        if (op == WG_INV) {
          fp_inv_fermat<FrP>(r, u);
        } else if (op == WG_NZ1) {
#pragma unroll
          for (int w = 0; w < 8; ++w) r[w] = any ? u[w] : FrP::one(w);
        } else {
#pragma unroll
          for (int w = 0; w < 8; ++w) v[w] = s[w * ns + y];
          if (op == WG_MUL) fp_mont_mul_inl<FrP>(r, u, v);
          else if (op == WG_ADD) fp_add<FrP>(r, u, v);
          else if (op == WG_SUB) fp_sub<FrP>(r, u, v);
          else {  // WG_ZSEL
#pragma unroll
            for (int w = 0; w < 8; ++w) r[w] = any ? v[w] : 0u;
          }
        }
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) s[w * ns + d] = r[w];
    }
    WG_SYNC();
  }
}

#ifdef __CUDACC__
namespace {

constexpr int WS_THREADS = 128;

__global__ void __launch_bounds__(WS_THREADS)
wit_steps_kernel(const __grid_constant__ WitStepArgs a) {
  const WitJob& j = a.jobs[blockIdx.y];
  const long long t = (long long)blockIdx.x * WS_THREADS + threadIdx.x;
  if (t >= (long long)j.n_steps * a.B) return;
  wit_step(a, j, t / a.B, t % a.B);
}

__global__ void __launch_bounds__(32) wit_gadgets_kernel(const __grid_constant__ WitProg g) {
  extern __shared__ uint32_t slots[];
  wg_run(g, slots, blockIdx.x, threadIdx.x, 32);
}

}  // namespace

// jobs: n_jobs WitJob records; aux: (8, n_aux, B) words.  Returns the CUDA
// launch error.
extern "C" int zc_wit_steps(const void* jobs, int n_jobs, void* aux,
                            long long n_aux, long long B, void* stream) {
  if (n_jobs < 1 || n_jobs > WIT_MAX_JOBS || B < 1) return (int)cudaErrorInvalidValue;
  WitStepArgs a;
  a.aux = (uint32_t*)aux;
  a.n_aux = n_aux;
  a.B = B;
  a.n_jobs = n_jobs;
  long long most = 0;
  for (int i = 0; i < n_jobs; ++i) {
    a.jobs[i] = ((const WitJob*)jobs)[i];
    if (a.jobs[i].n_steps > most) most = a.jobs[i].n_steps;
  }
  const dim3 grid((unsigned)((most * B + WS_THREADS - 1) / WS_THREADS), (unsigned)n_jobs);
  wit_steps_kernel<<<grid, WS_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ops: (n_ops, 4) int32 and stage_end: (n_stages,) int32, on the device;
// aux: (8, n_aux, B) words; ins: (8, n_ins, B) words or null.  One warp a
// proof, n_slots * 32 bytes of shared memory each.
extern "C" int zc_wit_gadgets(const void* ops, const void* stage_end, int n_stages,
                              int n_slots, void* aux, long long n_aux,
                              const void* ins, long long n_ins, long long B,
                              void* stream) {
  if (n_stages < 1 || n_slots < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_slots * 8 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wit_gadgets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  WitProg g{(const int32_t*)ops, (const int32_t*)stage_end, n_stages, n_slots,
            (uint32_t*)aux, n_aux, (const uint32_t*)ins, n_ins, B};
  wit_gadgets_kernel<<<(unsigned)B, 32, smem, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
