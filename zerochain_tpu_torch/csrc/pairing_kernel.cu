// The BLS12-381 pairing's Miller loop and final exponentiation: a warp a
// pairing, running host-built straight-line programs of Fq operations on
// 12-word slots in shared memory (ec/cuda_pairing.py builds the programs).
//
// Replaces: zerochain_tpu/ff/pallas_ff.py, the kernels built by `_kernels`
// (mont_mul, add, sub), at the pairing's shapes: the JAX package's pairing
// (zerochain_tpu/ec/pairing.py: g2_prepare, miller_loop,
// final_exponentiation) routes every tower op to them (ec/fields.py ->
// ff/limbs.py); the port ran one K1 launch a tower op (10,535 a call, with
// ~20,000 stack / cat / index_select copies around them) and one zc_ff_inv
// launch for the Fq12 inverse.
//
// Bound on this card: latency.  A pairing is ~14,600 Fq multiplies (6,909
// in the G2 preparation and Miller loop, 7,719 in the final exponentiation)
// and ~64,000 adds, subtracts and moves, plus one Fermat power (~600 serial
// multiplies); at batch 1-32 that is 1-32 warps on 132 SMs, each on one of
// its SM's four schedulers, so the time is the dependency chain: the number
// of stages, each as long as its slowest lane (on an H100: ~0.3-0.4 us a
// stage of adds, ~1.6 us a round of multiplies, PERF.md).
//
// Design.  A program's operations (Fq multiply, add, subtract, move,
// constant, load from an input row, store to an output row, a^(p-2)) run
// on numbered SLOTS, packed into STAGES of independent operations:
// operation i of a stage on lane i mod 32, a warp barrier ends the stage.
// A stage holds only multiplies, only Fermat powers or only the cheap
// operations, so the lanes of a warp take the same branch of the heavy
// code; the Fq12 multiplies and squarings are Karatsuba all the way down,
// so each is ONE stage of independent multiplies (54 for a product, 36 for
// a square, 18 for the hard part's cyclotomic squares).  Slots live in
// shared memory, word-major (word w of slot k at w * 512 + k: a stage's
// neighbouring slots on neighbouring banks).  Control flow is a SEQUENCE of
// (program, row base) pairs the kernel walks, the base added to the rows
// of its loads and stores: the Miller set walks the 62 scheduled steps and
// the final doubling (each step's program runs the f chain of its step
// beside the R chain of the next, so both chains' multiplies share
// stages), the final-exponentiation set its fixed chain of Fq12 register
// operations, each power by x as 63 cyclotomic squarings, 5 of them fused
// with a multiply.  The Fq12 inverse is one Fermat power on one lane
// (fermat.cuh).  Every word a lane stores is canonical (the word-array
// functions of field.cuh), so the result does not depend on which lane
// computed it and equals the plain version's (cuda_pairing.execute_plain)
// word for word.
//
// The per-lane stage body is a plain function, so it also builds as plain
// C++ (tests/torch_csrc_host_check.cpp steps it at one lane and at L lanes).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "fermat.cuh"

enum : int32_t {
  PP_MUL = 0, PP_ADD = 1, PP_SUB = 2, PP_MOV = 3, PP_CONST = 4, PP_LOAD = 5,
  PP_STORE = 6, PP_INV = 7
};
// An operation (op, d, a, b):
//   MUL/ADD/SUB  slot d = slot a (op) slot b
//   MOV          slot d = slot a
//   CONST        slot d = constant a
//   LOAD         slot d = input row a + base
//   STORE        output row d + base = slot a
//   INV          slot d = slot a ^ (p - 2)
// In a stage each slot has one writer, and no operation reads a slot that
// another writes (cuda_pairing.check_stages).
struct PpOp {
  int32_t op, d, a, b;
};

struct PpArgs {
  const PpOp* ops;
  const int32_t* stage_end;   // stage s: ops [stage_end[s - 1], stage_end[s])
  const int32_t* prog_stage;  // program p: stages [prog_stage[p], prog_stage[p + 1])
  const int32_t* seq;         // (n_seq, 2): program, row base
  int32_t n_seq, n_slots, n_consts;
  const uint32_t* consts;     // (12, n_consts) words
  const uint32_t* ins;        // (12, n_in, B) words
  uint32_t* outs;             // (12, n_out, B) words
  int64_t n_in, n_out, B;
};

// A pairing's slots: word w of slot k at w * PP_MAX_SLOTS + k, a compile-
// time stride, so that the 12 words of an operand are one address and 12
// immediate offsets (24 KB of shared memory a warp).
constexpr int PP_MAX_SLOTS = 512;

#ifdef __CUDA_ARCH__
#define PP_SYNC() __syncwarp()
#else
#define PP_SYNC() ((void)0)
#endif

// Stage st's operations of lane `lane` of L (operations lane, lane + L, ...)
// for pairing b; s: its slots.
ZC_HD void pp_stage(const PpArgs& g, int st, int base, uint32_t* s, long long b,
                    int lane, int L) {
  constexpr int ns = PP_MAX_SLOTS;
  const int beg = st ? g.stage_end[st - 1] : 0, end = g.stage_end[st];
  for (int i = beg + lane; i < end; i += L) {
    const PpOp o = g.ops[i];
    uint32_t x[12], y[12], r[12];
    if (o.op == PP_STORE) {
#pragma unroll
      for (int w = 0; w < 12; ++w)
        g.outs[(w * g.n_out + o.d + base) * g.B + b] = s[w * ns + o.a];
      continue;
    }
    if (o.op == PP_LOAD) {
#pragma unroll
      for (int w = 0; w < 12; ++w) r[w] = g.ins[(w * g.n_in + o.a + base) * g.B + b];
    } else if (o.op == PP_CONST) {
#pragma unroll
      for (int w = 0; w < 12; ++w) r[w] = g.consts[w * g.n_consts + o.a];
    } else {
#pragma unroll
      for (int w = 0; w < 12; ++w) x[w] = s[w * ns + o.a];
      if (o.op == PP_MOV) {
#pragma unroll
        for (int w = 0; w < 12; ++w) r[w] = x[w];
      } else if (o.op == PP_INV) {
        fp_inv_fermat<FqP>(r, x);
      } else {
#pragma unroll
        for (int w = 0; w < 12; ++w) y[w] = s[w * ns + o.b];
        if (o.op == PP_MUL) fp_mont_mul_inl<FqP>(r, x, y);
        else if (o.op == PP_ADD) fp_add<FqP>(r, x, y);
        else fp_sub<FqP>(r, x, y);
      }
    }
#pragma unroll
    for (int w = 0; w < 12; ++w) s[w * ns + o.d] = r[w];
  }
}

#ifdef __CUDACC__
namespace {

__global__ void __launch_bounds__(32) pairing_kernel(const __grid_constant__ PpArgs g) {
  extern __shared__ uint32_t slots[];
  for (int e = 0; e < g.n_seq; ++e) {
    const int prog = g.seq[2 * e], base = g.seq[2 * e + 1];
    for (int st = g.prog_stage[prog]; st < g.prog_stage[prog + 1]; ++st) {
      pp_stage(g, st, base, slots, blockIdx.x, threadIdx.x, 32);
      PP_SYNC();
    }
  }
}

}  // namespace

// ops: (n_ops, 4) int32, stage_end, prog_stage, seq: (n_seq, 2) int32 and
// consts: (12, n_consts) words, on the device; ins: (12, n_in, B) words;
// outs: (12, n_out, B) words.  One warp a pairing, PP_MAX_SLOTS * 48 bytes
// of shared memory each.  Returns the CUDA launch error.
extern "C" int zc_pairing_run(const void* ops, const void* stage_end, const void* prog_stage,
                              const void* seq, int n_seq, const void* consts, int n_consts,
                              int n_slots, const void* ins, long long n_in, void* outs,
                              long long n_out, long long B, void* stream) {
  if (n_seq < 1 || n_slots < 1 || n_slots > PP_MAX_SLOTS || B < 1 || B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)PP_MAX_SLOTS * 12 * sizeof(uint32_t);
  const PpArgs g{(const PpOp*)ops, (const int32_t*)stage_end, (const int32_t*)prog_stage,
                 (const int32_t*)seq, n_seq, n_slots, n_consts, (const uint32_t*)consts,
                 (const uint32_t*)ins, (uint32_t*)outs, n_in, n_out, B};
  pairing_kernel<<<(unsigned)B, 32, smem, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
