#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py              # the full run (ConfidentialTransfer, then
                                       # AnonymousTransfer, B = 32 each)
    python3 chip_smoke.py --mini       # the confidential phases on the MiniCommit
                                       # fixture (no anonymous phases)
    python3 chip_smoke.py --anon-only  # the build and the anonymous phases alone
    python3 chip_smoke.py --verify-only  # the build and the phases reddsa and
                                         # pairing alone
    python3 chip_smoke.py --cli-only   # the build and the cli phase alone
    python3 chip_smoke.py --dist-only  # the build, crs, prove and the dist
                                       # phase alone

Phases, each printing one JSON line when it ends; any failure raises and the
run exits non-zero (there is no CPU fallback):

  device   the card, its power limit, the torch/CUDA versions
  build    compiles csrc/*.cu with nvcc (all sources in parallel) and loads them;
           ptxas's registers, stack frame and spill bytes of every function
           (kernel entries and device functions) and each library's SASS size
  crs      ConfidentialProver.from_toxic_waste on the card
  witness  the batch's witness (confidential_witness) on the card, with its
           kernel launches counted, equal word for word to the CPU plain
           path's for the first and the last proof; it fails unless the
           chains make their launches, the gadget aux one step and one
           gadget-program launch (witness_kernel.cu), and the field kernels
           at most 12 launches, 3 of them inversions
  kernels  every kernel wrapper against its plain PyTorch version on the card,
           on CRS points and random field elements at the main path's shapes
           (the chain kernels, ladder, Horner and the bucket fold, also in
           their one-lane form; window_totals, bucket_sums and the split
           tail's split_lanes / split_tail also on the digits of the batch
           the prove phases prove; the field inverse and
           the Jubjub chains at the witness stage's shapes, the chains also
           against their former loop of field-kernel launches; the witness's
           step kernel and gadget program (witness.steps, witness.gadgets)
           on the batch's own chains, against their plain versions on the
           first and the last proof; window_totals,
           split_lanes / split_tail, bucket_sums, bucket_fold and Horner at
           window widths c = 4 and c = 10 on 2,048 CRS points (launches 0);
           and the bucket MSM's 'assoc' mode against 'hs' there, line
           msm_assoc; the NTT kernels (ntt.fwd, ntt.inv, ntt.quotient, and
           at prove's shape ntt.coset, ntt.icoset, ntt.divide_by_z) at
           (8, B, d), the quotient on the batch's own evaluations, and at
           (8, d), create_proof's, against the plan's plain stage loop;
           the quotient once more with the counters zeroed: it fails the
           run with more than 15 NTT launches or any K1 launch)
  prove    one batch of 32 proofs (warm run, then a timed run with the launch
           counters zeroed just before and read just after)
  prove_hs     the same batch through the bucket MSM (msm_impl="hs": per
               chunk one bucket_sums and one bucket_fold launch for all
               windows), on the same CRS; its proofs must equal prove's, and
               its timed run must launch no hs_add_select, call no
               torch.roll and launch bucket_sums and bucket_fold for every
               MSM chunk
  prove_split  the same through the suffix MSM's split tail
               (msm_tail="split": one split_lanes and one split_tail launch
               a chunk); its proofs must equal prove's, and its timed run
               must call no torch.roll, launch no column_scan and no
               window_totals, launch each split kernel once for every MSM
               chunk, and make as many point-op launches as prove's (no
               point add of its own)
  dist     the same batch with ZEROCHAIN_DIST=1 in an NCCL world of one
           (torch.distributed over a file store, no network), on the same
           CRS: phases dist_prove, dist_prove_split and dist_prove_hs, each
           a warm and a timed prove as above; their proofs must equal
           prove's, each path launch its MSM kernels for every chunk, and
           the timed run make one all-to-all a transform (seven) and one
           all-gather a transform and an MSM chunk.  Then
           DistNtt.quotient at the prover's d against NttPlan's chain
           (word for word) and sharded_suffix on the A query's first chunk
           (the batch's raw digits) against window_partials (after
           normalisation); seconds, launches and the collectives' count and
           bytes; the group destroyed.  Also under --mini; alone with
           --dist-only (after crs and prove).
  backend  groth16.core.generate_parameters and create_proof through
           TorchBackend on the card: the same verifying key as the CRS phase,
           and create_proof on assignment 0 equal to prove's proof 0; the
           create_proof seconds split into the backend's calls (each ended
           by a synchronize) and the host's rest
  profile  only with --profile, after each of prove, prove_hs, prove_split
           and create_proof: one more run of it under torch.profiler (the
           card's idle share; device time by kernel for the prove paths)
  verify   the host pairing verifier accepts sampled proofs of every path and
           rejects a tampered public input

Then the same for AnonymousTransfer (50,514 constraints, d = 65,536), after
the confidential prover is freed, on the CRS of bench.py's anonymous toxic
values and bench_assignments(32):

  anon_crs      AnonymousProver.from_toxic_waste on the card
  anon_witness  the batch's anonymous witness against the CPU's (proofs 0
                and 31), its launches: one var_chain (14 chains a proof),
                three fixed_chain (the fixed-base chains, then the folds in
                two groups), one step launch and three gadget programs
                (at most 17 field-kernel launches, 5 inversions)
  anon_kernels  the kernels at the anonymous shapes, against their plain
                versions: ff.inv at the var chain's normalisation, the var
                chain on the batch's 14 bases and bits, the two fold groups,
                witness.steps.anon and witness.gadgets.anon (program "main"),
                and window_totals, split_lanes / split_tail and bucket_sums
                on the real digits of the G1 chunk and the G2 chunk that
                hold the batch's heaviest bucket; the NTT kernels at
                (8, 32, 65,536), the quotient on the batch's evaluations,
                with the same launch check
  anon_prove, anon_prove_hs, anon_prove_split
                as prove, prove_hs, prove_split, with the same checks; the
                three give the same proofs
  anon_backend  groth16.core.generate_parameters on the AnonymousTransfer
                circuit through TorchBackend: the prover's verifying key, and
                create_proof on assignment 0 equal to anon_prove's proof 0
  anon_verify   the host verifier accepts proofs 0 and 31 of anon_prove and
                one of each other path and of anon_backend, with 104 public
                inputs, and rejects a tampered input

Then, after the anonymous phases and also under --mini, the verifier's side:

  reddsa   batch RedJubjub verification (batch_verify_device): the cases of
           tests/test_redjubjub_batch.py (128 valid signatures, a tampered
           message, a bad s) against the host loop, the 16-entry total before
           the cofactor against the mirror's sum; then a block of 4,096
           signed extrinsics (12,288 chains) in one warm and one timed call,
           seconds split host / device, one var_chain launch, accepted, and
           its copy with entry 2,049 tampered rejected
  reddsa_kernels  the var chain at the block's 12,288 lanes (its first 384
                  against var_chain_plain) and K1 at the tree's first level
  pairing  the BLS12-381 pairing on its two kernels (pairing_kernel.cu: the
           G2 preparation and Miller loop, the final exponentiation; staged
           Fq programs, a warp a pairing): e(G1, G2) and bilinearity against
           the mirror, a 3-pair Miller loop and a final exponentiation, and
           e(A_i, B_i) of prove's proofs (32; under --verify-only, generator
           multiples) in one batched call, each against the mirror; seconds
           and launches at batch 1 and 32: a call must launch each pairing
           kernel once and nothing else (no K1)
  pairing_kernels  pairing.miller / pairing.final_exp at batch 1 (.b1) and 32
                   against their plain versions, the tower chain of K1
                   launches timed once at 32 (k1_loop_ms), and K1 (Fq mul, add,
                   sub, inverse) at the pairing's former shapes (off the path)

Last, except under --mini, --anon-only and --verify-only, the command line
(python -m zerochain_tpu_torch) in a temporary directory:

  cli   wallet recovery from a fixed phrase and add-account bob
        (subprocesses); snark setup --circuit confidential --backend torch
        and tx send --backend torch --amount 30 in this process, launches
        counted and seconds split into the backend's calls and the host's
        rest; chain init / endow 100 / next-block --count 7 and the wallet
        balances as subprocesses: 69 for the sender, pending 30 for bob, 30
        after bob's rollover; the transfer's call on the state before it
        rejected with A and C of its proof swapped and accepted with the
        real proof; an RpcServer over the saved runtime read by RpcClient
        (block number, the sender's nonce 1).  Fails unless setup launched
        the K2 adds (FixedBaseMsm), tx send bucket_sums and bucket_fold, and
        the native codec's C library loaded (it makes the bit planes of
        every scalar that setup and tx send hand to the card).
  cli_launches  the launches of setup and of tx send, by kernel

Then one line {"kernels": [...]} (per kernel: launches on the main path, error
against the plain version, time, the plain version's time, the card's bound),
the card's name and power limit, and last {"ok": true, "device": {...}}.
A field or point kernel's "ms" is its time per launch inside a CUDA graph of
20 launches (the card's own time); "eager_ms" is the time per launch of a
back-to-back loop through the wrapper, which the host's launch cost bounds.

All comparisons are exact (tolerance 0): field kernels and the inverse, the
NTT's transforms and quotient,
point add/double, the ladder, the Horner combine, the bucket fold, the
Jubjub chains, hs_add_select, column_scan and split_lanes on identical
words, window_totals, bucket_sums and split_tail (which add in another order
than their plain versions) after normalisation to affine coordinates.  Each
kernel's launches are counted in the timed run of the path that uses it:
prove for K1-K3, the inverse, the Jubjub chains, the witness kernels and the
NTT at (8, B, d),
prove_hs for bucket_sums and the bucket fold, prove_split for split_lanes and
split_tail, the backend phase's create_proof for the NTT at (8, d), the anon_
runs for the entries at the anonymous shapes, the block's timed verification
for the .reddsa entries and the batched pairing calls at batch 1 and 32 for the
pairing.* entries; hs_add_select, column_scan and K1's .pairing entries are
checked but on no path.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

import torch

# The card's published peaks (NVIDIA H100 SXM data sheet).  Integer rate: the
# data sheet lists 67 TFLOP/s fp32 outside the tensor cores = 33.5e12 fused
# multiply-adds a second; a Hopper SM has half as many int32 lanes as fp32
# lanes, so 16.75e12 32-bit integer multiply-adds (or adds) a second.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 16.75e12

TPU_FF = "zerochain_tpu/ff/pallas_ff.py:157"
TPU_EC = "zerochain_tpu/ec/pallas_ec.py:241"
TPU_TOTALS = "zerochain_tpu/msm/pallas_scan.py:170"
TPU_HS = "zerochain_tpu/ec/pallas_ec.py:315"
TPU_COLUMN_SCAN = "zerochain_tpu/msm/pallas_scan.py:69"

TOXIC = dict(tau=0x1234567890ABCDEF1234, alpha=0x9876543210FEDCBA,
             beta=0x1111111122222222, gamma=0x3333333344444444,
             delta=0x5555555566666666)
MINI_TOXIC = dict(tau=424242, alpha=111, beta=222, gamma=333, delta=444)
# bench.py's AnonymousTransfer CRS
ANON_TOXIC = dict(tau=0xA11CE, alpha=0xB0B, beta=0xCA51, gamma=0xD00D,
                  delta=0xE66)
# the witness stage's launches: one var_chain and one fixed_chain a group
# (the anonymous folds are two more fixed_chain groups), one step launch and
# one launch a gadget program (witness_kernel.cu), and at most k1 field-kernel
# launches (the chains' normalisations and the range checks' to_mont), inv
# of them inversions
WITNESS_LAUNCHES = {
    "mini": dict(jj={"var_chain": 0, "fixed_chain": 1},
                 wit={"steps": 1, "gadgets": 0}, k1=4, inv=1),
    "confidential": dict(jj={"var_chain": 1, "fixed_chain": 1},
                         wit={"steps": 1, "gadgets": 1}, k1=12, inv=3),
    "anonymous": dict(jj={"var_chain": 1, "fixed_chain": 3},
                      wit={"steps": 1, "gadgets": 3}, k1=17, inv=5)}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _demangle(names) -> dict:
    """{mangled: short name}: demangled by c++filt, without namespaces,
    "void " and parameters (the mangled name where c++filt is missing)."""
    names = list(names)
    if not names or not shutil.which("c++filt"):
        return {n: n for n in names}
    plain = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                           capture_output=True, timeout=60).stdout.splitlines()
    if len(plain) != len(names):
        return {n: n for n in names}
    return {n: re.sub(r"^void ", "", p.replace("(anonymous namespace)::", ""))
            .split("(")[0] for n, p in zip(names, plain)}


def ptxas_entries(log: str) -> dict:
    """Each function of an nvcc -Xptxas -v log, kernel entries and device
    functions alike, by its short name (_demangle): its stack frame, spill
    store and spill load bytes, and for an entry its registers
    ("kind": "entry" or "function")."""
    out, cur, entry = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {})["kind"] = "entry"
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            cur.setdefault("kind", "function")
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["stack"], cur["spill"], cur["spill_loads"] = map(int, m.groups())
            cur = None
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
            entry = None
    short = _demangle(out)
    return {short[k]: v for k, v in out.items()}


def sass_size(path) -> dict:
    """{function: SASS instructions} of a built library, by cuobjdump, and
    "total"; None where the toolkit has no cuobjdump."""
    from zerochain_tpu_torch import _build

    exe = shutil.which("cuobjdump") or str(
        pathlib.Path(_build.nvcc_path()).parent / "cuobjdump")
    if not pathlib.Path(exe).exists():
        return None
    sass = subprocess.run([exe, "-sass", str(path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        counts[name] = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/", part, re.M))
    short = _demangle(counts)
    out = {short[k]: v for k, v in counts.items()}
    out["total"] = sum(counts.values())
    return out


def time_ms(fn, reps: int) -> float:
    """Mean time of fn over reps launches, after one warm call."""
    fn()
    return timed(fn, reps)[1]


def timed(fn, reps: int = 1):
    """-> (fn's last result, mean milliseconds) by CUDA events, no warm-up:
    for the plain versions, which run once and are compared as they are."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device time of one fn() among reps captured in one CUDA graph:
    the replay carries no per-launch host work, so this is the kernel's time
    (and its output allocation's, which is none inside a graph)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return timed(graph.replay, replays)[1] / reps


# Fq multiplies of one group operation as (field multiplies, field squarings):
# dbl-2009-l, add-2007-bl, madd-2007-bl.  A G1 coordinate multiply or squaring
# is one Fq multiply; a G2 one is 3 (Karatsuba) or 2 (complex squaring).
GROUP_OPS = {"double": (2, 5), "add": (11, 5), "madd": (7, 4)}
FQ_MUL_OPS = 2 * 12 * 12 + 12  # multiply-adds of one 12-word Montgomery multiply


def group_op_ops(ncomp: int, op: str) -> int:
    """32-bit multiply-adds of one group operation over Fq (1) or Fq2 (2)."""
    n_mul, n_sqr = GROUP_OPS[op]
    per_mul, per_sqr = (3, 2) if ncomp == 2 else (1, 1)
    return (n_mul * per_mul + n_sqr * per_sqr) * FQ_MUL_OPS


def bound_ms(n_bytes: float, n_ops: float):
    by = n_bytes / HBM_BYTES_PER_S * 1e3
    op = n_ops / INT_OPS_PER_S * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def leaves_of(pt):
    out = []
    for c in pt:
        out.extend(c if isinstance(c, tuple) else (c,))
    return out


def max_abs_err(a_leaves, b_leaves) -> float:
    err = 0
    for x, y in zip(a_leaves, b_leaves):
        if x.dtype == torch.bool:
            err = max(err, int((x != y).any()))
        else:
            d = (x.to(torch.int64) & 0xFFFFFFFF) - (y.to(torch.int64) & 0xFFFFFFFF)
            err = max(err, int(d.abs().max()))
    return float(err)


def random_elements(spec, shape, gen):
    """Uniform-ish canonical field elements: random words, the top word
    below p's top word; the first entries are 0, 1 and p - 1."""
    n = spec.n
    words = torch.randint(0, 1 << 32, (n, *shape), generator=gen,
                          device="cuda", dtype=torch.int64)
    top = spec.p >> (32 * (n - 1))
    words[n - 1] = torch.randint(0, top, shape, generator=gen, device="cuda",
                                 dtype=torch.int64)
    out = ((words << 32) >> 32).to(torch.int32)
    flat = out.reshape(n, -1)
    flat[:, :3] = spec.array([0, 1, spec.p - 1], "cuda")
    return out


# ----------------------------------------------------------------------
FF_OPS = ("mont_mul", "mont_sqr", "add", "sub")


def ff_entries(spec, shape, gen, ops=FF_OPS, tag="", path=None, off_path=()):
    """The field kernels ``ops`` on random elements of ``shape`` (p - 1
    planted in b), word for word against their plain versions."""
    from zerochain_tpu_torch.ff import cuda_ff

    a = random_elements(spec, shape, gen)
    b = random_elements(spec, shape, gen)
    b.reshape(spec.n, -1)[:, :3] = spec.array(
        [spec.p - 1, spec.p - 1, spec.p - 1], "cuda")
    count = a[0].numel()
    n = spec.n
    out = []
    for op in ops:
        kern = getattr(cuda_ff, op)
        plain = getattr(cuda_ff, op + "_plain")
        args = (spec, a) if op == "mont_sqr" else (spec, a, b)
        got = kern(*args)
        plain(*args)  # warm: the plain version caches its constants
        want, plain_ms = timed(lambda: plain(*args), 2)
        err = max_abs_err([got], [want])
        n_arrays = 2 if op == "mont_sqr" else 3
        ops_ = (2 * n * n + n) if op.startswith("mont") else 2 * n
        bnd, by = bound_ms(n_arrays * n * 4 * count, ops_ * count)
        e = dict(
            name=f"ff.{op}.{spec.name}{tag}", route="cuda",
            source="zerochain_tpu_torch/csrc/ff_kernels.cu",
            replaces=TPU_FF, counter=("ff", f"{op}.{spec.name}"),
            off_path=op in off_path,
            shape=[n, *shape], equal=err == 0, max_abs_err=err,
            ms=graph_ms(lambda: kern(*args)),
            eager_ms=time_ms(lambda: kern(*args), 20), plain_ms=plain_ms,
            bound_ms=bnd, bound_by=by, library_ms=None)
        if path:
            e["path"] = path
        out.append(e)
    return out


NTT_LIMIT = 15  # NTT kernel launches of one quotient at d <= 2^22


def quotient_inputs(prover, assignments):
    """The quotient's padded evaluations of the batch, (8, B, d) each, as
    ``ConfidentialProver._h_scalars`` hands them to ``ntt.quotient``."""
    inputs_host, witness_fn = prover._witness_fns()
    aux, public = witness_fn(**inputs_host(assignments, prover.device))
    evals = prover.matrices.eval(torch.cat([public, aux], dim=1))
    B = aux.shape[-1]
    pad = torch.zeros((8, prover.d - prover.m, B), dtype=torch.int32,
                      device="cuda")
    return [torch.cat([v, pad], dim=1).movedim(1, -1) for v in evals]


def ntt_transform_ops(lg: int, rows: int, scalings: int) -> int:
    """32-bit multiply-adds of one transform of rows rows of 2^lg elements:
    a Montgomery multiply, an add and a subtract a butterfly, and a multiply
    an element for each pre- or post-scaling."""
    d = 1 << lg
    return lg * (d // 2) * rows * (FR_MUL_OPS + 16) + scalings * d * rows * FR_MUL_OPS


def ntt_entries(prover, shape, gen, path, tag, evals=None, extra=False):
    """The NTT kernels (``ntt/ntt.py`` over ``csrc/ntt_kernel.cu``) at
    ``shape`` = (8, *batch, d) against the plan's plain stage loop, word for
    word: ntt, intt and the quotient (on ``evals``, the batch's own
    evaluations, where given); with ``extra`` also coset_ntt (off every
    path: no path pre-scales), icoset_ntt and divide_by_z_on_coset (off
    every path: the quotient folds 1/Z into its pointwise step).  Then the
    quotient once more with every counter zeroed: more than NTT_LIMIT NTT
    launches (at d <= 2^22), or any K1 launch, fails the run."""
    from zerochain_tpu_torch.ff import cuda_ff
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.ntt import ntt as tntt

    plan = prover.plan
    d, lg = plan.d, plan.lg
    rows = 1
    for n in shape[1:-1]:
        rows *= n
    n_pass = len(tntt.schedule(lg))
    x = random_elements(L.FR, tuple(shape[1:]), gen)
    words = 8 * 4 * rows * d
    one = ntt_transform_ops(lg, rows, 0)
    cases = [("fwd", plan.ntt, plan.ntt_plain, ("pass_fwd",), 0, False),
             ("inv", plan.intt, plan.intt_plain, ("pass_inv",), 1, False)]
    if extra:
        cases += [("coset", plan.coset_ntt, plan.coset_ntt_plain, None, 1, True),
                  ("icoset", plan.icoset_ntt, plan.icoset_ntt_plain,
                   ("pass_inv",), 1, False),
                  ("divide_by_z", plan.divide_by_z_on_coset,
                   plan.divide_by_z_on_coset_plain, None, None, True)]
    out = []
    for name, kern, plain, keys, scalings, off in cases:
        got = kern(x)
        want, plain_ms = timed(lambda: plain(x))
        err = max_abs_err([got], [want])
        if scalings is None:  # one multiply an element
            bnd, by = bound_ms(2 * words, rows * d * FR_MUL_OPS)
        else:
            bnd, by = bound_ms(2 * words, ntt_transform_ops(lg, rows, scalings))
        out.append(dict(
            name=f"ntt.{name}.{tag}", route="cuda",
            source="zerochain_tpu_torch/csrc/ntt_kernel.cu", replaces=TPU_FF,
            counter=None if keys is None else ("ntt", *keys), path=path,
            off_path=off, shape=list(shape), equal=err == 0, max_abs_err=err,
            ms=time_ms(lambda: kern(x), 10), plain_ms=plain_ms, bound_ms=bnd,
            bound_by=by, library_ms=None,
            passes=0 if scalings is None else n_pass))
    if evals is None:
        evals = [random_elements(L.FR, tuple(shape[1:]), gen) for _ in range(3)]
    got = tntt.quotient(plan, *evals)
    want, plain_ms = timed(lambda: plan.quotient_plain(*evals))
    err = max_abs_err([got], [want])
    # 7 transforms, 4 vector scalings (3 n^-1 g^i, 1 n^-1 g^-i), and
    # (a b - c) / Z: two multiplies and a subtract an element
    ops = 7 * one + 4 * rows * d * FR_MUL_OPS + rows * d * (2 * FR_MUL_OPS + 16)
    bnd, by = bound_ms(4 * words, ops)
    reset_counters()
    tntt.quotient(plan, *evals)
    torch.cuda.synchronize()
    n_ntt = sum(tntt.launches.values())
    n_k1 = sum(cuda_ff.launches.values())
    out.append(dict(
        name=f"ntt.quotient.{tag}", route="cuda",
        source="zerochain_tpu_torch/csrc/ntt_kernel.cu", replaces=TPU_FF,
        counter=("ntt", "pass_fwd", "pass_inv", "pointwise"), path=path,
        shape=list(shape), equal=err == 0, max_abs_err=err,
        ms=time_ms(lambda: tntt.quotient(plan, *evals), 5), plain_ms=plain_ms,
        bound_ms=bnd, bound_by=by, library_ms=None, passes=n_pass,
        quotient_launches=n_ntt, quotient_k1_launches=n_k1))
    if (lg <= 22 and n_ntt > NTT_LIMIT) or n_k1:
        raise SystemExit(f"ntt.quotient.{tag}: {n_ntt} NTT kernel launches "
                         f"(at most {NTT_LIMIT}) and {n_k1} K1 launches (none)")
    return out


def phase_kernels(prover, B, gen, assignments):
    from zerochain_tpu_torch.ec import cuda_ec
    from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.msm import cuda_scan
    from zerochain_tpu_torch.msm import pippenger as pip

    entries = []

    # ---- K1: field kernels.  Fr/Fs at one NTT butterfly stage of the
    # batch, (8, B, d/2); Fq at the H query's normalisation, (12, d).
    d = prover.d
    shapes = {"Fq": (d,), "Fr": (B, d // 2), "Fs": (B, d // 2)}
    # the prover has no Fs op; since the inverse is one kernel, no path
    # squares in Fr; since the quotient runs on the NTT kernels and the
    # witness's gadgets on witness_kernel.cu, no path subtracts in Fr
    fr_off = ("mont_sqr", "sub")
    for spec in (L.FQ, L.FR, L.FS):
        entries += ff_entries(spec, shapes[spec.name], gen, off_path=(
            FF_OPS if spec.name == "Fs" else fr_off if spec.name == "Fr" else ()))

    # ---- K2: point add / double on real CRS points (arbitrary Z), at the
    # path's shapes: B points (the assembly's adds), 3B (its widest chain),
    # and windows x B (the per-chunk accumulate), with the cases P = inf,
    # Q = inf, P = Q, P = -Q planted at the front.  No path doubles through
    # this kernel any more (the chains run in the ladder and Horner
    # kernels): the doubling entries are checked, not counted.
    for F, raw, tag in ((FqOps, prover._raw_queries[0], "g1"),
                        (Fq2Ops, prover._raw_queries[4], "g2")):
        sizes = (B, 3 * B, prover.msm_g1.n_windows * B) if tag == "g1" else (
            B, prover.msm_g2.n_windows * B)
        for n_pts in (max(n, 5) for n in sizes):  # room for the planted cases
            p, q = planted_pairs(F, raw, n_pts)
            for op, n_in in (("add", 2), ("double", 1)):
                if op == "double" and n_pts > 3 * B:
                    continue
                kern = getattr(cuda_ec, op)
                plain = getattr(cuda_ec, op + "_plain")
                args = (F, p, q) if op == "add" else (F, p)
                got = kern(*args)
                want, plain_ms = timed(lambda: plain(*args))
                err = max_abs_err(leaves_of(got), leaves_of(want))
                words = 3 * F.ncomp * 12
                bnd, by = bound_ms((n_in + 1) * words * 4 * n_pts,
                                   group_op_ops(F.ncomp, op) * n_pts)
                entries.append(dict(
                    name=f"ec.{tag}_{op}.{n_pts}", route="cuda",
                    source="zerochain_tpu_torch/csrc/ec_kernels.cu",
                    replaces=TPU_EC, counter=("ec", f"{tag}_{op}"),
                    off_path=op == "double",
                    shape=[12, n_pts], equal=err == 0, max_abs_err=err,
                    ms=graph_ms(lambda: kern(*args)),
                    eager_ms=time_ms(lambda: kern(*args), 20),
                    plain_ms=plain_ms,
                    bound_ms=bnd, bound_by=by, library_ms=None))

    entries += chain_entries(prover, B, gen)
    entries += witness_entries(prover, B, gen, assignments)
    entries += gadget_entries(prover, B, assignments)

    # ---- the NTT: prove's quotient at (8, B, d) on the batch's own
    # evaluations, and create_proof's at (8, d) (TorchBackend, B = 1)
    entries += ntt_entries(prover, (8, B, d), gen, "prove", "prove",
                           evals=quotient_inputs(prover, assignments), extra=True)
    entries += ntt_entries(prover, (8, d), gen, "backend", "backend")

    # ---- K3: window_totals on one CRS chunk, all windows x B programs in
    # one launch, uniform and zero-heavy digits; P = Q, P = -Q planted at the
    # head of the first two threads' slices (the chunks carry zero padding).
    for F, msm, chunk, tag in (
            (FqOps, prover.msm_g1, prover.h_chunks[0], "g1"),
            (Fq2Ops, prover.msm_g2, prover.b2_chunks[0], "g2")):
        N = pip.first_leaf(chunk).shape[-1]
        for dist in ("uniform", "zero_heavy"):
            scal = random_elements(L.FR, (N, B), gen)
            if dist == "zero_heavy":  # most witness values are 0 or 1
                r = torch.rand((N, B), generator=gen, device="cuda")
                small = (r < 0.45).to(torch.int32)
                scal = torch.where((r < 0.9)[None], torch.zeros_like(scal), scal)
                scal[0] = torch.where(r < 0.9, small, scal[0])
            sd, od = msm.prep(msm.digits(scal))
            if dist == "uniform":  # at the head of the first two slices
                nnz0 = int((sd[0, 0] != 0).sum())
                run_len = -(-nnz0 // cuda_scan.row_threads(nnz0))
                od[..., 1] = od[..., 0]
                sd[..., 1] = sd[..., 0]
                od[..., run_len + 1] = od[..., run_len]
                sd[..., run_len + 1] = -sd[..., run_len]
            entries.append(totals_entry(F, msm, [chunk], [(sd, od)],
                                        f"{tag}.{dist}"))

    # ---- K3 on the real digits of one batch: the five MSMs' preps of the
    # batch the prove phase proves (B1 and B2 share theirs)
    entries += real_totals_entries(prover, assignments)

    entries += bucket_entries(prover, B, gen, assignments)
    entries += hs_entries(prover, B, gen)
    entries += column_scan_entries(prover, B, gen)
    entries += split_entries(prover, B, gen, assignments)
    entries += width_entries(prover, gen)
    return entries


def planted_pairs(F, raw, n_pts):
    """n_pts pairs of CRS points (p, q) with P = inf at 0, P = Q at 1,
    P = -Q at 2, Q = inf at 3, both inf at 4."""
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.msm import pippenger as pip

    avail = pip.first_leaf(raw).shape[-1]
    idx = torch.arange(n_pts, device="cuda")
    p = pip.tmap(lambda t: t[:, idx % avail].clone(), raw)
    q = pip.tmap(lambda t: t[:, (idx * 7 + 3) % avail].clone(), raw)
    ident = W.identity(F, (1,), "cuda")
    negq = W.neg(F, q)
    for k, src in ((0, ident), (3, ident)):      # P = inf at 0, Q = inf at 3
        tgt = p if k == 0 else q
        for t, s in zip(leaves_of(tgt), leaves_of(src)):
            t[:, k] = s[:, 0]
    for t, s in zip(leaves_of(p), leaves_of(q)):  # P = Q at 1
        t[:, 1] = s[:, 1]
    for t, s in zip(leaves_of(p), leaves_of(negq)):  # P = -Q at 2
        t[:, 2] = s[:, 2]
    for t in leaves_of(p)[-F.ncomp:] + leaves_of(q)[-F.ncomp:]:
        t[:, 4] = 0                                # both inf at 4
    return p, q


def chain_entries(prover, B, gen):
    """The chain kernels at the path's shapes, exact against their plain
    versions, with the one-lane form (lanes=1) checked and timed beside the
    path's: the ladder at 3B and 2B G1 points and B G2 points, 255 bits, with
    an identity base, all-zero bits and all-one bits planted; the Horner
    combine at nw windows x B, c = 8, with 2^c * res equal to the next
    window's total (the add doubles) and to its negative on two points."""
    from zerochain_tpu_torch.ec import cuda_ec
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
    from zerochain_tpu_torch.msm import pippenger as pip

    out = []
    words_of = lambda F: 3 * F.ncomp * 12  # noqa: E731
    step_ops = lambda F: (group_op_ops(F.ncomp, "add")  # noqa: E731
                          + group_op_ops(F.ncomp, "double"))
    for F, raw, n_pts, tag in ((FqOps, prover._raw_queries[0], 3 * B, "g1"),
                               (FqOps, prover._raw_queries[0], 2 * B, "g1"),
                               (Fq2Ops, prover._raw_queries[4], max(B, 3), "g2")):
        avail = pip.first_leaf(raw).shape[-1]
        idx = (torch.arange(n_pts, device="cuda") * 5 + 1) % avail
        base = W.add(F, pip.tmap(lambda t: t[:, idx].clone(), raw),
                     pip.tmap(lambda t: t[:, (idx * 3 + 2) % avail].clone(), raw))
        for t in leaves_of(base)[-F.ncomp:]:
            t[:, 0] = 0                                   # identity base
        bits = torch.randint(0, 2, (255, n_pts), generator=gen, device="cuda",
                             dtype=torch.int32)
        bits[:, 1] = 0
        bits[:, 2] = 1
        out.append(chain_entry(
            F, f"ec.ladder.{tag}.{n_pts}", f"{tag}_ladder", [12, n_pts],
            lambda lanes=None: cuda_ec.ladder(F, base, bits, lanes=lanes),
            lambda: cuda_ec.ladder_plain(F, base, bits),
            n_bytes=2 * words_of(F) * 4 * n_pts + 255 * n_pts,
            n_ops=255 * n_pts * step_ops(F)))
    for F, raw, msm, tag in ((FqOps, prover._raw_queries[0], prover.msm_g1, "g1"),
                             (Fq2Ops, prover._raw_queries[4], prover.msm_g2, "g2")):
        nw, c = msm.n_windows, msm.c
        avail = pip.first_leaf(raw).shape[-1]
        idx = torch.arange(nw * B, device="cuda") % avail
        tot = W.add(F, pip.tmap(lambda t: t[:, idx].reshape(12, nw, B), raw),
                    pip.tmap(lambda t: t[:, (idx * 7 + 3) % avail]
                             .reshape(12, nw, B), raw))
        top = pip.tmap(lambda t: t[:, nw - 1], tot)
        for _ in range(c):
            top = cuda_ec.double_plain(F, top)
        for t, d, nd in zip(leaves_of(tot), leaves_of(top),
                            leaves_of(W.neg(F, top))):
            t[:, nw - 2, 0] = d[:, 0]                     # the add doubles
            t[:, nw - 2, 1] = nd[:, 1]                    # the add gives inf
        out.append(chain_entry(
            F, f"ec.horner.{tag}", f"{tag}_horner", [12, nw, B],
            lambda lanes=None: cuda_ec.horner(F, tot, c, lanes=lanes),
            lambda: cuda_ec.horner_plain(F, tot, c),
            n_bytes=(nw + 1) * words_of(F) * 4 * B,
            n_ops=(nw - 1) * B * (c * group_op_ops(F.ncomp, "double")
                                  + group_op_ops(F.ncomp, "add"))))
    return out


def chain_entry(F, name, counter, shape, kern, plain, n_bytes, n_ops):
    want, plain_ms = timed(plain)
    err = max_abs_err(leaves_of(kern()), leaves_of(want))
    err_one = max_abs_err(leaves_of(kern(1)), leaves_of(want))
    bnd, by = bound_ms(n_bytes, n_ops)
    return dict(
        name=name, route="cuda", source="zerochain_tpu_torch/csrc/ec_kernels.cu",
        replaces=TPU_EC, counter=("ec", counter), shape=shape,
        equal=err == 0 and err_one == 0, max_abs_err=max(err, err_one),
        ms=time_ms(kern, 3), one_lane_ms=time_ms(lambda: kern(1), 3),
        plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=None)


FR_MUL_OPS = 2 * 8 * 8 + 8  # multiply-adds of one 8-word Montgomery multiply


def fermat_muls(spec) -> int:
    """Multiplies of one Fermat inverse a^(p-2), MSB first: a squaring for
    every bit after the leading one, a multiply for every further one bit."""
    e = spec.p - 2
    return (e.bit_length() - 1) + (bin(e).count("1") - 1)


def witness_entries(prover, B, gen, assignments):
    """The witness stage's kernels at its shapes: ff.inv (Fr at the largest
    stack the witness normalises, 252 steps x 5 chains x B; Fq at the
    assembly's B; Fs, off every path, at the Fr shape) with zeros and ones
    planted; the variable-base Jubjub chains (5 chains x B lanes x 252 bits,
    bases the batch's own points, an all-zero and an all-one lane) and the
    fixed-base chains (6 chains x B lanes x 84 windows of the table); each
    chain also against its former loop of field-kernel launches (k1_loop_ms).
    "ms" is one launch timed by CUDA events; us_per_mul = ms over the serial
    multiplies of one thread, the latency reading of a serial chain."""
    from zerochain_tpu_torch.ec import cuda_jubjub
    from zerochain_tpu_torch.ec import jubjub as ej
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.prover import witness as wit

    n_bits = 252
    out = [inv_entry(spec, shape, gen, off)
           for spec, shape, off in ((L.FR, (n_bits * 5 * B,), False),
                                    (L.FQ, (max(B, 3),), False),
                                    (L.FS, (n_bits * 5 * B,), True))]

    # variable-base chains: the batch's own Jubjub points as bases (those of
    # the ConfidentialTransfer batch under --mini, whose MiniCommit witness
    # runs no variable-base chain)
    mini = "pgk" not in assignments[0]
    if mini:
        assignments = assignments_for(B, False)
    ins = wit.witness_inputs_host(assignments, "cuda")
    pts = [ins[k] for k in ("ekr", "ebl", "ebr", "pgk", "gep")]
    bases = (torch.stack([p[0] for p in pts], dim=1),
             torch.stack([p[1] for p in pts], dim=1))        # (8, 5, B)
    bits = torch.randint(0, 2, (n_bits, 5, B), generator=gen, device="cuda",
                         dtype=torch.int64)
    bits[:, 0, 0] = 0
    bits[:, 1, B - 1] = 1
    lanes = 5 * B
    var_muls = 1 + n_bits * 9 + (n_bits - 1) * 8  # T, the adds, the doubles
    out.append(jubjub_entry(
        "var_chain", [8, n_bits, 5, B],
        lambda: cuda_jubjub.var_chain(bases, bits),
        lambda: cuda_jubjub.var_chain_plain(bases, bits),
        lambda: cuda_jubjub.var_chain_plain(bases, bits, ej.KERNEL_OPS),
        n_bytes=2 * 8 * 4 * lanes + n_bits * lanes + 2 * 3 * 8 * 4 * n_bits * lanes,
        serial=var_muls, lanes=lanes))
    out[-1]["off_path"] = mini

    # fixed-base chains: window points of the table, digit 0 on one chain
    n_win, nc = 84, 6
    digits = torch.randint(0, 8, (n_win, nc, B), generator=gen, device="cuda")
    digits[:, 2, 0] = 0
    tx, ty = wit._table_mont("cuda")
    idx = (digits + 8 * torch.arange(n_win, device="cuda").reshape(n_win, 1, 1))
    lx = tx.index_select(1, idx.reshape(-1)).reshape(8, n_win, nc, B)
    ly = ty.index_select(1, idx.reshape(-1)).reshape(8, n_win, nc, B)
    lanes = nc * B
    out.append(jubjub_entry(
        "fixed_chain", [8, n_win, nc, B],
        lambda: cuda_jubjub.fixed_chain(lx, ly),
        lambda: cuda_jubjub.fixed_chain_plain(lx, ly),
        lambda: cuda_jubjub.fixed_chain_plain(lx, ly, ej.KERNEL_OPS),
        n_bytes=2 * 8 * 4 * n_win * lanes + 3 * 8 * 4 * (n_win - 1) * lanes,
        serial=1 + (n_win - 1) * 10, lanes=lanes))  # a window's T, an add's 9
    return out


def inv_entry(spec, shape, gen, off_path, tag=""):
    """ff.inv on random elements of ``shape`` with zeros and Montgomery ones
    planted, word for word against inv_plain."""
    from zerochain_tpu_torch.ff import cuda_ff

    a = random_elements(spec, shape, gen)
    flat = a.reshape(spec.n, -1)
    flat[:, 5::97] = 0                            # planted zeros
    flat[:, 6::89] = spec.array([spec.r_mod_p], "cuda")  # Montgomery ones
    got = cuda_ff.inv(spec, a)
    cuda_ff.inv_plain(spec, a)  # warm: the plain version caches its constants
    want, plain_ms = timed(lambda: cuda_ff.inv_plain(spec, a))
    err = max_abs_err([got], [want])
    count = flat.shape[1]
    muls = fermat_muls(spec)
    bnd, by = bound_ms(2 * spec.n * 4 * count,
                       muls * (2 * spec.n ** 2 + spec.n) * count)
    ms = time_ms(lambda: cuda_ff.inv(spec, a), 3)
    return dict(
        name=f"ff.inv.{spec.name}{tag}", route="cuda",
        source="zerochain_tpu_torch/csrc/ff_kernels.cu", replaces=TPU_FF,
        counter=("ff", f"inv.{spec.name}"), off_path=off_path,
        shape=[spec.n, *shape], equal=err == 0, max_abs_err=err, ms=ms,
        serial_mul=muls, us_per_mul=ms * 1e3 / muls, plain_ms=plain_ms,
        bound_ms=bnd, bound_by=by, library_ms=None)


def gadget_entries(prover, B, assignments, tag="", path=None):
    """The witness's step kernel (W1) and gadget program (W2, program
    "main") at the path's shapes, on the batch's own witness up to them
    (confidential_setup / anonymous_setup: host rows and normalised
    chains): each kernel on all B proofs, its plain version on proofs 0 and
    B - 1, word for word over the whole aux of those proofs.  Bounds: W1
    the point entries and bits it reads and the rows it writes, W2 the rows
    it loads and stores, or their multiplies (a Fermat power as its
    multiplies), whichever is larger."""
    import dataclasses

    from zerochain_tpu_torch.prover import MiniProver
    from zerochain_tpu_torch.prover import cuda_witness as cw
    from zerochain_tpu_torch.prover import witness as wit
    from zerochain_tpu_torch.prover import witness_anon as wa

    if tag == ".anon":
        plan, aux, jobs = wa.anonymous_setup(**wa.witness_inputs_host(assignments, "cuda"))
    else:
        if "pgk" not in assignments[0]:  # --mini: the ConfidentialTransfer batch
            assignments = assignments_for(B, False)
        plan, aux, jobs = wit.confidential_setup(**wit.witness_inputs_host(assignments,
                                                                            "cuda"))
    picks = [0, B - 1]
    word = 8 * 4  # bytes of an Fr element
    mini = isinstance(prover, MiniProver)

    def two(t):
        return None if t is None else t[..., picks].contiguous()

    # ---- W1
    few = [dataclasses.replace(j, points=tuple(two(t) for t in j.points), data=two(j.data))
           for j in jobs]
    want = aux[..., picks].clone()
    cw.steps_plain(few, want)  # warm: the plain ops cache their constants
    want = aux[..., picks].clone()
    _, plain_ms = timed(lambda: cw.steps_plain(few, want))
    cw.steps(jobs, aux)
    err = max_abs_err([aux[..., picks]], [want])
    muls = {cw.VAR: 9, cw.FIXED: 5, cw.FOLD: 5}
    n_bytes = n_ops = 0
    for j in jobs:
        n = j.n_steps
        reads = 4 * n - (2 if j.kind == cw.FIXED else 0)  # FIXED: n - 1 sums
        n_bytes += (reads * word + (n if j.data is not None else 0)
                    + j.n_rows * word) * B
        n_ops += (n - (j.kind != cw.FOLD)) * muls[j.kind] * FR_MUL_OPS * B
    bnd, by = bound_ms(n_bytes, n_ops)
    out = [dict(
        name="witness.steps" + tag, route="cuda",
        source="zerochain_tpu_torch/csrc/witness_kernel.cu", replaces=TPU_FF,
        counter=("wit", "steps"), shape=[8, plan.n_aux, B], jobs=len(jobs),
        equal=err == 0, max_abs_err=err, ms=graph_ms(lambda: cw.steps(jobs, aux)),
        eager_ms=time_ms(lambda: cw.steps(jobs, aux), 20), plain_ms=plain_ms,
        plain_lanes=len(picks), bound_ms=bnd, bound_by=by, library_ms=None)]

    # ---- W2, program "main"
    prog = plan.programs["main"]
    want = aux[..., picks].clone()
    cw.gadgets_plain(prog, want)
    want = aux[..., picks].clone()
    _, plain_ms = timed(lambda: cw.gadgets_plain(prog, want))
    cw.gadgets(prog, aux)
    err = max_abs_err([aux[..., picks]], [want])
    c = prog.counts
    n_bytes = (c["load"] + c["store"]) * word * B
    n_ops = (c["mul"] + c["inv"] * fermat_muls(wit.FR)) * FR_MUL_OPS * B
    bnd, by = bound_ms(n_bytes, n_ops)
    out.append(dict(
        name="witness.gadgets" + tag, route="cuda",
        source="zerochain_tpu_torch/csrc/witness_kernel.cu", replaces=TPU_FF,
        counter=("wit", "gadgets"), off_path=mini, shape=[8, plan.n_aux, B],
        program="main", stages=c["stages"], slots=c["slots"],
        fermat_powers=c["inv"], equal=err == 0, max_abs_err=err,
        ms=graph_ms(lambda: cw.gadgets(prog, aux)),
        eager_ms=time_ms(lambda: cw.gadgets(prog, aux), 20), plain_ms=plain_ms,
        plain_lanes=len(picks), bound_ms=bnd, bound_by=by, library_ms=None))
    if path:
        for e in out:
            e["path"] = path
    return out


def jubjub_entry(name, shape, kern, plain, k1_loop, n_bytes, serial, lanes,
                 counter=None):
    """A Jubjub chain kernel against its plain version and its former loop
    of field-kernel launches, word for word."""
    leaves = lambda r: list(r) if isinstance(r, tuple) else [r]  # noqa: E731
    want, plain_ms = timed(plain)
    err = max_abs_err(leaves(kern()), leaves(want))
    loop, k1_loop_ms = timed(k1_loop)
    err = max(err, max_abs_err(leaves(loop), leaves(want)))
    ms = time_ms(kern, 3)
    bnd, by = bound_ms(n_bytes, serial * FR_MUL_OPS * lanes)
    return dict(
        name=f"jubjub.{name}", route="cuda",
        source="zerochain_tpu_torch/csrc/jubjub_kernels.cu", replaces=TPU_FF,
        counter=("jj", counter or name), shape=shape, equal=err == 0,
        max_abs_err=err,
        ms=ms, serial_mul=serial, us_per_mul=ms * 1e3 / serial,
        k1_loop_ms=k1_loop_ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
        library_ms=None)


def phase_witness(prover, assignments, B, expected, phase="witness"):
    """The batch's witness on the card, launches counted around it, against
    the CPU plain path's for the first and the last proof, word for word;
    the launches must be as ``expected`` says (WITNESS_LAUNCHES)."""
    from zerochain_tpu_torch.ec import cuda_ec, cuda_jubjub
    from zerochain_tpu_torch.ff import cuda_ff
    from zerochain_tpu_torch.msm import cuda_scan
    from zerochain_tpu_torch.prover import cuda_witness

    inputs_host, witness_fn = prover._witness_fns()
    witness_fn(**inputs_host(assignments, prover.device))  # warm
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    aux, public = witness_fn(**inputs_host(assignments, prover.device))
    torch.cuda.synchronize()
    secs = time.time() - t0
    ff = {k: v for k, v in cuda_ff.launches.items() if v}
    jj = dict(cuda_jubjub.launches)
    wit = dict(cuda_witness.launches)
    others = sum(cuda_ec.launches.values()) + sum(cuda_scan.launches.values())
    picks = [0, B - 1]
    t0 = time.time()
    caux, cpub = witness_fn(**inputs_host([assignments[b] for b in picks], "cpu"))
    cpu_s = time.time() - t0
    equal = (torch.equal(aux[:, :, picks].cpu(), caux)
             and torch.equal(public[:, :, picks].cpu(), cpub))
    k1 = sum(ff.values())
    k1_inv = sum(v for k, v in ff.items() if k.startswith("inv."))
    emit(phase, batch=B, seconds=secs, cpu_seconds_two_proofs=cpu_s,
         aux=list(aux.shape), k1_launches=k1, k1_launches_inv=k1_inv,
         k1_by_op=ff, jubjub_launches=jj, witness_launches=wit,
         other_launches=others, equal_to_cpu=equal, proofs_checked=picks)
    if not equal:
        raise SystemExit(f"{phase}: the card's aux/public differ from the CPU's")
    if jj != expected["jj"] or wit != expected["wit"]:
        raise SystemExit(f"{phase}: chain / witness kernel launches {jj} / {wit}, "
                         f"expected {expected['jj']} / {expected['wit']}")
    if k1 > expected["k1"] or k1_inv > expected["inv"]:
        raise SystemExit(f"{phase}: {k1} field-kernel launches, {k1_inv} inversions; "
                         f"at most {expected['k1']} and {expected['inv']}")
    return k1


def totals_entry(F, msm, chunks, preps, tag, proofs=None):
    """K3 over a list of chunks with their (sorted digits, order): exact
    after normalisation, on every program, or on those of the first
    `proofs` proofs (the plain version takes seconds a chunk); ms is the sum
    of one launch per chunk over all programs, and the bound counts one
    mixed add per non-zero digit and one add per magnitude drop of these
    digits."""
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.msm import cuda_scan
    from zerochain_tpu_torch.msm import pippenger as pip

    err, plain_ms, ms = 0.0, 0.0, 0.0
    nonzero = drops = n_bytes = 0
    all_inf = True
    for chunk, (sd, od) in zip(chunks, preps):
        N = pip.first_leaf(chunk).shape[-1]
        got = cuda_scan.window_totals(F, chunk, sd, od, msm.nb)
        k = sd.shape[1] if proofs is None else proofs  # (nw, B, N) programs
        want, p_ms = timed(lambda: cuda_scan.window_totals_plain(
            F, chunk, sd[:, :k], od[:, :k], msm.nb))
        got = pip.tmap(lambda t: t[:, :, :k], got)
        gx, gy, ginf = W.normalize(F, got)
        wx, wy, winf = W.normalize(F, want)
        err = max(err, max_abs_err(leaves_of((gx, gy)) + [ginf],
                                   leaves_of((wx, wy)) + [winf]))
        all_inf = all_inf and bool(ginf.all())
        plain_ms += p_ms
        ms += time_ms(lambda: cuda_scan.window_totals(
            F, chunk, sd, od, msm.nb), 3)
        mag = sd.abs()
        nonzero += int((mag != 0).sum())
        nxt = torch.cat([mag[..., 1:], torch.zeros_like(mag[..., :1])], -1)
        drops += int((mag > nxt).sum())
        words = 3 * F.ncomp * 12
        n_bytes += words * 4 * N + 2 * 4 * sd.numel() + words * 4 * (sd.numel() // N)
    bnd, by = bound_ms(n_bytes, nonzero * group_op_ops(F.ncomp, "madd")
                       + drops * group_op_ops(F.ncomp, "add"))
    rows = torch.cat([(sd != 0).sum(-1).reshape(-1) for sd, _ in preps]).float()
    qs = torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0], device=rows.device)
    sd0 = preps[0][0]
    return dict(
        name=f"msm.window_totals.{tag}", route="cuda",
        source="zerochain_tpu_torch/csrc/totals_kernel.cu",
        replaces=TPU_TOTALS, counter=("scan", f"{tag[:2]}_window_totals"),
        shape=[len(preps), list(sd0.shape)], equal=err == 0, max_abs_err=err,
        nonzero_digits=nonzero,
        row_nonzero_q=[int(x) for x in torch.quantile(rows, qs)],
        all_infinity=all_inf, ms=ms, plain_ms=plain_ms,
        bound_ms=bnd, bound_by=by, library_ms=None)


def real_totals_entries(prover, assignments):
    """K3 on the digits one prove batch gives it: witness, quotient and the
    five MSMs' preps of the batch, each chunk with its CRS points; checked
    on the programs of the first 8 proofs of every chunk."""
    from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops

    inputs_host, witness_fn = prover._witness_fns()
    aux, public = witness_fn(**inputs_host(assignments, prover.device))
    wm, hs = prover._quotient(aux, public)
    a_p, b1_p, b2_p, l_p, h_p = prover._digits(wm, hs)
    g1_chunks = (list(prover.a_chunks) + list(prover.b1_chunks)
                 + list(prover.l_chunks) + list(prover.h_chunks))
    g1_preps = list(a_p) + list(b1_p) + list(l_p) + list(h_p)
    return [totals_entry(FqOps, prover.msm_g1, g1_chunks, g1_preps, "g1.real",
                         proofs=8),
            totals_entry(Fq2Ops, prover.msm_g2, list(prover.b2_chunks),
                         list(b2_p), "g2.real", proofs=8)]


def _set_at(dst, idx, src):
    """dst[..., idx] = src[..., idx] on every coordinate tensor."""
    for t, u in zip(leaves_of(dst), leaves_of(src)):
        t[idx] = u[idx]


def hs_entries(prover, B, gen):
    """P3's port as an op, off every path since the bucket MSM runs
    bucket_sums: one Hillis-Steele level over 4 windows x B x one chunk of
    partial sums (arbitrary Z), with P = Q, P = -Q and identities planted
    behind the level's distance s."""
    from zerochain_tpu_torch.ec import cuda_ec
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
    from zerochain_tpu_torch.msm import pippenger as pip

    out = []
    for F, chunk, tag in ((FqOps, prover.h_chunks[0], "g1"),
                          (Fq2Ops, prover.b2_chunks[0], "g2")):
        N = pip.first_leaf(chunk).shape[-1]
        wg = 4  # the JAX Msm's default window group
        shape = (wg, B, N)

        def pick():
            i = torch.randint(0, N, shape, generator=gen, device="cuda")
            return pip.tmap(
                lambda t: t.index_select(1, i.reshape(-1)).reshape(12, *shape),
                chunk)

        x = W.add(F, pick(), pick())  # partial sums; zero padding included
        s = min(64, N // 2)
        xl = pip.tmap(lambda t: torch.roll(t, s, dims=-1), x)
        at = (slice(None), 0, 0)
        _set_at(xl, (*at, s + 1), x)                          # P = Q
        _set_at(xl, (*at, s + 2), W.neg(F, x))                # P = -Q
        ident = W.identity(F, shape, "cuda")
        _set_at(xl, (*at, s + 3), ident)                      # xl = inf
        _set_at(x, (*at, s + 4), ident)                       # x = inf
        f = torch.rand(shape, generator=gen, device="cuda") < 0.05
        f[0, 0, s + 1: s + 5] = False
        keep = torch.arange(N, device="cuda") < s
        got = cuda_ec.hs_add_select(F, xl, x, f, keep)
        # the plain version window by window: its temporaries at the whole
        # group would take tens of GB for G2
        want, plain_ms = timed(lambda: pip.tcat([
            cuda_ec.hs_add_select_plain(
                F, pip.tmap(lambda t: t[:, w: w + 1], xl),
                pip.tmap(lambda t: t[:, w: w + 1], x), f[w: w + 1], keep)
            for w in range(wg)], 1))
        err = max_abs_err(leaves_of(got), leaves_of(want))
        # the function adds (and reads xl) only where neither mask is set:
        # count those from this level's masks; x, out and the masks are
        # moved for every point
        pts = f.numel()
        n_add = int((~(f | keep)).sum())
        words = 3 * F.ncomp * 12
        bnd, by = bound_ms((2 * words * 4 + 2) * pts + words * 4 * n_add,
                           group_op_ops(F.ncomp, "add") * n_add)
        out.append(dict(
            name=f"ec.hs_add_select.{tag}", route="cuda",
            source="zerochain_tpu_torch/csrc/hs_kernel.cu",
            replaces=TPU_HS, counter=("ec", f"{tag}_hs_add_select"),
            path="prove_hs", off_path=True, shape=[12, *shape], n_add=n_add,
            equal=err == 0, max_abs_err=err,
            ms=time_ms(lambda: cuda_ec.hs_add_select(F, xl, x, f, keep), 3),
            plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=None))
    return out


def bucket_sums_entry(F, pairs, nb, tag, check_rows, B):
    """bucket_sums over (chunk, (keys, order)) pairs, held against
    bucket_sums_plain after normalisation on the rows check_rows of every
    pair and on the pair's row that holds its heaviest bucket (the plain
    version's Hillis-Steele temporaries take seconds a chunk); ms is the sum
    of one launch per pair over all rows.  The bound counts one full add per
    non-zero digit that is not the first of its bucket; heaviest_bucket is
    the largest bucket of any row and where it lies (pair, window, proof,
    digit)."""
    from zerochain_tpu_torch.ec import cuda_ec
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.msm import pippenger as pip

    err, plain_ms, ms = 0.0, 0.0, 0.0
    nonzero = n_add = n_bytes = rows_checked = 0
    heaviest = (0, None)
    for k, (chunk, (ks, od)) in enumerate(pairs):
        N = pip.first_leaf(chunk).shape[-1]
        M = ks.shape[0]
        cnt = torch.zeros((M, nb), dtype=torch.int64, device=ks.device)
        cnt.scatter_add_(1, ks.to(torch.int64), torch.ones_like(ks, dtype=torch.int64))
        c1 = cnt[:, 1:]
        nonzero += int(c1.sum())
        n_add += int(c1.sum() - (c1 > 0).sum())
        top = int(c1.max())
        row, v = divmod(int(c1.argmax()), nb - 1)
        if top > heaviest[0]:
            heaviest = (top, dict(pair=k, window=row // B, proof=row % B,
                                  digit=v + 1))
        rows = torch.unique(torch.cat([check_rows, check_rows.new_tensor([row])]))
        rows_checked += rows.numel()
        got = cuda_ec.bucket_sums(F, chunk, ks, od, nb)
        want, p_ms = timed(lambda: cuda_ec.bucket_sums_plain(
            F, chunk, ks[rows], od[rows], nb))
        got = pip.tmap(lambda t: t[:, rows], got)
        gx, gy, ginf = W.normalize(F, got)
        wx, wy, winf = W.normalize(F, want)
        err = max(err, max_abs_err(leaves_of((gx, gy)) + [ginf],
                                   leaves_of((wx, wy)) + [winf]))
        plain_ms += p_ms
        ms += time_ms(lambda: cuda_ec.bucket_sums(F, chunk, ks, od, nb), 3)
        words = 3 * F.ncomp * 12
        n_bytes += words * 4 * N + 2 * 4 * M * N + words * 4 * M * nb
    bnd, by = bound_ms(n_bytes, n_add * group_op_ops(F.ncomp, "add"))
    ks0 = pairs[0][1][0]
    return dict(
        name=f"msm.bucket_sums.{tag}", route="cuda",
        source="zerochain_tpu_torch/csrc/hs_kernel.cu", replaces=TPU_HS,
        counter=("ec", f"{tag[:2]}_bucket_sums"), path="prove_hs",
        shape=[len(pairs), list(ks0.shape), nb], equal=err == 0,
        max_abs_err=err, nonzero_digits=nonzero, n_add=n_add,
        heaviest_bucket=heaviest[0], heaviest_at=heaviest[1],
        rows_checked=rows_checked, ms=ms, plain_ms=plain_ms,
        bound_ms=bnd, bound_by=by, library_ms=None)


def bucket_entries(prover, B, gen, assignments):
    """The bucket MSM's kernels at the 'hs' path's shapes (all 32 windows x
    B rows of a chunk in one launch).  bucket_sums on the batch's real
    digits (every chunk of A, B1, L, H and B2, checked on the rows of proofs
    0 and B - 1) and on planted rows over partial sums (any Z): a heavy
    bucket (60 % of row 0 in digit 1), an all-zero row, a row of one key,
    and a run A, A, -2A, identity (P = Q, then P = -Q); checked on the first
    8 rows.  Each entry also checks the row of each chunk's heaviest bucket.  bucket_fold on the planted buckets, with P = Q, P = -Q and an
    empty bucket planted at its first two steps, word for word against its
    plain version (its staged formulas give add_plain's words), also in its
    one-lane form."""
    from zerochain_tpu_torch.ec import cuda_ec
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
    from zerochain_tpu_torch.msm import pippenger as pip

    msm = pip.Msm(FqOps)  # the hs path's: c = 8, 32 windows
    nw, nb = msm.n_windows, 1 << msm.c
    dev = prover.device
    inputs_host, witness_fn = prover._witness_fns()
    aux, public = witness_fn(**inputs_host(assignments, prover.device))
    a_b, b1_b, b2_b, l_b, h_b = prover._bits(*prover._quotient(aux, public))
    check = torch.tensor([w * B + b for w in range(nw) for b in (0, B - 1)],
                         device=dev)

    def pairs(chunks, bits):
        out, off = [], 0
        for ch in chunks:
            n = pip.first_leaf(ch).shape[-1]
            out.append((ch, msm.rows(bits[:, off: off + n])))
            off += n
        return out

    out = [bucket_sums_entry(
        FqOps, pairs(prover.a_chunks, a_b) + pairs(prover.b1_chunks, b1_b)
        + pairs(prover.l_chunks, l_b) + pairs(prover.h_chunks, h_b),
        nb, "g1.real", check, B)]
    out.append(bucket_sums_entry(Fq2Ops, pairs(prover.b2_chunks, b2_b), nb,
                                 "g2.real", check, B))
    del aux, public, a_b, b1_b, b2_b, l_b, h_b

    for F, chunk, tag in ((FqOps, prover.h_chunks[0], "g1"),
                          (Fq2Ops, prover.b2_chunks[0], "g2")):
        N = pip.first_leaf(chunk).shape[-1]

        def pick():
            i = torch.randint(0, N, (N,), generator=gen, device=dev)
            return pip.tmap(lambda t: t.index_select(1, i), chunk)

        pts = W.add(F, pick(), pick())  # partial sums; zero padding included
        a = pip.tmap(lambda t: t[:, :1].clone(), pts)
        neg2a = W.neg(F, W.double(F, a))
        ident = W.identity(F, (1,), dev)
        for t, x, y, z in zip(leaves_of(pts), leaves_of(a), leaves_of(neg2a),
                              leaves_of(ident)):
            t[:, 1], t[:, 2], t[:, 3] = x[:, 0], y[:, 0], z[:, 0]
        M = nw * B
        keys = torch.randint(0, nb, (M, N), generator=gen, device=dev,
                             dtype=torch.int32)
        heavy = torch.randperm(N, generator=gen, device=dev)[: N * 3 // 5]
        keys[0, heavy] = 1                                    # heavy bucket
        keys[1] = 0                                           # all zero
        keys[2] = nb - 56                                     # one key
        keys[3][keys[3] == 77] = 78
        keys[3, :4] = 77                                      # A, A, -2A, inf
        ks, od = torch.sort(keys, dim=-1, stable=True)
        od = od.to(torch.int32)
        rows8 = torch.arange(8, device=dev)
        out.append(bucket_sums_entry(F, [(pts, (ks, od))], nb,
                                     f"{tag}.planted", rows8, B))

        bk = cuda_ec.bucket_sums(F, pts, ks, od, nb)
        top = pip.tmap(lambda t: t[:, :, nb - 1], bk)
        neg_top = W.neg(F, top)
        for t, x, y in zip(leaves_of(bk), leaves_of(top), leaves_of(neg_top)):
            t[:, 4, nb - 2] = x[:, 4]                         # P = Q
            t[:, 5, nb - 2] = y[:, 5]                         # P = -Q
        for t in leaves_of(bk)[-F.ncomp:]:
            t[:, 6, nb - 2] = 0                               # an empty bucket
        words = 3 * F.ncomp * 12
        e = chain_entry(
            F, f"ec.bucket_fold.{tag}", f"{tag}_bucket_fold", [12, M, nb],
            lambda lanes=None: cuda_ec.bucket_fold(F, bk, lanes=lanes),
            lambda: cuda_ec.bucket_fold_plain(F, bk),
            n_bytes=words * 4 * M * (nb + 1),
            n_ops=M * 2 * (nb - 1) * group_op_ops(F.ncomp, "add"))
        e["path"] = "prove_hs"
        out.append(e)
    return out


def column_scan_entries(prover, B, gen):
    """P4's port as an op, off every path since the split tail runs
    split_lanes: one chunk of CRS points in the column layout of all windows
    x B programs (uniform signed digits, so half the Y coordinates negated
    and padding points in place), with P = Q and P = -Q planted in two lanes
    of program 0."""
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.msm import cuda_scan
    from zerochain_tpu_torch.msm import pippenger as pip
    from zerochain_tpu_torch.msm.suffix import SuffixMsm

    out = []
    for F, chunk, tag in ((FqOps, prover.h_chunks[-1], "g1"),
                          (Fq2Ops, prover.b2_chunks[0], "g2")):
        N = pip.first_leaf(chunk).shape[-1]
        split = SuffixMsm(F, c=8, signed=True, tail="split")
        scal = random_elements(L.FR, (N, B), gen)
        sd, od = split.prep(split.digits(scal))
        if split.column_split(N):
            pts_cm = split.column_layout(chunk, sd, od)
        else:  # a short chunk (--mini): tile it up to two depths
            reps = -(-2 * cuda_scan.VL // N)
            pts_cm = pip.tmap(lambda t: t.repeat(1, reps)[:, :2 * cuda_scan.VL]
                              .reshape(12, 1, -1).expand(12, 8, -1)
                              .contiguous(), chunk)
        VL = cuda_scan.VL
        flat = pip.tmap(lambda t: t.reshape(12, -1, t.shape[-1]), pts_cm)
        _set_at(flat, (slice(None), 0, VL + 5), pip.tmap(
            lambda t: torch.roll(t, VL, dims=-1), flat))       # P = Q
        negp = W.neg(F, pip.tmap(lambda t: torch.roll(t, VL, dims=-1), flat))
        _set_at(flat, (slice(None), 0, VL + 6), negp)         # P = -Q
        got = cuda_scan.column_scan(F, pts_cm)
        want, plain_ms = timed(lambda: cuda_scan.column_scan_plain(F, pts_cm))
        err = max_abs_err(leaves_of(got), leaves_of(want))
        n = pip.first_leaf(pts_cm).shape[-1]
        M = pip.first_leaf(pts_cm)[0].numel() // n
        t_depth = n // VL
        words = 3 * F.ncomp * 12
        bnd, by = bound_ms(2 * words * 4 * M * n,
                           group_op_ops(F.ncomp, "madd") * M * VL * (t_depth - 1))
        out.append(dict(
            name=f"msm.column_scan.{tag}", route="cuda",
            source="zerochain_tpu_torch/csrc/column_scan_kernel.cu",
            replaces=TPU_COLUMN_SCAN, counter=("scan", f"{tag}_column_scan"),
            # the split tail runs split_lanes: column_scan is an op off the path
            path="prove_split", shape=[12, M, t_depth, VL], off_path=True,
            equal=err == 0, max_abs_err=err,
            ms=time_ms(lambda: cuda_scan.column_scan(F, pts_cm), 3),
            plain_ms=plain_ms, bound_ms=bnd, bound_by=by, library_ms=None))
    return out


def lane_padded(F, chunk, sd, od):
    """A chunk of N points with its digits and order (*lead, N) -> the same
    sums over N' = 1024 * ceil(N / 1024) points: identities with zero digits
    appended (the --mini chunks hold 256 points; the split kernels take
    lanes of 1024)."""
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.msm import cuda_scan
    from zerochain_tpu_torch.msm import pippenger as pip

    N = od.shape[-1]
    pad = -N % cuda_scan.VL
    if not pad:
        return chunk, sd, od
    chunk = pip.tcat([chunk, W.identity(F, (pad,), od.device)], 1)
    sd = torch.cat([sd, sd.new_zeros((*sd.shape[:-1], pad))], -1)
    tail = torch.arange(N, N + pad, dtype=od.dtype, device=od.device)
    od = torch.cat([od, tail.expand(*od.shape[:-1], pad)], -1)
    return chunk, sd.contiguous(), od.contiguous()


def split_entry(F, pairs, nb, tag, check_rows, off_path):
    """The split tail's two kernels over (chunk, (sorted digits, order))
    pairs, all programs of a chunk in one launch each: split_lanes held
    against split_lanes_plain word for word (lane totals and slots), and
    split_tail, on split_lanes' output, against split_tail_plain after
    normalisation, both on the programs check_rows of every pair (the plain
    lane scan takes seconds a chunk); ms is the sum of one launch per pair.
    The lane pass's bound counts one mixed add per non-zero position past
    its lane's first (n_madd); the tail's its full adds (n_add): a scan of
    the lanes that hold non-zero digits, one add per pick position (lane
    offset plus in-lane prefix) and the sum of the non-empty buckets."""
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.msm import cuda_scan
    from zerochain_tpu_torch.msm import pippenger as pip

    VL = cuda_scan.VL
    acc = {k: dict(err=0.0, plain_ms=0.0, ms=0.0, n_bytes=0)
           for k in ("lanes", "tail")}
    nonzero = n_madd = n_add = rows_checked = 0
    words = 3 * F.ncomp * 12
    for chunk, (sd, od) in pairs:
        chunk, sd, od = lane_padded(F, chunk, sd, od)
        N = od.shape[-1]
        D = N // VL
        sd2, od2 = sd.reshape(-1, N), od.reshape(-1, N)
        M = sd2.shape[0]
        rows = check_rows[check_rows < M]
        rows_checked += rows.numel()
        lanes, slots = cuda_scan.split_lanes(F, chunk, sd2, od2, nb)
        want, p_ms = timed(lambda: cuda_scan.split_lanes_plain(
            F, chunk, sd2[rows], od2[rows], nb))
        got = [pip.tmap(lambda t: t[:, rows], x) for x in (lanes, slots)]
        a = acc["lanes"]
        a["err"] = max(a["err"], max_abs_err(leaves_of(got[0]) + leaves_of(got[1]),
                                             leaves_of(want[0]) + leaves_of(want[1])))
        a["plain_ms"] += p_ms
        a["ms"] += time_ms(lambda: cuda_scan.split_lanes(F, chunk, sd2, od2, nb), 3)
        a["n_bytes"] += (words * 4 * N + 2 * 4 * M * N
                         + words * 4 * M * (VL + nb))
        tot = cuda_scan.split_tail(F, lanes, slots, sd2, nb)
        want, p_ms = timed(lambda: cuda_scan.split_tail_plain(
            F, got[0], got[1], sd2[rows], nb))
        gx, gy, ginf = W.normalize(F, pip.tmap(lambda t: t[:, rows], tot))
        wx, wy, winf = W.normalize(F, want)
        a = acc["tail"]
        a["err"] = max(a["err"], max_abs_err(leaves_of((gx, gy)) + [ginf],
                                             leaves_of((wx, wy)) + [winf]))
        a["plain_ms"] += p_ms
        a["ms"] += time_ms(lambda: cuda_scan.split_tail(F, lanes, slots, sd2, nb), 3)
        a["n_bytes"] += words * 4 * M * (VL + nb) + 4 * M * N + words * 4 * M
        mag = sd2.abs()
        nnz = (mag != 0).sum(-1)
        n_lanes = (nnz + D - 1) // D
        nxt = torch.cat([mag[:, 1:], torch.zeros_like(mag[:, :1])], -1)
        nonzero += int(nnz.sum())
        n_madd += int((nnz - n_lanes).sum())
        n_add += int((n_lanes - 1).clamp(min=0).sum()
                     + ((mag > nxt) & (mag < nb)).sum()
                     + (mag[:, 0].clamp(max=nb - 1) - 1).clamp(min=0).sum())
    out = []
    for kind, ops in (("lanes", n_madd * group_op_ops(F.ncomp, "madd")),
                      ("tail", n_add * group_op_ops(F.ncomp, "add"))):
        a = acc[kind]
        bnd, by = bound_ms(a["n_bytes"], ops)
        out.append(dict(
            name=f"msm.split_{kind}.{tag}", route="cuda",
            source="zerochain_tpu_torch/csrc/split_tail_kernel.cu",
            replaces=TPU_COLUMN_SCAN,
            counter=("scan", f"{tag[:2]}_split_{kind}"),
            path="prove_split", off_path=off_path,
            shape=[len(pairs), list(pairs[0][1][0].shape)],
            equal=a["err"] == 0, max_abs_err=a["err"], nonzero_digits=nonzero,
            **({"n_madd": n_madd} if kind == "lanes" else {"n_add": n_add}),
            rows_checked=rows_checked, ms=a["ms"], plain_ms=a["plain_ms"],
            bound_ms=bnd, bound_by=by, library_ms=None))
    return out


def split_entries(prover, B, gen, assignments):
    """split_lanes and split_tail at the split path's shape (all windows x B
    programs of a chunk in one launch each).  On the batch's real signed
    digits: every chunk of A, B1, L, H and B2, checked on the programs of
    proofs 0 and B - 1.  On
    planted rows of uniform signed digits over one CRS chunk, checked on the
    first 8 programs: P = Q at the first add of lane 0 (thread 0 doubles
    while the other lanes of its warp take the general add) and P = -Q
    inside lane 5 (program 0), a one-key row (every pick in the last lane),
    an all-zero row, a non-zero count that ends inside lane 7.  Under --mini
    the chunks are padded with identities to 1024 points (the real digits)
    or tiled to 2048 (the planted rows), and the entries are off the path:
    its 256-point chunks take the split tail's plain prefix scan."""
    from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.msm import cuda_scan
    from zerochain_tpu_torch.msm import pippenger as pip
    from zerochain_tpu_torch.msm.suffix import SuffixMsm

    dev = prover.device
    mini = not prover.msm_g1.column_split(pip.first_leaf(prover.h_chunks[0]).shape[-1])
    nw, nb = prover.msm_g1.n_windows, prover.msm_g1.nb
    inputs_host, witness_fn = prover._witness_fns()
    aux, public = witness_fn(**inputs_host(assignments, dev))
    a_p, b1_p, b2_p, l_p, h_p = prover._digits(*prover._quotient(aux, public))
    check = torch.tensor([w * B + b for w in range(nw) for b in (0, B - 1)],
                         device=dev)
    g1 = list(zip(prover.a_chunks, a_p)) + list(zip(prover.b1_chunks, b1_p)) \
        + list(zip(prover.l_chunks, l_p)) + list(zip(prover.h_chunks, h_p))
    out = (split_entry(FqOps, g1, nb, "g1.real", check, mini)
           + split_entry(Fq2Ops, list(zip(prover.b2_chunks, b2_p)), nb,
                         "g2.real", check, mini))
    del aux, public, a_p, b1_p, b2_p, l_p, h_p, g1

    VL = cuda_scan.VL
    for F, chunk, tag in ((FqOps, prover.h_chunks[0], "g1"),
                          (Fq2Ops, prover.b2_chunks[0], "g2")):
        N = pip.first_leaf(chunk).shape[-1]
        if N < 2 * VL:  # --mini: tile the chunk up to two depths
            reps = -(-2 * VL // N)
            chunk = pip.tmap(lambda t: t.repeat(1, reps)[:, :2 * VL].contiguous(),
                             chunk)
            N = 2 * VL
        D = N // VL
        split = SuffixMsm(F, c=8, signed=True, tail="split")
        sd, od = split.prep(split.digits(random_elements(L.FR, (N, B), gen)))
        sd, od = sd.reshape(-1, N).clone(), od.reshape(-1, N).clone()
        od[0, :2] = 1                                   # P = Q in lane 0
        sd[0, 1] = sd[0, 0]
        od[0, 5 * D: 5 * D + 2] = 2                     # P = -Q in lane 5
        sd[0, 5 * D + 1] = -sd[0, 5 * D]
        flip = torch.rand(N, generator=gen, device=dev) < 0.5
        sd[1] = torch.where(flip, -77, 77)              # one key
        sd[2] = 0                                       # all zero
        sd[3, 7 * D + 1:] = 0                           # ends inside lane 7
        out += split_entry(F, [(chunk, (sd, od))], split.nb, f"{tag}.planted",
                           torch.arange(8, device=dev), mini)
    return out


# window widths besides the paths' c = 8
WIDTHS = (4, 10)
WIDTH_POINTS = 2048  # two depths a split lane
WIDTH_PROOFS = 2


def width_entries(prover, gen):
    """The MSM kernels at window widths c = 4 and c = 10 (the paths run c =
    8; ZEROCHAIN_MSM_C / ZEROCHAIN_MSM_SUFFIX_C choose others), G1 and G2,
    on 2,048 CRS points (tiled under --mini) and uniform scalars of 2
    proofs, every program checked: window_totals and split_lanes /
    split_tail on signed digits (nb = 2^(c-1) + 1: 9 and 513 buckets),
    bucket_sums and bucket_fold on unsigned ones (2^c: 16 and 1,024), Horner
    at c on CRS sums of nw x 2 windows.  No path launches these widths: the
    entries are off_path with launches 0."""
    from zerochain_tpu_torch.ec import cuda_ec
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.msm import pippenger as pip
    from zerochain_tpu_torch.msm.suffix import SuffixMsm

    mini = not prover.msm_g1.column_split(pip.first_leaf(prover.h_chunks[0]).shape[-1])
    dev = prover.device
    n, B = WIDTH_POINTS, WIDTH_PROOFS
    out = []
    for F, chunk, tag in ((FqOps, prover.h_chunks[0], "g1"),
                          (Fq2Ops, prover.b2_chunks[0], "g2")):
        reps = -(-n // pip.first_leaf(chunk).shape[-1])
        pts = pip.tmap(lambda t: t.repeat(1, reps)[:, :n].contiguous(), chunk)
        scal = random_elements(L.FR, (n, B), gen)
        words = 3 * F.ncomp * 12
        # the bucket MSM's 'assoc' mode (K2 adds, no kernel of its own)
        # against 'hs' at c = 8, after normalisation
        bits = pip.limbs_to_bits(scal, 255)
        got = {}
        for mode in pip.SCAN_MODES:
            got[mode], got[mode + "_ms"] = timed(
                lambda mode=mode: pip.Msm(F, c=8, mode=mode)(pts, bits))
        err = max_abs_err(leaves_of(W.normalize(F, got["assoc"])),
                          leaves_of(W.normalize(F, got["hs"])))
        emit("msm_assoc", group=tag, points=n, proofs=B, c=8, max_abs_err=err,
             assoc_ms=got["assoc_ms"], hs_ms=got["hs_ms"])
        if err:
            raise SystemExit(f"Msm 'assoc' differs from 'hs' ({tag}) by {err}")
        for c in WIDTHS:
            wt = f"{tag}.c{c}"
            suf = SuffixMsm(F, c=c, signed=True)
            sd, od = suf.prep(suf.digits(scal))
            out.append(totals_entry(F, suf, [pts], [(sd, od)], wt))
            rows = torch.arange(sd[..., 0].numel(), device=dev)
            out += split_entry(F, [(pts, (sd, od))], suf.nb, wt, rows, mini)

            bm = pip.Msm(F, c=c)
            nb = 1 << c
            ks, ko = bm.rows(pip.limbs_to_bits(scal, 255))
            out.append(bucket_sums_entry(F, [(pts, (ks, ko))], nb, wt,
                                         torch.arange(ks.shape[0], device=dev),
                                         B))
            bk = cuda_ec.bucket_sums(F, pts, ks, ko, nb)
            M = ks.shape[0]
            out.append(chain_entry(
                F, f"ec.bucket_fold.{wt}", f"{tag}_bucket_fold", [12, M, nb],
                lambda lanes=None, bk=bk: cuda_ec.bucket_fold(F, bk, lanes=lanes),
                lambda bk=bk: cuda_ec.bucket_fold_plain(F, bk),
                n_bytes=words * 4 * M * (nb + 1),
                n_ops=M * 2 * (nb - 1) * group_op_ops(F.ncomp, "add")))

            nw = bm.n_windows
            idx = torch.arange(nw * B, device=dev) % n
            tot = W.add(F, pip.tmap(lambda t: t[:, idx].reshape(12, nw, B), pts),
                        pip.tmap(lambda t: t[:, (idx * 7 + 3) % n]
                                 .reshape(12, nw, B), pts))
            out.append(chain_entry(
                F, f"ec.horner.{wt}", f"{tag}_horner", [12, nw, B],
                lambda lanes=None, tot=tot, c=c: cuda_ec.horner(F, tot, c,
                                                                lanes=lanes),
                lambda tot=tot, c=c: cuda_ec.horner_plain(F, tot, c),
                n_bytes=(nw + 1) * words * 4 * B,
                n_ops=(nw - 1) * B * (c * group_op_ops(F.ncomp, "double")
                                      + group_op_ops(F.ncomp, "add"))))
    for e in out:
        e["window_c"] = int(e["name"].rsplit(".c", 1)[1])
        e["counter"], e["off_path"] = None, True
        e.pop("path", None)
    return out


def phase_profile(prover, assignments, rs, timed_seconds, path):
    """One more prove of the path under torch.profiler (profile_call)."""
    profile_call(lambda: prover.prove(assignments, rs=rs), timed_seconds, path)


def profile_call(fn, timed_seconds, path):
    """One more fn() under torch.profiler: the card's busy time, its idle
    share of the path's timed (unprofiled) run, and device time by kernel
    name.  The profiled run itself is slowed by the tracing of every
    launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.time() - t0
    rows = [(ev.key, ev.count, ev.self_device_time_total)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    busy_us = sum(r[2] for r in rows)
    if busy_us <= 0:
        raise SystemExit("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[2])
    emit("profile", path=path, profiled_wall_seconds=wall,
         device_busy_seconds=busy_us / 1e6, timed_seconds=timed_seconds,
         device_idle_share=1.0 - busy_us / 1e6 / timed_seconds,
         kernels=[dict(name=k[:80], count=c, total_ms=t / 1e3,
                       mean_us=t / c) for k, c, t in rows[:24]])


def point_ops(counts) -> int:
    """Point-op launches of a run: add, double, ladder, Horner, fold and
    bucket sums (every point kernel of ec/cuda_ec.py but hs_add_select)."""
    return sum(n for k, n in counts["ec"].items() if "hs_" not in k)


def check_split_launches(split_prover, counts, rolls, prove_counts):
    """The timed prove_split ran the split tail as one split_lanes and one
    split_tail launch a chunk of 1024 lanes or more, and no column_scan or
    window_totals; where
    every chunk is such a chunk, it called no torch.roll and made no point-op
    launch beyond prove's (the tail adds no point of its own)."""
    from zerochain_tpu_torch.msm import pippenger as pip

    msm = split_prover.msm_g1
    groups = {"g1": [c for chs in (split_prover.a_chunks, split_prover.b1_chunks,
                                    split_prover.l_chunks, split_prover.h_chunks)
                     for c in chs],
              "g2": list(split_prover.b2_chunks)}
    scan = counts["scan"]
    other_chunks = 0
    for g, chunks in groups.items():
        n = sum(msm.column_split(pip.first_leaf(c).shape[-1]) for c in chunks)
        other_chunks += len(chunks) - n
        got = (scan[f"{g}_split_lanes"], scan[f"{g}_split_tail"],
               scan[f"{g}_column_scan"], scan[f"{g}_window_totals"])
        if got != (n, n, 0, 0):
            raise SystemExit(f"prove_split: {g} split_lanes / split_tail / "
                             f"column_scan / window_totals launches {got} for "
                             f"{n} chunks of 1024 lanes or more")
    if other_chunks == 0 and (rolls or point_ops(counts) != point_ops(prove_counts)):
        raise SystemExit(f"prove_split: {rolls} torch.roll calls and "
                         f"{point_ops(counts)} point-op launches (prove: "
                         f"{point_ops(prove_counts)}); expected none and the same")


def check_bucket_launches(prover, counts, rolls):
    """The timed prove_hs ran the bucket kernels: no hs_add_select and no
    torch.roll, at least one bucket_sums and one bucket_fold a chunk."""
    chunks = {"g1": sum(len(c) for c in (prover.a_chunks, prover.b1_chunks,
                                         prover.l_chunks, prover.h_chunks)),
              "g2": len(prover.b2_chunks)}
    hs = counts["ec"]["g1_hs_add_select"] + counts["ec"]["g2_hs_add_select"]
    if hs or rolls:
        raise SystemExit(f"prove_hs: {hs} hs_add_select launches, {rolls} "
                         "torch.roll calls; expected none")
    for g, n in chunks.items():
        got = (counts["ec"][f"{g}_bucket_sums"], counts["ec"][f"{g}_bucket_fold"])
        if min(got) < n:
            raise SystemExit(f"prove_hs: {g} bucket_sums/bucket_fold launches "
                             f"{got} for {n} MSM chunks")


def timed_backend(backend, names=("msm_g1", "msm_g2", "compute_h")):
    """Wrap the backend's entry points (by default those that create_proof
    calls) so that their seconds (each call ended by a synchronize) add up
    by name in the returned dict."""
    spent = {}
    for name in names:
        fn = getattr(backend, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            t0 = time.time()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            spent[_name] = spent.get(_name, 0.0) + time.time() - t0
            return out

        setattr(backend, name, wrapped)
    return spent


def profile_create_proof(create_proof, circuit, params, r_s, backend,
                         timed_seconds):
    """One more create_proof under torch.profiler: the card's busy time and
    its idle share of the timed (unprofiled) create_proof."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        create_proof(circuit, params, *r_s, backend=backend)
        torch.cuda.synchronize()
    busy_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA)
    emit("profile", path="create_proof", device_busy_seconds=busy_us / 1e6,
         timed_seconds=timed_seconds,
         device_idle_share=1.0 - busy_us / 1e6 / timed_seconds)


def ints_of(proofs):
    """Proofs as integer tuples (Proof dataclasses compare by class)."""
    return [(p.a, p.b, p.c) for p in proofs]


def assignments_for(n, mini):
    """The batch the repo's own benchmark proves (bench.py:_assignments)."""
    if mini:
        return [dict(amount=(10 + 0x10001 * i) & 0xFFFFFFFF) for i in range(n)]
    from zerochain_tpu_torch.mirror import jubjub as jj
    from zerochain_tpu_torch.mirror.field import S
    from zerochain_tpu_torch.protocol.elgamal import Ciphertext
    from zerochain_tpu_torch.protocol.keys import (
        EncryptionKey, ProofGenerationKey)

    out = []
    g_epoch = jj.find_group_hash(b"\x02\x00\x00\x00", b"zcgepoch")
    for i in range(n):
        pgk = ProofGenerationKey.from_seed(f"bench-sender-{i}".encode())
        dk = pgk.into_decryption_key()
        ek_s = EncryptionKey.from_decryption_key(dk)
        ek_r = EncryptionKey.from_seed(f"bench-recipient-{i}".encode())
        ct = Ciphertext.encrypt(27, (0xABCDEF + i) % S, ek_s)
        out.append(dict(
            amount=10, remaining_balance=16, fee=1, dec_key=dk.fs,
            randomness=(0x1337C0DE + i) % S, alpha=(41 + i) % S,
            enc_key_recipient=ek_r.point, enc_balance_left=ct.left,
            enc_balance_right=ct.right, pgk=pgk.point, g_epoch=g_epoch))
    return out


def anon_witness_entries(prover, B, gen, assignments):
    """The anonymous witness stage's kernels at its shapes, on the batch's
    own inputs: ff.inv (Fr) at the var chain's normalisation, 252 steps x
    14 chains x B; the variable-base chains on the 14 bases (12 enc keys,
    cr_minus_d, g_epoch) and bits (randomness for 12, dec_key for 2) a
    proof; the two fold groups (5 folds, then 2, of 12 members behind the
    identity window), each against its plain version and its former loop of
    field-kernel launches (k1_loop_ms)."""
    from zerochain_tpu_torch.ec import cuda_jubjub
    from zerochain_tpu_torch.ec import jubjub as ej
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.prover import witness_anon as wa

    c = wa.anonymous_chains(**wa.witness_inputs_host(assignments,
                                                     prover.device))
    n_bits, n_chains = c["vm_bits"].shape[:2]
    out = [inv_entry(L.FR, (n_bits * n_chains * B,), gen, False, ".anon")]
    bases, bits = c["vm_bases"], c["vm_bits"]
    lanes = n_chains * B
    out.append(jubjub_entry(
        "var_chain.anon", [8, n_bits, n_chains, B],
        lambda: cuda_jubjub.var_chain(bases, bits),
        lambda: cuda_jubjub.var_chain_plain(bases, bits),
        lambda: cuda_jubjub.var_chain_plain(bases, bits, ej.KERNEL_OPS),
        n_bytes=2 * 8 * 4 * lanes + n_bits * lanes + 2 * 3 * 8 * 4 * n_bits * lanes,
        serial=1 + n_bits * 9 + (n_bits - 1) * 8, lanes=lanes,
        counter="var_chain"))
    for tag in ("pre", "post"):
        _, lx, ly = wa.fold_windows(c[tag])
        n_win, nc = lx.shape[1:3]
        lanes = nc * B
        out.append(jubjub_entry(
            f"fixed_chain.fold_{tag}", [8, n_win, nc, B],
            lambda lx=lx, ly=ly: cuda_jubjub.fixed_chain(lx, ly),
            lambda lx=lx, ly=ly: cuda_jubjub.fixed_chain_plain(lx, ly),
            lambda lx=lx, ly=ly: cuda_jubjub.fixed_chain_plain(lx, ly, ej.KERNEL_OPS),
            n_bytes=2 * 8 * 4 * n_win * lanes + 3 * 8 * 4 * (n_win - 1) * lanes,
            serial=1 + (n_win - 1) * 10, lanes=lanes, counter="fixed_chain"))
    for e in out:
        e["path"] = "anon_prove"
    return out


def heaviest_bucket(keys, nb):
    """The largest bucket (digit 0 aside) of any row of sorted keys."""
    cnt = torch.zeros((keys.shape[0], nb), dtype=torch.int64, device=keys.device)
    cnt.scatter_add_(1, keys.to(torch.int64), torch.ones_like(keys, dtype=torch.int64))
    return int(cnt[:, 1:].max())


def anon_msm_entries(prover, B, assignments):
    """The MSM kernels on the anonymous batch's real digits: of all chunks,
    the G1 chunk and the G2 (B2) chunk that hold the batch's heaviest
    bucket on the hs path; window_totals (programs of the first 4 proofs),
    split_lanes / split_tail and bucket_sums (the programs and rows of
    proofs 0 and B - 1, and the heaviest bucket's row), each against its
    plain version.  heaviest_bucket_g1 / _g2 name the largest bucket over
    every chunk of the batch."""
    from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
    from zerochain_tpu_torch.msm import pippenger as pip

    dev = prover.device
    inputs_host, witness_fn = prover._witness_fns()
    wm, hs = prover._quotient(*witness_fn(**inputs_host(assignments, dev)))
    bits = dict(zip(("a", "b1", "b2", "l", "h"), prover._bits(wm, hs)))
    preps = dict(zip(("a", "b1", "b2", "l", "h"), prover._digits(wm, hs)))
    del wm, hs
    hs_msm = pip.Msm(FqOps)
    nb_hs = 1 << hs_msm.c
    nw, nb = prover.msm_g1.n_windows, prover.msm_g1.nb
    check = torch.tensor([w * B + b for w in range(nw) for b in (0, B - 1)],
                         device=dev)
    out = []
    for F, queries, tag in ((FqOps, ("a", "b1", "l", "h"), "g1"),
                            (Fq2Ops, ("b2",), "g2")):
        best = (-1, None)
        for q in queries:
            off = 0
            for k, ch in enumerate(getattr(prover, f"{q}_chunks")):
                n = pip.first_leaf(ch).shape[-1]
                rows = hs_msm.rows(bits[q][:, off: off + n])
                top = heaviest_bucket(rows[0], nb_hs)
                if top > best[0]:
                    best = (top, (q, k, off, n))
                off += n
                del rows
        q, k, off, n = best[1]
        chunk = getattr(prover, f"{q}_chunks")[k]
        prep = preps[q][k]
        rows = hs_msm.rows(bits[q][:, off: off + n])
        got = [totals_entry(F, prover.msm_g1 if tag == "g1" else prover.msm_g2,
                            [chunk], [prep], f"{tag}.anon", proofs=4)]
        got[0]["path"] = "anon_prove"
        for e in split_entry(F, [(chunk, prep)], nb, f"{tag}.anon", check, False):
            e["path"] = "anon_prove_split"
            got.append(e)
        e = bucket_sums_entry(F, [(chunk, rows)], nb_hs, f"{tag}.anon", check, B)
        e["path"] = "anon_prove_hs"
        got.append(e)
        for e in got:
            e["chunk"] = f"{q}[{k}]"
            e[f"heaviest_bucket_{tag}"] = best[0]
        out += got
        del rows
    return out


def reset_counters():
    """Zero every kernel wrapper's launch count and the dist collectives'
    counts."""
    from zerochain_tpu_torch.dist import comm
    from zerochain_tpu_torch.ec import cuda_ec, cuda_jubjub, cuda_pairing
    from zerochain_tpu_torch.ff import cuda_ff
    from zerochain_tpu_torch.msm import cuda_scan
    from zerochain_tpu_torch.ntt import ntt as tntt
    from zerochain_tpu_torch.prover import cuda_witness

    for mod in (cuda_ff, cuda_ec, cuda_scan, cuda_jubjub, tntt, cuda_witness, cuda_pairing):
        mod.reset_launches()
    comm.reset_stats()


def drive(p, phase, assignments, rs, B, counters):
    """One warm prove, then a timed one with every launch counter zeroed
    just before and read just after, and torch.roll's calls counted (the
    Hillis-Steele levels' rolled copies)."""
    p.sync_stages = True
    t0 = time.time()
    p.prove(assignments, rs=rs)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    reset_counters()
    rolls = [0]
    real_roll = torch.roll

    def counted_roll(*a, **kw):
        rolls[0] += 1
        return real_roll(*a, **kw)

    torch.cuda.synchronize()
    torch.roll = counted_roll
    try:
        t0 = time.time()
        out = p.prove(assignments, rs=rs)
        torch.cuda.synchronize()
        secs = time.time() - t0
    finally:
        torch.roll = real_roll
    counts = {k: dict(v) for k, v in counters.items()}
    bucket = {k: n for k, n in counts["ec"].items()
              if "bucket" in k or "hs_" in k}
    emit(phase, batch=B, warm_seconds=warm_s, seconds=secs,
         proofs_per_second=B / secs, stages=p.last_timings,
         launches=counts, total_launches=sum(
             n for c in counts.values() for n in c.values()),
         point_op_launches=point_ops(counts),
         bucket_msm_launches=bucket, torch_roll_calls=rolls[0])
    return out, secs, counts, rolls[0]


def prove_paths(prover, cls, assignments, rs, B, prefix, profile, counters,
                path_counts):
    """The batch through the three MSM paths on one CRS (phases prefix +
    prove, prove_hs, prove_split), each path's launches checked and its
    proofs equal to prove's.  -> (prove's proofs, {path: proofs})."""
    proofs, prove_s, path_counts[prefix + "prove"], _ = drive(
        prover, prefix + "prove", assignments, rs, B, counters)
    if profile:
        phase_profile(prover, assignments, rs, prove_s, prefix + "prove")
    path_proofs = {}
    for name, opts in (("prove_hs", dict(msm_impl="hs")),
                       ("prove_split", dict(msm_tail="split"))):
        phase = prefix + name
        other = cls(None, _device_queries=prover._raw_queries, _vk=prover.vk,
                    **opts)
        path_proofs[name], secs, path_counts[phase], rolls = drive(
            other, phase, assignments, rs, B, counters)
        if name == "prove_hs":
            check_bucket_launches(prover, path_counts[phase], rolls)
        else:
            check_split_launches(other, path_counts[phase], rolls,
                                 path_counts[prefix + "prove"])
        if profile:
            phase_profile(other, assignments, rs, secs, phase)
        del other
        if ints_of(path_proofs[name]) != ints_of(proofs):
            raise SystemExit(f"{phase}: the proofs differ from {prefix}prove's")
    return proofs, path_proofs


def open_world():
    """An NCCL world of one on card 0, over a file store in a fresh
    temporary directory (no network) -> that directory."""
    import datetime
    import tempfile

    import torch.distributed as dist

    torch.cuda.set_device(0)
    tmp = tempfile.mkdtemp(prefix="zc_dist_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    return tmp


def check_dist_launches(p, name, counts, coll):
    """A timed dist run launched its MSM kernels for every chunk (window
    totals, the split kernels or the bucket kernels) and made one
    all-to-all a distributed transform (7 in the quotient) and one
    all-gather a transform and an MSM chunk."""
    from zerochain_tpu_torch.msm import pippenger as pip

    chunks = {"g1": [c for q in (p.a_chunks, p.b1_chunks, p.l_chunks,
                                 p.h_chunks) for c in q],
              "g2": list(p.b2_chunks)}
    # at n = 1 every d >= 2 n^2: the quotient's 7 transforms are distributed
    want = {"all_to_all": 7,
            "all_gather": 7 + len(chunks["g1"]) + len(chunks["g2"])}
    got = {k: coll[k] for k in want}
    if got != want:
        raise SystemExit(f"{name}: collectives {got}, expected {want}")
    split = p.msm_impl == "suffix" and p.msm_g1.tail == "split"
    if p.msm_impl == "hs":
        keys = ("ec", "{}_bucket_sums"), ("ec", "{}_bucket_fold")
    elif split:  # only chunks of a power-of-two multiple of 1024 points
        keys = ("scan", "{}_split_lanes"), ("scan", "{}_split_tail")
    else:
        keys = (("scan", "{}_window_totals"),)
    for g, chs in chunks.items():
        n = sum(not split or p.msm_g1.column_split(pip.first_leaf(c).shape[-1])
                for c in chs)
        for grp, key in keys:
            if counts[grp][key.format(g)] < n:
                raise SystemExit(f"{name}: {key.format(g)} launched "
                                 f"{counts[grp][key.format(g)]} times for {n} "
                                 "chunks")


def phase_dist(prover, cls, assignments, rs, B, proofs, counters, path_counts):
    """The dist phases (module docstring): the batch with ZEROCHAIN_DIST=1
    through the three MSM paths in an NCCL world of one, then DistNtt and
    sharded_suffix against their single-device counterparts."""
    import os
    import shutil

    import torch.distributed as dist

    from zerochain_tpu_torch.dist import comm, dist_plan_for, sharded_suffix
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.ec.fields import FqOps
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.ntt import quotient

    tmp = open_world()
    os.environ["ZEROCHAIN_DIST"] = "1"
    try:
        for name, opts in (("dist_prove", {}),
                           ("dist_prove_split", dict(msm_tail="split")),
                           ("dist_prove_hs", dict(msm_impl="hs"))):
            p = cls(None, _device_queries=prover._raw_queries, _vk=prover.vk,
                    **opts)
            if not (p.dist and p.world_size == 1):
                raise SystemExit(f"{name}: the prover is not in dist mode")
            got, secs, path_counts[name], _ = drive(p, name, assignments, rs,
                                                    B, counters)
            coll = dict(comm.stats)
            check_dist_launches(p, name, path_counts[name], coll)
            if ints_of(got) != ints_of(proofs):
                raise SystemExit(f"{name}: the proofs differ from prove's")
            emit(name + "_collectives", seconds=secs, collectives=coll,
                 world_size=dist.get_world_size(),
                 backend=str(dist.get_backend()), proofs_equal_prove=True)
            if name == "dist_prove":
                dist_prover = p
            else:
                del p

        # DistNtt.quotient against NttPlan's chain, word for word
        p, d = dist_prover, dist_prover.d
        gen = torch.Generator(device="cuda")
        gen.manual_seed(10)
        evs = [random_elements(L.FR, (B, d), gen) for _ in range(3)]
        dn = dist_plan_for(d, device=p.device)
        reset_counters()
        got, ms = timed(lambda: dn.quotient(*evs))
        coll = dict(comm.stats)
        want, plain_ms = timed(lambda: quotient(p.plan, *evs))
        err = max_abs_err([got], [want])
        if err:
            raise SystemExit(f"dist: DistNtt.quotient differs from NttPlan by {err}")

        # sharded_suffix on the A query's first chunk, the batch's raw digits
        inputs_host, witness_fn = p._witness_fns()
        wm, hs = p._quotient(*witness_fn(**inputs_host(assignments, p.device)))
        raw = p._digits(wm, hs)[0][0]
        chunk = p.a_chunks[0]
        msm = p.msm_g1
        reset_counters()
        part, s_ms = timed(lambda: sharded_suffix(msm, chunk, raw))
        s_coll = dict(comm.stats)
        one, one_ms = timed(lambda: msm.window_partials(chunk, prep=msm.prep(raw)))
        gx, gy, ginf = W.normalize(FqOps, part)
        wx, wy, winf = W.normalize(FqOps, one)
        s_err = max_abs_err([gx, gy, ginf], [wx, wy, winf])
        if s_err:
            raise SystemExit(f"dist: sharded_suffix differs from window_partials by {s_err}")
        emit("dist", d=d, split=[dn.d1, dn.d2], quotient_ms=ms,
             quotient_single_device_ms=plain_ms, quotient_max_abs_err=err,
             quotient_collectives=coll, sharded_suffix_ms=s_ms,
             window_partials_ms=one_ms, sharded_suffix_max_abs_err=s_err,
             sharded_suffix_shape=list(raw.shape),
             sharded_suffix_collectives=s_coll)
    finally:
        os.environ.pop("ZEROCHAIN_DIST", None)
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_verify(prover, assignments, proofs, others, B, n_public, phase):
    """The host pairing verifier accepts proofs 0 and B - 1 and the others
    ({name: (proof, index)}), with n_public public inputs a proof, and
    rejects a tampered input."""
    from zerochain_tpu_torch.groth16.core import prepare_verifying_key, verify_proof
    from zerochain_tpu_torch.mirror.field import R

    t0 = time.time()
    publics = prover.public_inputs(assignments)
    if any(len(p) != n_public for p in publics):
        raise SystemExit(f"{phase}: {len(publics[0])} public inputs, "
                         f"expected {n_public}")
    pvk = prepare_verifying_key(prover.vk)
    picks = [0, B - 1]
    for b in picks:
        if not verify_proof(pvk, proofs[b], publics[b]):
            raise SystemExit(f"{phase}: the verifier rejected proof {b}")
    for name, (pr, b) in others.items():
        if not verify_proof(pvk, pr, publics[b]):
            raise SystemExit(f"{phase}: the verifier rejected {name}'s proof {b}")
    tampered = list(publics[0])
    tampered[0] = (tampered[0] + 1) % R
    if verify_proof(pvk, proofs[0], tampered):
        raise SystemExit(f"{phase}: the verifier accepted a tampered public input")
    emit(phase, seconds=time.time() - t0, public_inputs=n_public,
         accepted=picks, accepted_other_paths={k: b for k, (_, b) in others.items()},
         tampered_rejected=True)


def confidential_phases(mini, profile, gen, counters, path_counts):
    """Phases crs to verify on ConfidentialTransfer (or MiniCommit with
    mini); -> the kernels phase's entries and prove's proofs."""
    from zerochain_tpu_torch.groth16.core import create_proof, generate_parameters
    from zerochain_tpu_torch.mirror.field import R
    from zerochain_tpu_torch.prover import ConfidentialProver, MiniProver, TorchBackend

    B = 2 if mini else 32
    t0 = time.time()
    if mini:
        import os
        os.environ["ZEROCHAIN_MSM_CHUNK"] = "256"
        prover = MiniProver.from_toxic_waste(**MINI_TOXIC, chunk=256,
                                             chunk_g2=256)
    else:
        prover = ConfidentialProver.from_toxic_waste(**TOXIC)
    torch.cuda.synchronize()
    emit("crs", seconds=time.time() - t0, constraints=prover.m,
         domain=prover.d, inputs=prover.num_inputs, aux=prover.num_aux,
         chunks=dict(a=prover.msm_chunk_a, b=prover.msm_chunk_b,
                     l=prover.msm_chunk_l, h=prover.msm_chunk_h))

    assignments = assignments_for(B, mini)
    phase_witness(prover, assignments, B,
                  WITNESS_LAUNCHES["mini" if mini else "confidential"])
    t0 = time.time()
    entries = phase_kernels(prover, B, gen, assignments)
    emit("kernels", seconds=time.time() - t0,
         all_equal=all(e["equal"] for e in entries),
         kernels=[{k: e[k] for k in ("name", "shape", "equal", "ms",
                                     "eager_ms", "plain_ms") if k in e}
                  for e in entries])
    bad = [e["name"] for e in entries if not e["equal"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")

    # ---- the main path: prove one batch, and the other MSM paths -------
    rs = [((0xA5A5 + 977 * i) * 0x9E3779B97F4A7C15 % R,
           (0x5A5A + 613 * i) * 0xC2B2AE3D27D4EB4F % R) for i in range(B)]
    cls = MiniProver if mini else ConfidentialProver
    proofs, path_proofs = prove_paths(prover, cls, assignments, rs, B, "",
                                      profile, counters, path_counts)
    phase_dist(prover, cls, assignments, rs, B, proofs, counters, path_counts)

    # ---- groth16.core through the card's backend ----------------------
    t0 = time.time()
    backend = TorchBackend()
    params = generate_parameters(cls.CIRCUIT(),
                                 **(MINI_TOXIC if mini else TOXIC),
                                 backend=backend)
    gen_s = time.time() - t0
    if params.vk != prover.vk:
        raise SystemExit("backend: generate_parameters gave another verifying key")
    reset_counters()
    in_backend = timed_backend(backend)
    t0 = time.time()
    backend_proof = create_proof(prover.circuit_for(assignments[0]), params,
                                 *rs[0], backend=backend)
    torch.cuda.synchronize()
    proof_s = time.time() - t0
    counts = {k: dict(v) for k, v in counters.items()}
    path_counts["backend"] = counts
    if ints_of([backend_proof]) != ints_of(proofs[:1]):
        raise SystemExit("backend: create_proof differs from prove's proof 0")
    emit("backend", generate_parameters_seconds=gen_s,
         create_proof_seconds=proof_s, vk_equal=True, proof_equal=True,
         create_proof_backend_seconds=in_backend,
         create_proof_host_seconds=proof_s - sum(in_backend.values()),
         launches=counts)
    if profile:
        profile_create_proof(create_proof, prover.circuit_for(assignments[0]),
                             params, rs[0], backend, proof_s)
    del params

    # ---- verify on the host ------------------------------------------
    phase_verify(prover, assignments, proofs,
                 {"prove_hs": (path_proofs["prove_hs"][1], 1),
                  "prove_split": (path_proofs["prove_split"][B - 2], B - 2),
                  "backend": (backend_proof, 0)},
                 B, prover.num_inputs - 1, "verify")
    return entries, proofs


def dist_only_phases(counters, path_counts):
    """--dist-only: crs and one warm and one timed prove on
    ConfidentialTransfer (the proofs the dist paths must give), then the
    dist phase."""
    from zerochain_tpu_torch.mirror.field import R
    from zerochain_tpu_torch.prover import ConfidentialProver

    B = 32
    t0 = time.time()
    prover = ConfidentialProver.from_toxic_waste(**TOXIC)
    torch.cuda.synchronize()
    emit("crs", seconds=time.time() - t0, constraints=prover.m,
         domain=prover.d)
    assignments = assignments_for(B, False)
    rs = [((0xA5A5 + 977 * i) * 0x9E3779B97F4A7C15 % R,
           (0x5A5A + 613 * i) * 0xC2B2AE3D27D4EB4F % R) for i in range(B)]
    proofs, _, path_counts["prove"], _ = drive(prover, "prove", assignments,
                                               rs, B, counters)
    phase_dist(prover, ConfidentialProver, assignments, rs, B, proofs,
               counters, path_counts)


def anonymous_phases(profile, gen, counters, path_counts):
    """The anon_ phases on AnonymousTransfer; -> the anon_kernels phase's
    entries."""
    from zerochain_tpu_torch.prover import AnonymousProver
    from zerochain_tpu_torch.prover import witness_anon as wa

    B = 32
    t0 = time.time()
    prover = AnonymousProver.from_toxic_waste(**ANON_TOXIC)
    torch.cuda.synchronize()
    emit("anon_crs", seconds=time.time() - t0, constraints=prover.m,
         domain=prover.d, inputs=prover.num_inputs, aux=prover.num_aux,
         dense=dict(a=len(prover.a_cols), b=len(prover.b_cols)),
         chunks=dict(a=prover.msm_chunk_a, b=prover.msm_chunk_b,
                     l=prover.msm_chunk_l, h=prover.msm_chunk_h),
         n_chunks={q: len(getattr(prover, f"{q}_chunks"))
                   for q in ("a", "b1", "b2", "l", "h")})

    assignments = wa.bench_assignments(B)
    phase_witness(prover, assignments, B, WITNESS_LAUNCHES["anonymous"],
                  "anon_witness")
    t0 = time.time()
    entries = (anon_witness_entries(prover, B, gen, assignments)
               + gadget_entries(prover, B, assignments, ".anon", "anon_prove")
               + anon_msm_entries(prover, B, assignments)
               + ntt_entries(prover, (8, B, prover.d), gen, "anon_prove", "anon",
                             evals=quotient_inputs(prover, assignments)))
    emit("anon_kernels", seconds=time.time() - t0,
         all_equal=all(e["equal"] for e in entries),
         kernels=[{k: e[k] for k in ("name", "shape", "equal", "ms", "plain_ms",
                                     "chunk", "heaviest_bucket") if k in e}
                  for e in entries])
    bad = [e["name"] for e in entries if not e["equal"]]
    if bad:
        raise SystemExit(f"anon_kernels disagree with their plain versions: {bad}")

    rs = [(3 + i, 5 + i) for i in range(B)]
    proofs, path_proofs = prove_paths(prover, AnonymousProver, assignments, rs,
                                      B, "anon_", profile, counters, path_counts)
    backend_proof = anon_backend(prover, assignments, rs, proofs, counters)
    phase_verify(prover, assignments, proofs,
                 {"prove_hs": (path_proofs["prove_hs"][1], 1),
                  "prove_split": (path_proofs["prove_split"][B - 2], B - 2),
                  "backend": (backend_proof, 0)},
                 B, prover.num_inputs - 1, "anon_verify")
    return entries


def anon_backend(prover, assignments, rs, proofs, counters):
    """Phase anon_backend: groth16.core.generate_parameters on the
    AnonymousTransfer circuit and ANON_TOXIC through TorchBackend must give
    the prover's verifying key, and create_proof on assignment 0 must give
    anon_prove's proof 0 (the reference's host prover over the card's
    backend, against the batched pipeline); -> that proof."""
    from zerochain_tpu_torch.groth16.core import create_proof, generate_parameters
    from zerochain_tpu_torch.prover import TorchBackend

    t_phase = time.time()
    backend = TorchBackend()
    params = generate_parameters(prover.CIRCUIT(), **ANON_TOXIC, backend=backend)
    gen_s = time.time() - t_phase
    if params.vk != prover.vk:
        raise SystemExit("anon_backend: generate_parameters gave another verifying key")
    reset_counters()
    in_backend = timed_backend(backend)
    t0 = time.time()
    proof = create_proof(prover.circuit_for(assignments[0]), params, *rs[0],
                         backend=backend)
    torch.cuda.synchronize()
    proof_s = time.time() - t0
    counts = {k: dict(v) for k, v in counters.items()}
    if ints_of([proof]) != ints_of(proofs[:1]):
        raise SystemExit("anon_backend: create_proof differs from anon_prove's proof 0")
    del params
    emit("anon_backend", seconds=time.time() - t_phase,
         generate_parameters_seconds=gen_s, create_proof_seconds=proof_s,
         vk_equal=True, proof_equal=True,
         create_proof_backend_seconds=in_backend,
         create_proof_host_seconds=proof_s - sum(in_backend.values()),
         launches=counts)
    return proof


REDDSA_BLOCK = 4096      # signatures: 3 x 4,096 = 12,288 chains
REDDSA_TAMPER = 2049
REDDSA_PLAIN_LANES = 384  # the var chain's lanes held against its plain version
PAIRING_BATCH = 32


def reddsa_sigs(n, tamper_at=None):
    """tests/test_redjubjub_batch.py's signatures: key i from its name, a
    fixed nonce seed t, the message of ``tamper_at`` replaced."""
    from zerochain_tpu_torch.protocol.redjubjub import PrivateKey

    entries = []
    for i in range(n):
        sk = PrivateKey(int.from_bytes(f"batch-sk-{i}".encode().ljust(16, b"\0"),
                                       "little"))
        msg = f"message-{i}".encode()
        sig = sk.sign(msg, t=bytes(((i + j) % 251 for j in range(80))))
        entries.append((sk.public_key(), b"tampered" if i == tamper_at else msg,
                        sig))
    return entries


def reddsa_block(n):
    """A block's n signed extrinsics: deterministic keys, nonce seeds t and
    randomizers z."""
    from zerochain_tpu_torch.mirror.field import S
    from zerochain_tpu_torch.protocol.redjubjub import PrivateKey

    entries, zs = [], []
    for i in range(n):
        sk = PrivateKey((0x5EED + i) * 0x9E3779B97F4A7C15 % S)
        msg = b"extrinsic-%d" % i
        sig = sk.sign(msg, t=(0xB10C0000 + i).to_bytes(8, "little") * 10)
        entries.append((sk.public_key(), msg, sig))
        zs.append((0xC0FFEE + 977 * i) * 0xD6E8FEB86659FD93 % S or 1)
    return entries, zs


def reddsa_chain_entry(bases, bits):
    """The var chain at the block's 3N lanes x 252 bits, its first
    REDDSA_PLAIN_LANES lanes against var_chain_plain word for word (the
    plain version's time is for those lanes)."""
    from zerochain_tpu_torch.ec import cuda_jubjub

    n_bits, lanes = bits.shape
    k = REDDSA_PLAIN_LANES
    got = cuda_jubjub.var_chain(bases, bits)
    part = tuple(b[:, :k].contiguous() for b in bases)
    want, plain_ms = timed(lambda: cuda_jubjub.var_chain_plain(part, bits[:, :k]))
    err = max_abs_err([g[..., :k] for g in got], list(want))
    del got
    ms = time_ms(lambda: cuda_jubjub.var_chain(bases, bits), 3)
    serial = 1 + n_bits * 9 + (n_bits - 1) * 8  # T, the adds, the doubles
    bnd, by = bound_ms(2 * 8 * 4 * lanes + n_bits * lanes
                       + 2 * 3 * 8 * 4 * n_bits * lanes,
                       serial * FR_MUL_OPS * lanes)
    return dict(
        name="jubjub.var_chain.reddsa", route="cuda",
        source="zerochain_tpu_torch/csrc/jubjub_kernels.cu", replaces=TPU_FF,
        counter=("jj", "var_chain"), path="reddsa", shape=[8, n_bits, lanes],
        equal=err == 0, max_abs_err=err, ms=ms, serial_mul=serial,
        us_per_mul=ms * 1e3 / serial, plain_ms=plain_ms, plain_lanes=k,
        bound_ms=bnd, bound_by=by, library_ms=None)


def phase_reddsa(gen, counters, path_counts, profile):
    """Batch RedJubjub verification on the card (protocol/redjubjub_device.py:
    batch_verify_device): the small cases of tests/test_redjubjub_batch.py
    against the host loop, the 16-entry total before the cofactor against
    the mirror's sum, then a block of REDDSA_BLOCK signatures (one warm
    call, one timed with the launch counters zeroed around it; one var_chain
    launch) accepted, and its tampered copy rejected.  -> kernel entries."""
    from zerochain_tpu_torch.ec import jubjub as ej
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.mirror import jubjub as jj
    from zerochain_tpu_torch.mirror.field import S
    from zerochain_tpu_torch.protocol import redjubjub as rj
    from zerochain_tpu_torch.protocol import redjubjub_device as rjd

    t_phase = time.time()
    verdicts = {}
    e128 = reddsa_sigs(128)
    zs = [3 + 11 * i for i in range(128)]
    verdicts["valid_128"] = (True, rjd.batch_verify_device(e128, rand_scalars=zs),
                             rj.batch_verify(e128, rand_scalars=zs))
    e16 = reddsa_sigs(16, tamper_at=7)
    zs16 = [5 + 7 * i for i in range(16)]
    verdicts["tampered_16"] = (False, rjd.batch_verify_device(e16, rand_scalars=zs16),
                               rj.batch_verify(e16, rand_scalars=zs16))
    e2 = reddsa_sigs(2)
    pk, msg, sig = e2[1]
    bad = [e2[0], (pk, msg, rj.Signature(sig.rbar, (S + 1).to_bytes(32, "little")))]
    verdicts["bad_s"] = (False, rjd.batch_verify_device(bad), rj.batch_verify(bad))
    for name, (want, dev, host) in verdicts.items():
        if dev != want or host != want:
            raise SystemExit(f"reddsa: {name}: card {dev}, host {host}, expected {want}")

    pts, scalars = rjd._terms(reddsa_sigs(16), rj.DEFAULT_BASE, zs16)
    total = rjd._device_total(*rjd._chain_inputs(pts, scalars, "cuda"))
    want = jj.ZERO
    for p, k in zip(pts, scalars):
        want = jj.add(want, jj.mul(p, k))
    if ej.to_affine_host(tuple(a[:, None] for a in total))[0] != want:
        raise SystemExit("reddsa: the card's 16-entry total is not the mirror's sum")

    t0 = time.time()
    block, bzs = reddsa_block(REDDSA_BLOCK)
    sign_s = time.time() - t0
    rjd.batch_verify_device(block, rand_scalars=bzs)  # warm
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.time()
    accepted = rjd.batch_verify_device(block, rand_scalars=bzs)
    secs = time.time() - t0
    counts = {k: dict(v) for k, v in counters.items()}
    split = dict(rjd.last_timings)
    path_counts["reddsa"] = counts
    tampered = list(block)
    pk, _, sig = tampered[REDDSA_TAMPER]
    tampered[REDDSA_TAMPER] = (pk, b"tampered", sig)
    t0 = time.time()
    rejected = not rjd.batch_verify_device(tampered, rand_scalars=bzs)
    tampered_s = time.time() - t0
    k1 = {k: v for k, v in counts["ff"].items() if v}
    emit("reddsa", small_cases={k: v[1] for k, v in verdicts.items()},
         total_16_equal=True, block=REDDSA_BLOCK, chains=3 * REDDSA_BLOCK,
         sign_seconds=sign_s, seconds=secs, host_seconds=split["host"],
         device_seconds=split["device"], signatures_per_second=REDDSA_BLOCK / secs,
         accepted=accepted, tampered_at=REDDSA_TAMPER, tampered_rejected=rejected,
         tampered_seconds=tampered_s, jubjub_launches=counts["jj"],
         k1_launches=sum(k1.values()), k1_by_op=k1,
         other_launches=sum(counts["ec"].values()) + sum(counts["scan"].values()))
    if not accepted or not rejected:
        raise SystemExit(f"reddsa: block accepted {accepted}, tampered copy "
                         f"rejected {rejected}")
    if counts["jj"] != {"var_chain": 1, "fixed_chain": 0}:
        raise SystemExit(f"reddsa: chain launches {counts['jj']}, expected one var_chain")
    if profile:
        profile_call(lambda: rjd.batch_verify_device(block, rand_scalars=bzs),
                     secs, "reddsa")

    bases, bits = rjd._chain_inputs(*rjd._terms(block, rj.DEFAULT_BASE, bzs), "cuda")
    width = 1 << (bits.shape[1] - 1).bit_length()
    entries = [reddsa_chain_entry(bases, bits)]
    # K1 at the tree's first level (Fr, width / 2 adds)
    entries += ff_entries(L.FR, (width // 2,), gen, ops=("mont_mul", "add", "sub"),
                          tag=".reddsa", path="reddsa")
    emit("reddsa_kernels", seconds=time.time() - t_phase,
         kernels=[{k: e[k] for k in ("name", "shape", "equal", "ms", "plain_ms")}
                  for e in entries])
    return entries


PAIRING_LAUNCHES = {"miller": 1, "final_exp": 1}  # a pairing_host_batch call


def pairing_entries(ps, qs, picks, tag, path):
    """The two pairing kernels (csrc/pairing_kernel.cu) on the pairs (ps,
    qs) of one batched call: pairing.miller (cuda_pairing.miller_set
    ("pairing"): the G2 preparation and the Miller loop) on the points' rows,
    pairing.final_exp on its output, each against its plain version
    (execute_plain) on the pairs ``picks``, word for word.  Bounds: the rows
    each reads and writes, or its Fq multiplies (the Fermat power as its
    multiplies) and its adds, subtracts and moves, whichever is larger."""
    from zerochain_tpu_torch.ec import cuda_pairing as CP
    from zerochain_tpu_torch.ec import pairing as DP
    from zerochain_tpu_torch.ff import limbs as L

    (px, py), (qx, qy) = DP.g1_tensors(ps, "cuda"), DP.g2_tensors(qs, "cuda")
    ins = DP._rows([px, py, qx[:, 0], qx[:, 1], qy[:, 0], qy[:, 1]], 1, (len(ps),))
    f = CP.execute(CP.miller_set("pairing"), ins)
    out = []
    for name, pset, x in (("miller", CP.miller_set("pairing"), ins),
                          ("final_exp", CP.final_exp_set(), f)):
        got = CP.execute(pset, x)
        few = x[..., picks].contiguous()
        CP.execute_plain(pset, few)  # warm: the plain version caches its constants
        want, plain_ms = timed(lambda: CP.execute_plain(pset, few))
        err = max_abs_err([got[..., picks]], [want])
        c = pset.counts
        n = len(ps)
        n_bytes = (pset.n_in + pset.n_out) * 48 * n
        n_ops = ((c["mul"] + c["inv"] * fermat_muls(L.FQ)) * FQ_MUL_OPS
                 + c["linear"] * 2 * 12) * n
        bnd, by = bound_ms(n_bytes, n_ops)
        out.append(dict(
            name=f"pairing.{name}{tag}", route="cuda",
            source="zerochain_tpu_torch/csrc/pairing_kernel.cu", replaces=TPU_FF,
            counter=("pp", name), path=path, shape=[12, pset.n_in, n],
            stages=c["stages"], mul_stages=c["mul_stages"], slots=c["slots"],
            fq_muls=c["mul"], fermat_powers=c["inv"], equal=err == 0, max_abs_err=err,
            ms=time_ms(lambda: CP.execute(pset, x), 3), plain_ms=plain_ms,
            plain_lanes=len(picks), bound_ms=bnd, bound_by=by, library_ms=None))
    return out


def phase_pairing(proofs, gen, counters, path_counts, profile):
    """The BLS12-381 pairing on the card (ec/pairing.py over the two program
    sets of ec/cuda_pairing.py, csrc/pairing_kernel.cu): e(G1, G2) and
    bilinearity against the mirror (which the CPU tests pin to RELIC), a
    3-pair Miller loop (g2_prepare, then miller_loop over the three) and one
    final exponentiation, and e(A_i, B_i) of the proofs (without proofs:
    PAIRING_BATCH pairs of generator multiples) in one batched call, each
    against the mirror; seconds and launches of a call at batch 1 and at the
    proofs' batch (one warm call, one timed with the counters zeroed around
    it): it fails unless a call launches PAIRING_LAUNCHES and no other
    kernel (no K1).  Then the kernels at both batches against their plain
    versions, and the tower chain of K1 launches (ec/pairing.py: *_tower)
    timed once at the full batch (k1_loop_ms).  -> kernel entries (the two
    pairing kernels at batch 1 and at the batch; K1 at the pairing's former
    shapes, now off the path)."""
    from zerochain_tpu_torch.ec import pairing as DP
    from zerochain_tpu_torch.ec import tower as T
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.mirror import curves as C
    from zerochain_tpu_torch.mirror import pairing as P

    t_phase = time.time()
    if DP.pairing_host(C.G1_GEN, C.G2_GEN) != P.pairing(C.G1_GEN, C.G2_GEN):
        raise SystemExit("pairing: e(G1, G2) differs from the mirror's")
    a, b = 0x1234567, 0x89ABCDE
    pa, qb = C.g1_mul(C.G1_GEN, a), C.g2_mul(C.G2_GEN, b)
    e = DP.pairing_host_batch([pa, C.g1_mul(C.G1_GEN, a * b)], [qb, C.G2_GEN])
    if e[0] != e[1] or e[0] != P.pairing(pa, qb):
        raise SystemExit("pairing: e(aP, bQ) != e(abP, Q), or not the mirror's")
    ps3 = [C.g1_mul(C.G1_GEN, k) for k in (3, 0x10001, 0xDEADBEEF)]
    qs3 = [C.g2_mul(C.G2_GEN, k) for k in (5, 0xABCDEF, 77)]
    pairs = [(DP.g1_tensors([p], "cuda"), DP.g2_prepare(*DP.g2_tensors([q], "cuda")))
             for p, q in zip(ps3, qs3)]
    f = DP.final_exponentiation(DP.miller_loop(pairs))
    if T.fq12_to_ints(f) != [P.final_exponentiation(P.miller_loop(list(zip(ps3, qs3))))]:
        raise SystemExit("pairing: the 3-pair Miller loop + final exponentiation "
                         "differs from the mirror's")

    if proofs is None:
        ps = [C.g1_mul(C.G1_GEN, 3 + 7 * i) for i in range(PAIRING_BATCH)]
        qs = [C.g2_mul(C.G2_GEN, 5 + 11 * i) for i in range(PAIRING_BATCH)]
        source = "generator multiples"
    else:
        ps, qs = [p.a for p in proofs], [p.b for p in proofs]
        source = "proofs (A, B)"
    runs = {}
    for n in sorted({1, len(ps)}):
        DP.pairing_host_batch(ps[:n], qs[:n])  # warm
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.time()
        got = DP.pairing_host_batch(ps[:n], qs[:n])
        secs = time.time() - t0
        counts = {k: dict(v) for k, v in counters.items()}
        k1 = {k: v for k, v in counts["ff"].items() if v}
        others = {f"{g}.{k}": v for g, c in counts.items() if g not in ("ff", "pp")
                  for k, v in c.items() if v}
        runs[n] = dict(seconds=secs, pairings_per_second=n / secs,
                       pairing_launches=counts["pp"], k1_launches=sum(k1.values()),
                       k1_by_op=k1, other_launches=sum(others.values()))
        path_counts["pairing" if n == len(ps) else "pairing_b1"] = counts
        if counts["pp"] != PAIRING_LAUNCHES or k1 or others:
            raise SystemExit(f"pairing: a call at batch {n} launched {counts['pp']}, K1 "
                             f"{k1}, others {others}: expected {PAIRING_LAUNCHES} and "
                             "nothing else")
    t0 = time.time()
    want = [P.pairing(p, q) for p, q in zip(ps, qs)]
    mirror_s = time.time() - t0
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise SystemExit(f"pairing: batched pairings {bad} differ from the mirror's")
    emit("pairing", generator_equal=True, bilinear=True, miller_3_pairs_equal=True,
         batch=len(ps), batch_of=source, batch_equal=True,
         mirror_seconds=mirror_s, runs=runs)
    if profile:
        profile_call(lambda: DP.pairing_host_batch(ps, qs), runs[len(ps)]["seconds"],
                     "pairing")

    n = len(ps)
    entries = pairing_entries(ps[:1], qs[:1], [0], ".b1", "pairing_b1")
    entries += pairing_entries(ps, qs, [0, n - 1], "", "pairing")
    # the tower chain of K1 launches at the full batch, once each half
    (px, py), (qx, qy) = DP.g1_tensors(ps, "cuda"), DP.g2_tensors(qs, "cuda")
    reset_counters()
    fm, miller_loop_ms = timed(lambda: DP.miller_loop_tower(
        [((px, py), DP.g2_prepare_tower(qx, qy))]))
    fe, final_loop_ms = timed(lambda: DP.final_exponentiation_tower(fm))
    k1_loop = {k: v for k, v in counters["ff"].items() if v}
    if T.fq12_to_ints(fe) != got:
        raise SystemExit("pairing: the K1 tower chain differs from the kernels")
    entries[-2]["k1_loop_ms"], entries[-1]["k1_loop_ms"] = miller_loop_ms, final_loop_ms
    entries[-2]["k1_loop_launches"] = entries[-1]["k1_loop_launches"] = sum(k1_loop.values())
    # K1 at the pairing's former shapes at this batch (off the path now): the
    # Fq multiplies of one fq12_mul (3 Karatsuba x 6 x 3 products a pairing),
    # an Fq12's adds, and the inverse of one fq2_inv
    k1 = ff_entries(L.FQ, (54 * n,), gen, ops=("mont_mul",), tag=".pairing")
    k1 += ff_entries(L.FQ, (12 * n,), gen, ops=("add", "sub"), tag=".pairing")
    k1.append(inv_entry(L.FQ, (max(n, 3),), gen, True, tag=".pairing"))
    for e in k1:
        e["off_path"], e["path"] = True, "pairing"
    entries += k1
    emit("pairing_kernels", seconds=time.time() - t_phase, k1_loop_by_op=k1_loop,
         kernels=[{k: e[k] for k in ("name", "shape", "equal", "ms", "plain_ms",
                                     "k1_loop_ms") if k in e} for e in entries])
    return entries


def verify_phases(proofs, profile, gen, counters, path_counts):
    """The reddsa and pairing phases; -> their kernel entries."""
    return (phase_reddsa(gen, counters, path_counts, profile)
            + phase_pairing(proofs, gen, counters, path_counts, profile))


CLI_PHRASE = ("legal winner thank year wave sausage worth useful legal "
              "winner thank yellow")
CLI_TIMEOUT = 300  # seconds a CLI subprocess may take


def phase_cli(counters):
    """The zface flow through the port's command line, in a temporary
    directory: wallet and chain commands as ``python -m zerochain_tpu_torch``
    subprocesses, ``snark setup`` and ``tx send`` with ``--backend torch``
    in process (their launches counted, their seconds split into the
    backend's calls and the host's rest), the balances after the transfer
    and after a rollover, a corrupted proof rejected by the runtime (the
    same call with the real proof accepted), and an RpcServer over the
    saved runtime.  Fails unless setup launched FixedBaseMsm's K2 adds, tx
    send the bucket MSM's bucket_sums and bucket_fold, and the native
    codec's C library loaded (msm/pippenger.py's scalars_to_bits goes
    through it)."""
    import contextlib
    import io
    import os
    import pathlib
    import pickle
    import tempfile

    from zerochain_tpu_torch import cli
    from zerochain_tpu_torch.groth16.serialization import proof_to_bytes, proof_from_bytes
    from zerochain_tpu_torch.native import codec
    from zerochain_tpu_torch.rpc import RpcClient, RpcServer
    from zerochain_tpu_torch.runtime.encrypted_balances import DispatchError
    from zerochain_tpu_torch.runtime.primitives import EncKey, ProofBytes
    from zerochain_tpu_torch.wallet.ss58 import decode_ss58

    t_phase = time.time()
    if not codec.native_available():
        raise SystemExit("cli: the native codec's C library did not load")
    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    seconds, launches, backend_seconds = {}, {}, {}

    with tempfile.TemporaryDirectory(prefix="zc_cli_") as tmp:
        wallet, chain = f"{tmp}/wallet", f"{tmp}/chain"
        pk, vk = f"{tmp}/conf_pk.dat", f"{tmp}/conf_vk.dat"
        state = pathlib.Path(chain) / "chain_state.pickle"
        pw = ["--password", "pw"]

        def sub(name, *argv):
            t0 = time.time()
            out = subprocess.run(
                [sys.executable, "-m", "zerochain_tpu_torch", *argv], cwd=tmp,
                env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT)
            seconds[name] = time.time() - t0
            if out.returncode != 0:
                raise SystemExit(f"cli: {name} exited {out.returncode}:\n"
                                 f"{out.stderr[-3000:]}")
            return out.stdout

        def inproc(name, *argv):
            """cli.main in this process, launch counters zeroed just before
            and read just after, the backend's calls timed."""
            make = cli._backend

            def timed(args):
                be = make(args)
                backend_seconds[name] = timed_backend(
                    be, ("fixed_base_g1", "fixed_base_g2", "msm_g1", "msm_g2",
                         "compute_h"))
                return be

            buf = io.StringIO()
            cli._backend = timed
            try:
                torch.cuda.synchronize()
                reset_counters()
                t0 = time.time()
                with contextlib.redirect_stdout(buf):
                    cli.main(list(argv))
                torch.cuda.synchronize()
                seconds[name] = time.time() - t0
            finally:
                cli._backend = make
            launches[name] = {f"{grp}.{k}": n for grp, c in counters.items()
                              for k, n in c.items() if n}
            return buf.getvalue()

        def balance(account=None):
            return sub(f"wallet_balance_{account or 'default'}", "wallet",
                       "balance", "--wallet", wallet, *pw, "--chain", chain,
                       *(["--account", account] if account else []))

        # 1. wallet
        sub("wallet_recovery", "wallet", "recovery", "--wallet", wallet, *pw,
            CLI_PHRASE)
        sub("wallet_add_account", "wallet", "add-account", "--wallet", wallet,
            *pw, "bob")
        addr = {}
        for line in sub("wallet_list", "wallet", "list", "--wallet",
                        wallet).splitlines():
            name, address = line[2:].split(": ")
            addr[name] = address
        # 2. trusted setup on the card
        inproc("snark_setup", "snark", "setup", "--circuit", "confidential",
               "--pk", pk, "--vk", vk, "--backend", "torch")
        sizes = dict(pk_bytes=os.path.getsize(pk), vk_bytes=os.path.getsize(vk))
        if sizes["vk_bytes"] != 41966:
            raise SystemExit(f"cli: the prepared vk has {sizes['vk_bytes']} "
                             "bytes, not the reference's 41,966")
        # 3. genesis
        sub("chain_init", "chain", "init", "--chain", chain, "--conf-vk", vk)
        sub("chain_endow", "chain", "endow", "--chain", chain, addr["default"],
            "100")
        before_send = state.read_bytes()
        # 4. the transfer, proved on the card
        out = inproc("tx_send", "tx", "send", "--wallet", wallet, *pw,
                     "--chain", chain, "--pk", pk, "--vk", vk, "--to",
                     addr["bob"], "--amount", "30", "--backend", "torch")
        if "transfer applied; events: ['ConfidentialTransfer']" not in out:
            raise SystemExit(f"cli: tx send did not apply the transfer: {out}")
        after_send = state.read_bytes()
        # 5. balances
        got = dict(sender=balance(), bob=balance("bob"))
        if ("balance: 69" not in got["sender"]
                or "pending: 30" not in got["bob"]):
            raise SystemExit(f"cli: balances after the transfer: {got}")
        # 6. a rollover in the next epoch
        sub("chain_next_block", "chain", "next-block", "--chain", chain,
            "--count", "7")
        rt = pickle.loads(state.read_bytes())
        rt.encrypted_balances.rollover(EncKey(decode_ss58(addr["bob"])))
        state.write_bytes(pickle.dumps(rt))
        got["bob_after_rollover"] = balance("bob")
        if "balance: 30" not in got["bob_after_rollover"]:
            raise SystemExit(f"cli: bob after the rollover: {got}")

        # 7. the transfer's call again on the state before it: rejected with
        # A and C swapped (a proof that decodes, against the same inputs),
        # accepted with the real proof
        sent = pickle.loads(after_send)
        ev = sent.encrypted_balances.events[-1]
        call = dict(address_sender=ev[2], address_recipient=ev[3],
                    amount_sender=ev[4], amount_recipient=ev[5],
                    fee_sender=ev[6], randomness=ev[7],
                    nonce=sent.zk_system.nonce_pool[-1])
        real = ev[1].data
        p = proof_from_bytes(real)
        swapped = proof_to_bytes(type(p)(a=p.c, b=p.b, c=p.a))
        t0 = time.time()
        rt = pickle.loads(before_send)
        try:
            rt.encrypted_balances.confidential_transfer(
                ev[9], zkproof=ProofBytes(swapped), **call)
            raise SystemExit("cli: the runtime accepted a corrupted proof")
        except DispatchError as e:
            rejected = str(e)
        if rt.encrypted_balances.events[-1] != ("InvalidZkProof",) or (
                rt.zk_system.nonce_pool):
            raise SystemExit("cli: the rejection changed the state")
        rt = pickle.loads(before_send)
        rt.encrypted_balances.confidential_transfer(
            ev[9], zkproof=ProofBytes(real), **call)
        seconds["runtime_verify_twice"] = time.time() - t0

        # 8. the node side: RPC over the saved runtime
        rt = pickle.loads(state.read_bytes())
        server = RpcServer(rt).start()
        try:
            api = RpcClient(f"http://127.0.0.1:{server.port}")
            rpc = dict(block_number=api.get_block_number(),
                       sender_nonce=api.get_nonce(ev[9].data))
        finally:
            server.stop()
        if rpc != dict(block_number=rt.block_number, sender_nonce=1):
            raise SystemExit(f"cli: RPC read {rpc}, the state holds "
                             f"block {rt.block_number}")

    need = {"snark_setup": ("ec.g1_add", "ec.g2_add"),
            "tx_send": ("ec.g1_bucket_sums", "ec.g2_bucket_sums",
                        "ec.g1_bucket_fold", "ec.g2_bucket_fold")}
    missing = {cmd: [k for k in keys if not launches[cmd].get(k)]
               for cmd, keys in need.items()}
    if any(missing.values()):
        raise SystemExit(f"cli: kernels not launched: {missing}")
    emit("cli", seconds=time.time() - t_phase, command_seconds=seconds,
         backend_seconds=backend_seconds,
         host_seconds={k: seconds[k] - sum(v.values())
                       for k, v in backend_seconds.items()},
         balances={k: v.split() for k, v in got.items()},
         corrupted_proof=rejected, rpc=rpc, native_codec=True, **sizes)
    emit("cli_launches", **launches)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mini", action="store_true",
                    help="drive the MiniCommit fixture instead of the "
                         "ConfidentialTransfer circuit, and skip the "
                         "AnonymousTransfer phases (a quick check)")
    ap.add_argument("--anon-only", action="store_true",
                    help="run the build and the AnonymousTransfer phases "
                         "alone")
    ap.add_argument("--verify-only", action="store_true",
                    help="run the build and the verifier-side phases (reddsa, "
                         "pairing) alone")
    ap.add_argument("--cli-only", action="store_true",
                    help="run the build and the cli phase (the command "
                         "line's wallet -> setup -> transfer flow) alone")
    ap.add_argument("--dist-only", action="store_true",
                    help="run the build, crs, prove and the dist phase "
                         "(ZEROCHAIN_DIST=1 in an NCCL world of one) alone")
    ap.add_argument("--profile", action="store_true",
                    help="after each path's timed run, prove once more "
                         "under torch.profiler and print the card's idle "
                         "share")
    args = ap.parse_args()
    if (args.mini + args.anon_only + args.verify_only + args.cli_only
            + args.dist_only) > 1:
        ap.error("--mini, --anon-only, --verify-only, --cli-only and "
                 "--dist-only exclude each other")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the GPU",
              file=sys.stderr)
        return 2

    from zerochain_tpu_torch import _build
    from zerochain_tpu_torch.ec import cuda_ec, cuda_jubjub, cuda_pairing
    from zerochain_tpu_torch.ff import cuda_ff
    from zerochain_tpu_torch.msm import cuda_scan
    from zerochain_tpu_torch.ntt import ntt as tntt
    from zerochain_tpu_torch.prover import cuda_witness

    t_run = time.time()
    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    emit("device", kind=torch.cuda.get_device_name(0), card=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=" ".join(re.findall(r"release [^\n]+", nvcc)),
         ninja=shutil.which("ninja") is not None)

    t0 = time.time()
    _build.build_all()
    for name in _build.SOURCES:
        _build.lib(name)
    ptxas = {}
    for name, log in _build.ptxas_log.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", log)]
        ptxas[name] = dict(max_registers=max(regs, default=None),
                           max_spill_store_bytes=max(spills, default=None),
                           max_stack_frame_bytes=max(stack, default=None),
                           functions=ptxas_entries(log),
                           sass=sass_size(_build.lib_path(name)))
    emit("build", seconds=time.time() - t0, ptxas=ptxas)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    counters = {"ff": cuda_ff.launches, "ec": cuda_ec.launches,
                "scan": cuda_scan.launches, "jj": cuda_jubjub.launches,
                "ntt": tntt.launches, "wit": cuda_witness.launches,
                "pp": cuda_pairing.launches}
    path_counts = {}
    entries = []
    proofs = None
    only = args.anon_only or args.verify_only or args.cli_only or args.dist_only
    if args.dist_only:
        dist_only_phases(counters, path_counts)
    if not only:
        conf, proofs = confidential_phases(args.mini, args.profile, gen,
                                           counters, path_counts)
        entries += conf
    if not (args.mini or args.verify_only or args.cli_only or args.dist_only):
        torch.cuda.empty_cache()  # the confidential prover is gone
        entries += anonymous_phases(args.profile, gen, counters, path_counts)
    if not (args.anon_only or args.cli_only or args.dist_only):
        torch.cuda.empty_cache()
        entries += verify_phases(proofs, args.profile, gen, counters, path_counts)
    if not (args.mini or args.anon_only or args.verify_only or args.dist_only):
        torch.cuda.empty_cache()
        phase_cli(counters)

    for e in entries:
        counter = e.pop("counter")  # None: a shape no path runs
        e["launches"] = 0 if counter is None else sum(  # (group, key, ...)
            path_counts[e.get("path", "prove")][counter[0]][k] for k in counter[1:])
    idle = [e["name"] for e in entries
            if not e.get("off_path") and e["launches"] == 0]
    if idle:
        raise SystemExit(f"kernels of the main path never launched: {idle}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "shape")
    # eager_ms: see the module docstring; one_lane_ms: a chain kernel with one
    # lane a point; nonzero_digits, row_nonzero_q, n_madd, n_add: what a
    # data-dependent bound was computed from; rows_checked: programs held
    # against the plain version; heaviest_bucket, heaviest_at:
    # the largest bucket of the bucket sums' rows; path: the run whose
    # launches are counted; off_path: checked, on no path's main run
    # serial_mul, us_per_mul: a serial chain's multiplies a thread and its
    # time over them; k1_loop_ms: a Jubjub chain as its former loop of
    # field-kernel launches; chunk, heaviest_bucket_g1 / _g2: the anonymous
    # chunk an entry ran on, and the batch's largest bucket over all chunks;
    # plain_lanes: the lanes the plain version ran on (its plain_ms);
    # window_c: an MSM kernel's window width where it is not the paths' 8;
    # passes: an NTT's pass launches a transform; quotient_launches,
    # quotient_k1_launches: the NTT and K1 launches of one quotient alone;
    # program, stages, slots, fermat_powers: a gadget program's name and
    # size, its Fermat powers a proof; jobs: a step launch's emission blocks;
    # mul_stages, fq_muls: a pairing kernel's multiply stages and Fq
    # multiplies a pairing; k1_loop_launches: the K1 launches of its tower
    # chain (k1_loop_ms)
    extras = ("eager_ms", "one_lane_ms", "nonzero_digits", "row_nonzero_q",
              "n_madd", "n_add", "heaviest_bucket", "heaviest_at", "rows_checked",
              "path", "off_path", "serial_mul", "us_per_mul", "k1_loop_ms",
              "chunk", "heaviest_bucket_g1", "heaviest_bucket_g2",
              "plain_lanes", "window_c", "passes", "quotient_launches",
              "quotient_k1_launches", "program", "stages", "slots",
              "fermat_powers", "jobs", "mul_stages", "fq_muls", "k1_loop_launches")
    print(json.dumps({"kernels": [
        {**{k: e[k] for k in keys}, **{k: e[k] for k in extras if k in e}}
        for e in entries]}), flush=True)
    print(card, flush=True)
    emit("done", seconds=time.time() - t_run)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
