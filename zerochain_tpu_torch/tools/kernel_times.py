"""Time window_totals and the point chains of one checkout of the port.

    python3 zerochain_tpu_torch/tools/kernel_times.py [--root DIR] [--tag T]
        [--prove] [--witness] [--hs] [--split] [--quotient] [--no-synthetic]
        [--no-chains] [--no-totals]

Imports ``zerochain_tpu_torch`` and ``chip_smoke`` from DIR (default: the
checkout this file is in), so that two checkouts can be timed in one call on
one card, in turns (parent, change, change, parent), each in its own
process: an older checkout unpacked from ``git archive`` into an ignored
directory is timed by this file of the newer one.  Builds the kernels,
generates the ConfidentialTransfer CRS and prints JSON lines:

- ``window_totals`` on one 16,384-point chunk (G1 and G2) with uniform and
  zero-heavy digits, and its sum over all chunks of the five MSMs on the
  digits of the batch ``chip_smoke.py`` proves (B = 32): milliseconds per
  launch by CUDA events, each launch checked against the plain version on a
  2,048-point, 4-proof slice after normalisation;
- where the checkout has them, the ladder (96 G1, 32 G2 points, 255 bits)
  and the Horner combine (32 windows x 32, c = 8) with 32, 16, 8 and 1 lanes
  a point, each checked word for word against its plain version;
- with --prove: ``ConfidentialProver.prove`` of that batch, one warm call
  then three timed ones (host clock around a synchronize, stage times with
  ``sync_stages``), and the proofs' equality across the three; and the
  SHA-256 of the warm call's 32 proofs (``prove_digest``), which two
  checkouts that prove alike print alike;
- with --hs: the bucket MSM path, ``ConfidentialProver(msm_impl="hs")`` on
  the same CRS, one warm call then three timed ones of that batch (stage
  times, launches by kernel where the checkout counts them, torch.roll's
  calls, the proofs' equality with ``prove``'s), then
  ``groth16.core.generate_parameters`` and one ``create_proof`` through
  ``TorchBackend``, its seconds split into the backend's device entry
  points (each ended by a synchronize) and the host's rest;
- with --split: the suffix MSM's split tail,
  ``ConfidentialProver(msm_tail="split")`` on the same CRS, timed as --hs
  times its path;
- with --witness: the witness stage of that batch alone
  (``confidential_witness`` on the card), one warm call then three timed
  ones, each with its field-kernel (K1) launches by op and by shape and,
  where the checkout has them, its Jubjub chain and witness-kernel
  launches; the same for ``anonymous_witness`` on ``bench_assignments(32)``;
  the field kernels' time a launch at the witness stage's shapes, (8, 160),
  (8, 192) and (8, 1) Fr elements: a back-to-back loop through the wrapper
  (eager_ms) and inside a CUDA graph (ms); and the inverse's at the shapes
  the witnesses invert, (8, 32), (8, 96), (8, 15936) and (8, 40320) (CUDA
  events, bound by its Fermat power's multiply-adds);
- with --quotient: the quotient stage of that batch split into the
  constraint matvec, the padding and ``ntt.quotient``, three times each
  (CUDA events), with the quotient's launches by kernel (K1 and, where the
  checkout has them, the NTT kernels) and the SHA-256 of its output; and
  each transform of the plan alone (ntt, intt, coset_ntt, icoset_ntt,
  divide_by_z_on_coset) at the batch's (8, 32, d);
- unless --no-totals: window_totals on the batch's real digits.

Needs a CUDA card; the first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--prove", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--hs", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--no-synthetic", action="store_true")
    ap.add_argument("--no-chains", action="store_true")
    ap.add_argument("--quotient", action="store_true")
    ap.add_argument("--no-totals", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from zerochain_tpu_torch import _build
    from zerochain_tpu_torch.ec import cuda_ec
    from zerochain_tpu_torch.ec import weierstrass as W
    from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.msm import cuda_scan
    from zerochain_tpu_torch.msm import pippenger as pip
    from zerochain_tpu_torch.prover import ConfidentialProver

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    def emit(**kw):
        print(json.dumps({"tag": args.tag, **kw}), flush=True)

    def leaves(p):
        return [t for c in p for t in (c if isinstance(c, tuple) else (c,))]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))

    _build.build_all()
    prover = ConfidentialProver.from_toxic_waste(**chip_smoke.TOXIC)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def totals_ok(F, msm, chunk, scal):
        small = pip.tmap(lambda t: t[:, :2048].contiguous(), chunk)
        sd, od = msm.prep(msm.digits(scal[:, :2048, :4]))
        got = W.normalize(F, cuda_scan.window_totals(F, small, sd, od, msm.nb))
        want = W.normalize(F, cuda_scan.window_totals_plain(F, small, sd, od, msm.nb))
        return same(got[:2], want[:2]) and torch.equal(got[2], want[2])

    for F, msm, chunk in () if args.no_synthetic else (
            (FqOps, prover.msm_g1, prover.h_chunks[0]),
            (Fq2Ops, prover.msm_g2, prover.b2_chunks[0])):
        N = pip.first_leaf(chunk).shape[-1]
        for dist in ("uniform", "zero_heavy"):
            scal = chip_smoke.random_elements(L.FR, (N, 32), gen)
            if dist == "zero_heavy":
                r = torch.rand((N, 32), generator=gen, device="cuda")
                scal = torch.where((r < 0.9)[None], torch.zeros_like(scal), scal)
                scal[0] = torch.where(r < 0.9, (r < 0.45).to(torch.int32), scal[0])
            sd, od = msm.prep(msm.digits(scal))
            emit(kernel="window_totals", group=F.name, digits=dist,
                 equal=totals_ok(F, msm, chunk, scal),
                 ms=chip_smoke.time_ms(lambda: cuda_scan.window_totals(
                     F, chunk, sd, od, msm.nb), 3))

    assignments = chip_smoke.assignments_for(32, False)
    if args.witness:
        import time

        from zerochain_tpu_torch.ff import cuda_ff
        try:
            from zerochain_tpu_torch.ec import cuda_jubjub
        except ImportError:  # a checkout from before the chain kernels
            cuda_jubjub = None
        try:
            from zerochain_tpu_torch.prover import cuda_witness
        except ImportError:  # a checkout from before the witness kernels
            cuda_witness = None
        from zerochain_tpu_torch.prover import witness_anon as wa

        shapes = {}  # (op, shape) -> K1 launches, counted at the wrapper

        def by_shape(op, fn):
            def f(spec, *a):
                key = f"{op}.{spec.name} {tuple(a[0].shape)}"
                shapes[key] = shapes.get(key, 0) + 1
                return fn(spec, *a)
            return f

        wrapped = {op: getattr(cuda_ff, op) for op in ("mont_mul", "add", "sub", "inv")}
        for op, fn in wrapped.items():
            setattr(cuda_ff, op, by_shape(op, fn))
        conf = (prover._witness_fns(), assignments)
        anon = ((wa.witness_inputs_host, wa.anonymous_witness), wa.bench_assignments(32))
        for name, ((inputs_host, witness_fn), asg) in (("witness", conf),
                                                       ("anon_witness", anon)):
            first = witness_fn(**inputs_host(asg, prover.device))
            for _ in range(3):
                shapes.clear()
                for mod in (cuda_ff, cuda_jubjub, cuda_witness):
                    if mod is not None:
                        mod.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = witness_fn(**inputs_host(asg, prover.device))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                by_op = {k: v for k, v in cuda_ff.launches.items() if v}
                emit(kernel=name, seconds=secs, k1_launches=sum(by_op.values()),
                     k1_by_op=by_op, k1_by_shape=dict(shapes), jubjub_launches=(
                         dict(cuda_jubjub.launches) if cuda_jubjub else None),
                     witness_launches=(
                         dict(cuda_witness.launches) if cuda_witness else None),
                     same_witness=all(torch.equal(a, b) for a, b in zip(out, first)))
            del first, out
        for op, fn in wrapped.items():
            setattr(cuda_ff, op, fn)
        for n in (32, 96, 15936, 40320):
            a = chip_smoke.random_elements(L.FR, (n,), gen)
            muls = chip_smoke.fermat_muls(L.FR)
            bnd, by = chip_smoke.bound_ms(2 * 8 * 4 * n, muls * chip_smoke.FR_MUL_OPS * n)
            emit(kernel="ff.inv.Fr", shape=[8, n],
                 ms=chip_smoke.time_ms(lambda: cuda_ff.inv(L.FR, a), 5),
                 bound_ms=bnd, bound_by=by)
        for n in (160, 192, 1):
            a, b = (chip_smoke.random_elements(L.FR, (n + 3,), gen)[:, 3:].contiguous()
                    for _ in range(2))
            for op in ("mont_mul", "add", "sub"):
                run = lambda: getattr(cuda_ff, op)(L.FR, a, b)  # noqa: E731
                ops = 2 * 8 * 8 + 8 if op == "mont_mul" else 2 * 8
                bnd, by = chip_smoke.bound_ms(3 * 8 * 4 * n, ops * n)
                emit(kernel=f"ff.{op}.Fr", shape=[8, n],
                     eager_ms=chip_smoke.time_ms(run, 200),
                     ms=chip_smoke.graph_ms(run), bound_ms=bnd, bound_by=by)
    if args.prove:
        import time

        import hashlib

        rs = _rs()
        prover.sync_stages = True
        first = prover.prove(assignments, rs=rs)
        emit(kernel="prove_digest", sha256=hashlib.sha256(repr(
            [(p.a, p.b, p.c) for p in first]).encode()).hexdigest())
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = prover.prove(assignments, rs=rs)
            torch.cuda.synchronize()
            emit(kernel="prove", seconds=time.perf_counter() - t0,
                 stages=prover.last_timings,
                 same_proofs=[(p.a, p.b, p.c) for p in out]
                 == [(p.a, p.b, p.c) for p in first])
    if args.hs:
        path_times(prover, assignments, emit, "hs")
        backend_times(prover, assignments, emit)
    if args.split:
        path_times(prover, assignments, emit, "split")
    if args.quotient:
        quotient_times(prover, assignments, emit)
    if args.no_totals:
        return 0
    inputs_host, witness_fn = prover._witness_fns()
    aux, public = witness_fn(**inputs_host(assignments, prover.device))
    preps = prover._digits(*prover._quotient(aux, public))
    chunks = (prover.a_chunks, prover.b1_chunks, prover.b2_chunks,
              prover.l_chunks, prover.h_chunks)
    ms = {}
    for name, ch, pr in zip(("a", "b1", "b2", "l", "h"), chunks, preps):
        F, msm = ((Fq2Ops, prover.msm_g2) if name == "b2"
                  else (FqOps, prover.msm_g1))
        ms[name] = sum(chip_smoke.time_ms(lambda: cuda_scan.window_totals(
            F, c, sd, od, msm.nb), 3) for c, (sd, od) in zip(ch, pr))
    emit(kernel="window_totals", digits="real", ms_by_msm=ms, ms=sum(ms.values()))

    if args.no_chains or not hasattr(cuda_ec, "ladder"):
        return 0
    for F, raw, n in ((FqOps, prover._raw_queries[0], 96),
                      (Fq2Ops, prover._raw_queries[4], 32)):
        base = pip.tmap(lambda t: t[:, :n].clone(), raw)
        bits = torch.randint(0, 2, (255, n), generator=gen, device="cuda",
                             dtype=torch.int32)
        want = cuda_ec.ladder_plain(F, base, bits)
        for lanes in (32, 16, 8, 1):
            run = lambda: cuda_ec.ladder(F, base, bits, lanes=lanes)  # noqa: E731
            emit(kernel="ladder", group=F.name, points=n, lanes=lanes,
                 equal=same(run(), want), ms=chip_smoke.time_ms(run, 3))
    for F, raw in ((FqOps, prover._raw_queries[0]), (Fq2Ops, prover._raw_queries[4])):
        tot = pip.tmap(lambda t: t[:, :1024].reshape(12, 32, 32).clone(), raw)
        want = cuda_ec.horner_plain(F, tot, 8)
        for lanes in (32, 16, 8, 1):
            run = lambda: cuda_ec.horner(F, tot, 8, lanes=lanes)  # noqa: E731
            emit(kernel="horner", group=F.name, lanes=lanes,
                 equal=same(run(), want), ms=chip_smoke.time_ms(run, 3))
    return 0


def _rs():
    from zerochain_tpu_torch.mirror.field import R

    return [((0xA5A5 + 977 * i) * 0x9E3779B97F4A7C15 % R,
             (0x5A5A + 613 * i) * 0xC2B2AE3D27D4EB4F % R) for i in range(32)]


def path_times(prover, assignments, emit, path):
    """One MSM path of the imported checkout, "hs" (``msm_impl="hs"``) or
    "split" (``msm_tail="split"``), on the prover's CRS: one warm batch,
    then three timed ones with their stage times, launches by kernel,
    torch.roll's calls and the proofs' equality with ``prove``'s."""
    import time

    import torch

    from zerochain_tpu_torch.ec import cuda_ec
    from zerochain_tpu_torch.msm import cuda_scan
    from zerochain_tpu_torch.prover import ConfidentialProver

    rs = _rs()
    ref = [(p.a, p.b, p.c) for p in prover.prove(assignments, rs=rs)]
    opts = {"hs": dict(msm_impl="hs"), "split": dict(msm_tail="split")}[path]
    other = ConfidentialProver(None, _device_queries=prover._raw_queries,
                               _vk=prover.vk, **opts)
    other.sync_stages = True
    other.prove(assignments, rs=rs)
    real_roll = torch.roll
    for _ in range(3):
        cuda_ec.reset_launches()
        cuda_scan.reset_launches()
        rolls = [0]

        def counted_roll(*a, **kw):
            rolls[0] += 1
            return real_roll(*a, **kw)

        torch.cuda.synchronize()
        torch.roll = counted_roll
        try:
            t0 = time.perf_counter()
            out = other.prove(assignments, rs=rs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            torch.roll = real_roll
        launches = {k: v for m in (cuda_ec, cuda_scan)
                    for k, v in m.launches.items() if v}
        emit(kernel=f"prove_{path}", seconds=secs, stages=other.last_timings,
             launches=launches, torch_roll_calls=rolls[0],
             same_proofs=[(p.a, p.b, p.c) for p in out] == ref)


def quotient_times(prover, assignments, emit):
    """The quotient stage of the imported checkout on the batch: the
    matvec, the padding and ``ntt.quotient`` (CUDA events, three times),
    the quotient's launches and output digest; then each transform alone."""
    import hashlib

    import torch

    import chip_smoke
    from zerochain_tpu_torch.ff import cuda_ff
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.ntt import ntt as tntt

    inputs_host, witness_fn = prover._witness_fns()
    aux, public = witness_fn(**inputs_host(assignments, prover.device))
    witness = torch.cat([public, aux], dim=1)
    B, d, plan = witness.shape[-1], prover.d, prover.plan
    zeros = torch.zeros((8, d - prover.m, B), dtype=torch.int32, device="cuda")
    counts = getattr(tntt, "launches", None)  # None: a checkout before the NTT kernels

    def pad(evals):
        return [torch.cat([v, zeros], dim=1).movedim(1, -1) for v in evals]

    tntt.quotient(plan, *pad(prover.matrices.eval(witness)))  # warm
    for _ in range(3):
        evals, matvec_ms = chip_smoke.timed(lambda: prover.matrices.eval(witness))
        padded, pad_ms = chip_smoke.timed(lambda: pad(evals))
        cuda_ff.reset_launches()
        if counts is not None:
            tntt.reset_launches()
        h, ms = chip_smoke.timed(lambda: tntt.quotient(plan, *padded))
        k1 = {k: v for k, v in cuda_ff.launches.items() if v}
        n_ntt = None if counts is None else dict(counts)
        _, stage_ms = chip_smoke.timed(lambda: prover._quotient(aux, public))
        emit(kernel="quotient", shape=[8, B, d], matvec_ms=matvec_ms,
             pad_ms=pad_ms, quotient_ms=ms, stage_ms=stage_ms,
             k1_launches=k1, ntt_launches=n_ntt,
             h_sha256=hashlib.sha256(h.cpu().numpy().tobytes()).hexdigest())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    x = chip_smoke.random_elements(L.FR, (B, d), gen)
    for name in ("ntt", "intt", "coset_ntt", "icoset_ntt", "divide_by_z_on_coset"):
        fn = getattr(plan, name)
        emit(kernel=f"ntt.{name}", shape=[8, B, d],
             ms=chip_smoke.time_ms(lambda: fn(x), 5))


def backend_times(prover, assignments, emit):
    """generate_parameters and one create_proof through TorchBackend."""
    import time

    import torch

    import chip_smoke
    from zerochain_tpu_torch.groth16.core import create_proof, generate_parameters
    from zerochain_tpu_torch.prover import ConfidentialProver, TorchBackend

    rs = _rs()
    ref = prover.prove(assignments[:1], rs=rs[:1])[0]
    backend = TorchBackend()
    t0 = time.perf_counter()
    params = generate_parameters(ConfidentialProver.CIRCUIT(),
                                 **chip_smoke.TOXIC, backend=backend)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    spent = {}
    for name in ("msm_g1", "msm_g2", "compute_h"):
        fn = getattr(backend, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            t1 = time.perf_counter()
            res = _fn(*a, **kw)
            torch.cuda.synchronize()
            spent[_name] = spent.get(_name, 0.0) + time.perf_counter() - t1
            return res

        setattr(backend, name, wrapped)
    t0 = time.perf_counter()
    proof = create_proof(prover.circuit_for(assignments[0]), params, *rs[0],
                         backend=backend)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    emit(kernel="backend", generate_parameters_seconds=gen_s,
         create_proof_seconds=secs, backend_seconds=spent,
         host_seconds=secs - sum(spent.values()),
         same_proof=(proof.a, proof.b, proof.c) == (ref.a, ref.b, ref.c))


if __name__ == "__main__":
    sys.exit(main())
