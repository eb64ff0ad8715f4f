"""What a stage of the pairing kernel costs on the card (csrc/pairing_kernel.cu).

    python3 zerochain_tpu_torch/tools/pairing_stages.py [--reps N]

The pairing kernel walks host-built programs stage by stage, a warp a
pairing (ec/cuda_pairing.py), so its time is its stages' latency.  This
times, with CUDA events over ``--reps`` launches after a warm one:

- ``stage``: synthetic sets of 20 x 100 stages, each stage ``width``
  independent moves, adds or multiplies (a move: an operation's fixed cost
  without arithmetic; 54 multiplies: two rounds of the warp's 32 lanes), at
  batch 1 and 32: microseconds a stage;
- ``set``: the two sets of a pairing call (``miller_set("pairing")``,
  ``final_exp_set()``) at batch 1 and 32 on generator multiples, with their
  stage counts (all, multiply stages), multiplies and cheap operations a
  pairing.

Prints the card's name and power limit, then JSON lines.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

STEPS, REPEATS = 100, 20


def _synthetic(cp, kind, width):
    """A set whose main program is STEPS stages of ``width`` independent
    ``kind`` operations on the pinned slots, run REPEATS times."""
    load = cp.Program("load")
    for j in range(width + 1):
        load.out(load.load(j), j)
    p = cp.Program(kind)
    b = p.pin(width)
    xs = [p.pin(j) for j in range(width)]
    for _ in range(STEPS):
        if kind == "mov":
            xs = [p.mov(x) for x in xs]
        elif kind == "add":
            xs = [p.add(x, b) for x in xs]
        else:
            xs = [p.mul(x, b) for x in xs]
    for j, x in enumerate(xs):
        p.out(x, j)
    store = cp.Program("store")
    store.store(store.pin(0), 0)
    return cp.build_set("miller", [load, p, store], [(0, 0)] + [(1, 0)] * REPEATS + [(2, 0)],
                        width + 1, width + 1, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

    import torch

    if not torch.cuda.is_available():
        print("pairing_stages: no CUDA device", file=sys.stderr)
        return 2
    from zerochain_tpu_torch.ec import cuda_pairing as cp
    from zerochain_tpu_torch.ec import pairing as dp
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.mirror import curves as C

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    def ms(pset, x):
        cp.execute(pset, x)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            cp.execute(pset, x)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / args.reps

    for b in (1, 32):
        for kind, width in (("mov", 1), ("add", 1), ("add", 32), ("mul", 1), ("mul", 32),
                            ("mul", 54)):
            pset = _synthetic(cp, kind, width)
            x = L.FQ.array(list(range(3, 3 + (width + 1) * b)), "cuda",
                           mont=True).reshape(L.FQ.n, width + 1, b)
            t = ms(pset, x)
            print(json.dumps({"kind": "stage", "op": kind, "width": width, "batch": b,
                              "us_per_stage": t * 1e3 / (STEPS * REPEATS)}), flush=True)
    n = 32
    ps = [C.g1_mul(C.G1_GEN, 3 + 7 * i) for i in range(n)]
    qs = [C.g2_mul(C.G2_GEN, 5 + 11 * i) for i in range(n)]
    for b in (1, n):
        (px, py), (qx, qy) = dp.g1_tensors(ps[:b], "cuda"), dp.g2_tensors(qs[:b], "cuda")
        ins = dp._rows([px, py, qx[:, 0], qx[:, 1], qy[:, 0], qy[:, 1]], 1, (b,))
        f = cp.execute(cp.miller_set("pairing"), ins)
        for name, pset, x in (("miller", cp.miller_set("pairing"), ins),
                              ("final_exp", cp.final_exp_set(), f)):
            print(json.dumps({"kind": "set", "set": name, "batch": b, "ms": ms(pset, x),
                              **pset.counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
