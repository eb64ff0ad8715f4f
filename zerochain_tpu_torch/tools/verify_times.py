"""Time the verifier's side of one checkout of the port: the pairing and
batch RedJubjub verification.

    python3 zerochain_tpu_torch/tools/verify_times.py [--root DIR] [--tag T]
        [--reps N] [--no-reddsa]

Imports ``zerochain_tpu_torch`` and ``chip_smoke`` from DIR (default: the
checkout this file is in), so that two checkouts can be timed in one call on
one card, in turns (parent, change, change, parent), each in its own
process.  Prints the card's name and power limit, then JSON lines:

- ``pairing``: ``ec.pairing.pairing_host_batch`` on chip_smoke's
  PAIRING_BATCH pairs of generator multiples, at batch 1 and at the full
  batch: one warm call, then ``--reps`` timed ones (host clock around a
  synchronize), each with its K1 launches by op and its pairing-kernel
  launches (``ec.cuda_pairing``, where the checkout has it), the results
  checked equal across the calls and, once, against the mirror;
- ``reddsa`` (unless --no-reddsa): ``protocol.redjubjub_device.batch_verify_device``
  on chip_smoke's block of REDDSA_BLOCK signatures, one warm call, then
  ``--reps`` timed ones, seconds split host / device.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-reddsa", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("verify_times: no CUDA device", file=sys.stderr)
        return 2
    import importlib

    import chip_smoke
    from zerochain_tpu_torch import _build
    from zerochain_tpu_torch.ec import pairing as DP
    from zerochain_tpu_torch.ff import cuda_ff
    from zerochain_tpu_torch.mirror import curves as C
    from zerochain_tpu_torch.mirror import pairing as P
    from zerochain_tpu_torch.protocol import redjubjub_device as rjd

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    def emit(**kw):
        print(json.dumps({"tag": args.tag, **kw}), flush=True)

    try:  # a checkout from before the pairing kernels has no such module
        pp = importlib.import_module("zerochain_tpu_torch.ec.cuda_pairing")
    except ModuleNotFoundError:
        pp = None
    _build.build_all()
    n = chip_smoke.PAIRING_BATCH
    ps = [C.g1_mul(C.G1_GEN, 3 + 7 * i) for i in range(n)]
    qs = [C.g2_mul(C.G2_GEN, 5 + 11 * i) for i in range(n)]
    for b in (1, n):
        first = DP.pairing_host_batch(ps[:b], qs[:b])
        for _ in range(args.reps):
            cuda_ff.reset_launches()
            if pp:
                pp.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = DP.pairing_host_batch(ps[:b], qs[:b])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            by_op = {k: v for k, v in cuda_ff.launches.items() if v}
            emit(kernel="pairing", batch=b, seconds=secs, pairings_per_second=b / secs,
                 k1_launches=sum(by_op.values()), k1_by_op=by_op,
                 pairing_launches=dict(pp.launches) if pp else None, same=out == first)
        emit(kernel="pairing", batch=b,
             equal_to_mirror=first == [P.pairing(p, q) for p, q in zip(ps[:b], qs[:b])])

    if args.no_reddsa:
        return 0
    block, zs = chip_smoke.reddsa_block(chip_smoke.REDDSA_BLOCK)
    rjd.batch_verify_device(block, rand_scalars=zs)
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = rjd.batch_verify_device(block, rand_scalars=zs)
        secs = time.perf_counter() - t0
        emit(kernel="reddsa", block=len(block), seconds=secs, accepted=ok,
             host_seconds=rjd.last_timings["host"],
             device_seconds=rjd.last_timings["device"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
