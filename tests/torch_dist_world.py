"""A gloo world of four CPU processes for the ``dist/`` tests of the port.

``run_world(job, tmp_dir)`` spawns the ranks (``torch.multiprocessing``,
a file store under tmp_dir, never a TCP port: several test workers run at
once), runs the job of that name in each (``torch.set_num_threads(1)``) and
returns every rank's result dict, which each rank hands back through a file;
``start_world`` / ``finish_world`` let the test process work meanwhile.
The jobs import only the port; the tests compare what they return with the
JAX package in the test process.  Inputs come from numpy seeds (the
``*_inputs`` functions), so the ranks and the test process build the same.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
JOIN_SECONDS = 600


# ---------------------------------------------------------------------
# inputs (numpy seeds)
# ---------------------------------------------------------------------
def fr_values(seed: int, count: int) -> list[int]:
    from zerochain_tpu_torch.mirror.field import R

    rng = np.random.RandomState(seed)
    return [int.from_bytes(rng.bytes(31), "little") % R for _ in range(count)]


def msm_g1_inputs():
    """32 G1 points (doublings of the generator), 32-bit scalars."""
    from zerochain_tpu_torch.mirror import curves as cv
    from zerochain_tpu_torch.mirror.field import R

    pts, cur = [], cv.G1_GEN
    for _ in range(32):
        pts.append(cur)
        cur = cv.g1_double(cur)
    return pts, [(3 + 7 * i) % R for i in range(32)]


def suffix_inputs():
    """16 G1 points, one at infinity; B = 2 rows of 30-bit scalars."""
    from zerochain_tpu_torch.mirror import curves as cv

    rng = np.random.RandomState(3)
    pts = [cv.g1_mul(cv.G1_GEN, 3 + 5 * i) for i in range(16)]
    pts[4] = None
    scal = [[int(rng.randint(0, 1 << 30)) for _ in range(16)] for _ in range(2)]
    return pts, scal


def msm_g2_inputs():
    """16 G2 points (doublings of the generator); B = 2 rows of 16-bit
    scalars."""
    from zerochain_tpu_torch.mirror import curves as cv

    pts, cur = [], cv.G2_GEN
    for _ in range(16):
        pts.append(cur)
        cur = cv.g2_double(cur)
    scal = [[(5 + 3 * i + b) % (1 << 16) for i in range(16)] for b in range(2)]
    return pts, scal


def suffix_msm():
    from zerochain_tpu_torch.ec.fields import FqOps
    from zerochain_tpu_torch.msm.suffix import SuffixMsm

    return SuffixMsm(FqOps, c=4, n_bits=31, signed=True)


def suffix_digits(msm, scal):
    from zerochain_tpu_torch.ff import limbs as L

    words = np.stack([L.ints_to_words_np(s, L.FR.n) for s in scal], -1)
    return msm.digits(torch.from_numpy(words))


NTT_D1 = NTT_D2 = 16


MINI_TOXIC = dict(tau=515151, alpha=117, beta=223, gamma=331, delta=447)


MINI_ASSIGNMENTS = [dict(amount=77), dict(amount=3)]
MINI_RS = [(21, 23), (25, 27)]


# ---------------------------------------------------------------------
# jobs: run in every rank, return a dict of tensors / plain values
# ---------------------------------------------------------------------
def job_ntt_msm(tmp_dir):
    """The DistNtt family and quotient at d1 = d2 = 16, with the twiddle
    rows built on the host and (HOST_TWIDDLES below d) on the device,
    distributed_ntt, sharded_msm_g1 and sharded_suffix.  Key "twiddles":
    this rank's rows, which differ between the ranks."""
    from zerochain_tpu_torch.dist import (DistNtt, distributed_ntt,
                                          sharded_msm_g1, sharded_suffix)
    from zerochain_tpu_torch.dist import ntt as dntt
    from zerochain_tpu_torch.ec import g1
    from zerochain_tpu_torch.ff import limbs as L
    from zerochain_tpu_torch.msm import pippenger as pip

    d = NTT_D1 * NTT_D2
    x = L.FR.array(fr_values(5, d), "cpu", mont=True)
    a, b, c = (L.FR.array(fr_values(6 + k, 2 * d), "cpu", mont=True)
               .reshape(L.FR.n, 2, d) for k in range(3))
    dn = DistNtt(NTT_D1, NTT_D2, device="cpu")
    host_limit, dntt.HOST_TWIDDLES = dntt.HOST_TWIDDLES, d // 2
    try:
        dd = DistNtt(NTT_D1, NTT_D2, device="cpu")
    finally:
        dntt.HOST_TWIDDLES = host_limit
    out = {"twiddles": {"rows": (dn.rows.start, dn.rows.stop),
                        "host": (dn.tw_f, dn.tw_i),
                        "device": (dd.tw_f, dd.tw_i)}}
    for tag, plan in (("", dn), ("device_twiddles.", dd)):
        for name in ("ntt", "intt", "coset_ntt", "icoset_ntt"):
            out[tag + name] = getattr(plan, name)(x)
        out[tag + "quotient"] = plan.quotient(a, b, c)
    out["distributed_ntt"] = distributed_ntt(
        L.FR.array(fr_values(7, d), "cpu", mont=True), NTT_D1, NTT_D2)

    pts, scal = msm_g1_inputs()
    out["msm_g1"] = sharded_msm_g1(g1.from_affine_host(pts, device="cpu"),
                                   pip.scalars_to_bits(scal, 32),
                                   use_pippenger=False)
    pts, scal = suffix_inputs()
    msm = suffix_msm()
    out["suffix"] = sharded_suffix(msm, g1.from_affine_host(pts, device="cpu"),
                                   suffix_digits(msm, scal))
    return out


def job_msm_g2(tmp_dir):
    """sharded_msm over G2 with a batch axis, the bucket MSM on each rank."""
    from zerochain_tpu_torch.dist import sharded_msm
    from zerochain_tpu_torch.ec import g2
    from zerochain_tpu_torch.ec.fields import Fq2Ops
    from zerochain_tpu_torch.msm import pippenger as pip

    pts, scal = msm_g2_inputs()
    bits = torch.stack([pip.scalars_to_bits(s, 16) for s in scal], -1)
    return {"msm_g2": sharded_msm(Fq2Ops, g2.from_affine_host(pts, device="cpu"),
                                  bits, use_pippenger=True)}


def _prove_dist(tmp_dir, impl):
    """MiniProver under ZEROCHAIN_DIST=1 on one MSM path, on the CRS the
    test process saved (``mini_crs.npz``): the proofs, the collectives and
    the stage times of one prove."""
    from zerochain_tpu_torch.dist import comm
    from zerochain_tpu_torch.prover import MiniProver

    os.environ["ZEROCHAIN_DIST"] = "1"
    p = MiniProver.from_cache(str(pathlib.Path(tmp_dir) / "mini_crs.npz"),
                              device="cpu")
    if impl != p.msm_impl:
        p = MiniProver(None, _device_queries=p._raw_queries, _vk=p.vk,
                       device="cpu", msm_impl=impl)
    assert p.dist and p.world_size == WORLD
    comm.reset_stats()
    proofs = p.prove(MINI_ASSIGNMENTS, rs=MINI_RS)
    return {"proofs": [(pr.a, pr.b, pr.c) for pr in proofs],
            "collectives": dict(comm.stats), "timings": dict(p.last_timings)}


def job_prover_suffix(tmp_dir):
    return _prove_dist(tmp_dir, "suffix")


def job_prover_hs(tmp_dir):
    return _prove_dist(tmp_dir, "hs")


JOBS = {"ntt_msm": job_ntt_msm, "msm_g2": job_msm_g2,
        "prover_suffix": job_prover_suffix, "prover_hs": job_prover_hs}


# ---------------------------------------------------------------------
def _rank_main(rank: int, job: str, tmp_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_dir}/store",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=JOIN_SECONDS))
    try:
        out = JOBS[job](tmp_dir)
    finally:
        dist.destroy_process_group()
    torch.save(out, pathlib.Path(tmp_dir) / f"rank{rank}.pt")


def start_world(job: str, tmp_dir):
    """Start ``job`` in a gloo world of WORLD processes; the caller may work
    while the ranks run -> a handle for ``finish_world``."""
    tmp_dir = str(tmp_dir)
    ctx = mp.start_processes(_rank_main, args=(job, tmp_dir), nprocs=WORLD,
                             join=False, start_method="spawn")
    return job, tmp_dir, ctx, time.time() + JOIN_SECONDS


def finish_world(handle) -> list[dict]:
    """Wait for the ranks (at most JOIN_SECONDS from their start; a rank's
    error is raised here) -> each rank's result dict."""
    job, tmp_dir, ctx, deadline = handle
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise TimeoutError(f"the {job} world did not end in "
                                   f"{JOIN_SECONDS} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    return [torch.load(pathlib.Path(tmp_dir) / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def run_world(job: str, tmp_dir) -> list[dict]:
    """Run ``job`` in a gloo world of WORLD processes -> each rank's dict."""
    return finish_world(start_world(job, tmp_dir))
