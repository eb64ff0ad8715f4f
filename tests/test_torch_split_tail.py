"""The split tail of the port's suffix MSM (msm/suffix.py:
``SuffixMsm(tail="split")``) and the plain version of its depth-scan kernel
(msm/cuda_scan.py: ``column_scan``), against the JAX package and the mirror.

- ``phys_perm`` / ``logical_to_phys``: equal to the JAX functions.
- ``column_scan`` (its plain version, on the CPU) at T = 2 and T = 4, with
  padding points (Z = 0), a doubling and opposite points in a lane: every
  physical (t, lane) equals the mirror's prefix sum of that lane, exactly.
  (The JAX kernel itself runs here only in interpret mode, which takes over
  20 minutes, so the mirror is the oracle.)
- ``SuffixMsm(tail="split")`` window partials at N = 2048 (the column
  layout, T = 2) and N = 256 (the plain prefix scan) against the port's
  ``tail="totals"``, and at N = 256 the whole MSM against the mirror, after
  ``normalize`` (exact).  The JAX ``SuffixMsm`` is held against the split
  tail in test_torch_split_tail_jax.py (its XLA compiles take over a minute).
- ``MiniProver(msm_tail="split")``: the bigint prover's proof."""

import numpy as np
import pytest
import torch

from zerochain_tpu_torch.ec import g1 as tg1
from zerochain_tpu_torch.ec import g2 as tg2
from zerochain_tpu_torch.ec import weierstrass as W
from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.mirror import curves as cv
from zerochain_tpu_torch.msm import cuda_scan
from zerochain_tpu_torch.msm.suffix import SuffixMsm

torch.set_num_threads(2)  # several test workers share the cores

GROUPS = {
    "g1": (tg1, FqOps, cv.G1_GEN, cv.g1_mul, cv.g1_add, cv.g1_neg),
    "g2": (tg2, Fq2Ops, cv.G2_GEN, cv.g2_mul, cv.g2_add, cv.g2_neg),
}
VL = cuda_scan.VL


@pytest.mark.parametrize("n", [1024, 2048, 16384])
def test_phys_perm_matches_jax(n):
    import jax.numpy as jnp

    from zerochain_tpu.msm import pallas_scan as PS

    perm = cuda_scan.phys_perm(n)
    assert np.array_equal(perm.numpy(), np.asarray(PS.phys_perm(n)))
    i = np.arange(n)
    assert np.array_equal(cuda_scan.logical_to_phys(torch.from_numpy(i), n).numpy(),
                          np.asarray(PS.logical_to_phys(jnp.asarray(i), n)))
    # the two are inverse permutations
    assert torch.equal(cuda_scan.logical_to_phys(perm, n), torch.arange(n))


@pytest.mark.parametrize("t_depth", [2, 4])
@pytest.mark.parametrize("name", sorted(GROUPS))
def test_column_scan_plain_matches_the_mirror(name, t_depth):
    tg, F, gen, mul, add, neg = GROUPS[name]
    rng = np.random.RandomState(3 + t_depth)
    base = [mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(8)]
    n = t_depth * VL
    lanes = (0, 1, 2, 3, 500, 1023)
    # physical (t, vl) -> point; only the checked lanes vary, the rest
    # repeat one point (their prefixes are not read)
    phys = [base[0]] * n
    for vl in lanes:
        for t in range(t_depth):
            phys[t * VL + vl] = base[int(rng.randint(0, 8))]
    phys[0 * VL + 1] = None                 # padding at the head of a lane
    phys[1 * VL + 2] = phys[0 * VL + 2]     # P + P: a doubling
    phys[1 * VL + 3] = neg(phys[0 * VL + 3])  # P + (-P): the identity
    phys[(t_depth - 1) * VL + 500] = None   # padding at the tail
    pts = tg.from_affine_host(phys, device="cpu")
    two = tuple(tuple(torch.stack([x, x], 1) for x in c) if isinstance(c, tuple)
                else torch.stack([c, c], 1) for c in pts)   # lead axis M = 2
    out = cuda_scan.column_scan(F, two)
    aff = tg.to_affine_host(out)
    for m in range(2):
        for vl in lanes:
            acc = None
            for t in range(t_depth):
                j = t * VL + vl
                acc = add(acc, phys[j])
                assert aff[m * n + j] == acc, (m, vl, t)


@pytest.fixture(scope="module", params=sorted(GROUPS))
def group(request):
    return request.param


def split_case(group, n, n_bits=16, B=2):
    """Points with padding, P = Q and P = -Q; scalars of n_bits with equal
    digits on those points and a zero-heavy row; the port's SuffixMsm with
    each tail and its prep."""
    tg, F, gen, mul, add, neg = GROUPS[group]
    rng = np.random.RandomState(29)
    base = [mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(16)]
    pts = [base[int(rng.randint(0, 16))] for _ in range(n)]
    pts[3] = None
    pts[n - 1] = None
    pts[10] = pts[11]
    pts[20] = neg(pts[21])
    scal = [[int(rng.randint(0, 1 << n_bits)) for _ in range(n)]
            for _ in range(B)]
    scal[0][10] = scal[0][11] = 0x45
    scal[0][20] = scal[0][21] = 0x78  # < 2^8: the same digit in every case
    scal[-1][n // 2 + 30:] = [0] * (n // 2 - 30)   # zero-heavy, as a witness is
    words = torch.stack([TL.FR.array(s, "cpu") for s in scal], dim=-1)
    split = SuffixMsm(F, c=8, n_bits=n_bits, signed=True, tail="split")
    totals = SuffixMsm(F, c=8, n_bits=n_bits, signed=True, tail="totals")
    prep = split.prep(split.digits(words))
    return dict(tg=tg, add=add, mul=mul, pts=pts, scal=scal,
                tp=tg.from_affine_host(pts, device="cpu"), split=split,
                totals=totals, prep=prep)


@pytest.mark.parametrize("n", [2048, 256])
def test_split_tail_matches_the_totals_tail(group, n):
    c = split_case(group, n, B=1 if n == 2048 else 2)
    assert c["split"].column_split(n) == (n >= VL)
    got = c["split"].window_partials(c["tp"], prep=c["prep"])
    want = c["totals"].window_partials(c["tp"], prep=c["prep"])
    assert c["tg"].to_affine_host(got) == c["tg"].to_affine_host(want)
    if n == 256:  # the whole MSM, against the mirror
        res = c["tg"].to_affine_host(c["split"].combine(got))
        for b, row in enumerate(c["scal"]):
            acc = None
            for p, k in zip(c["pts"], row):
                if p is not None and k:
                    acc = c["add"](acc, c["mul"](p, k))
            assert res[b] == acc


def test_mini_prover_split_tail_gives_the_same_proofs(monkeypatch):
    """MiniProver(msm_tail="split") on the fixture circuit returns the proof
    of the bigint prover groth16.core.create_proof, which is the default
    MiniProver's proof (tests/test_torch_pipeline.py holds the two equal).
    Its 256-point chunks take the plain prefix scan, not column_scan."""
    from zerochain_tpu_torch.groth16.core import (
        create_proof, generate_parameters, prepare_verifying_key, verify_proof)
    from zerochain_tpu_torch.mirror.field import R
    from zerochain_tpu_torch.models.mini import MiniCommit
    from zerochain_tpu_torch.prover import MiniProver

    monkeypatch.setenv("ZEROCHAIN_MSM_CHUNK", "256")
    params = generate_parameters(MiniCommit(), 424242, 111, 222, 333, 444)
    r, s = R - 5, 0xDEADBEEF
    want = create_proof(MiniCommit(amount=0xFFFF0001), params, r, s)
    prover = MiniProver(params, device="cpu", msm_tail="split")
    assert prover.msm_g1.tail == "split"
    (got,) = prover.prove([dict(amount=0xFFFF0001)], rs=[(r, s)])
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    pvk = prepare_verifying_key(prover.vk)
    assert verify_proof(pvk, got, prover.public_inputs([dict(amount=0xFFFF0001)])[0])


def test_tail_default_reads_the_env(monkeypatch):
    monkeypatch.setenv("ZEROCHAIN_MSM_TOTALS", "0")
    assert SuffixMsm(FqOps, signed=True).tail == "split"
    monkeypatch.setenv("ZEROCHAIN_MSM_TOTALS", "1")
    assert SuffixMsm(FqOps, signed=True).tail == "totals"
    monkeypatch.delenv("ZEROCHAIN_MSM_TOTALS")
    assert SuffixMsm(FqOps, signed=True).tail == "totals"
    with pytest.raises(ValueError):
        SuffixMsm(FqOps, tail="columns")


def test_column_scan_checks_its_input():
    pts = W.identity(FqOps, (2, 1000), "cpu")
    with pytest.raises(ValueError):
        cuda_scan.column_scan(FqOps, pts)
    pts = W.identity(FqOps, (2, 1024), "cpu")
    with pytest.raises(ValueError):
        cuda_scan.column_scan(FqOps, (pts[0], pts[1], pts[2].long()))
