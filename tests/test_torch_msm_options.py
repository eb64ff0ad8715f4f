"""The JAX package's last MSM options in the port: the bucket MSM's scan
mode 'assoc', the window widths (``ZEROCHAIN_MSM_C``,
``ZEROCHAIN_MSM_SUFFIX_C``, ``SuffixMsm`` at c = 4, 6, 10), the prover's
``ZEROCHAIN_MSM_CHUNK_G2`` and ``ZEROCHAIN_MSM_SCAN_G1`` / ``_G2``, the MSM
kernels' window limits, and ``ec.jubjub.normalize_many``.

Points are compared after ``normalize`` (exact, tolerance 0): 'assoc' and
'hs' add in different orders.  The JAX ``Msm(mode="assoc")`` instantiates
its add at every width of ``associative_scan``'s recursion, and XLA takes
minutes a width on a CPU, so the comparison with it runs only with
``ZEROCHAIN_ASSOC_JAX=1``; 'hs' against the JAX ``Msm`` is
test_torch_bucket_msm_jax.py's."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zerochain_tpu_torch.ec import cuda_ec, g1, g2
from zerochain_tpu_torch.ec import jubjub as jj
from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
from zerochain_tpu_torch.ff import limbs as L
from zerochain_tpu_torch.mirror import curves as cv
from zerochain_tpu_torch.mirror import jubjub as mjj
from zerochain_tpu_torch.msm import cuda_scan
from zerochain_tpu_torch.msm import pippenger as pip
from zerochain_tpu_torch.msm.suffix import SuffixMsm

torch.set_num_threads(2)  # several test workers share the cores

GROUPS = {"g1": (FqOps, g1, cv.G1_GEN, cv.g1_mul, cv.g1_add),
          "g2": (Fq2Ops, g2, cv.G2_GEN, cv.g2_mul, cv.g2_add)}


def _case(group, n, n_bits, B=2, seed=0):
    """n points (one at infinity), B rows of n_bits-bit scalars (one zero)
    and the mirror's sums."""
    F, grp, gen, mul, add = GROUPS[group]
    rng = np.random.RandomState(seed)
    pts = [mul(gen, 3 + 7 * i) for i in range(n)]
    pts[5] = None
    scal = [[int(rng.randint(0, 1 << min(n_bits, 31))) for _ in range(n)]
            for _ in range(B)]
    scal[0][3] = 0
    want = []
    for s in scal:
        acc = None
        for p, k in zip(pts, s):
            if p is not None:
                acc = add(acc, mul(p, k))
        want.append(acc)
    return F, grp, pts, scal, want


def _bits(scal, n_bits):
    return torch.stack([pip.scalars_to_bits(s, n_bits) for s in scal], -1)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_assoc_equals_hs_and_the_mirror(group, monkeypatch):
    F, grp, pts, scal, want = _case(group, 24, 16)
    P = grp.from_affine_host(pts, device="cpu")
    bits = _bits(scal, 16)
    # a small slab: the 'assoc' rows go in several passes
    monkeypatch.setattr(pip, "_ASSOC_SLAB", 24 * F.ncomp)
    assoc = pip.Msm(F, c=4, n_bits=16, mode="assoc")
    hs = pip.Msm(F, c=4, n_bits=16, mode="hs")
    got = grp.to_affine_host(assoc(P, bits))
    assert got == grp.to_affine_host(hs(P, bits)) == want


def test_scan_mode_from_the_environment(monkeypatch):
    monkeypatch.setenv("ZEROCHAIN_MSM_SCAN", "assoc")
    assert pip.Msm(FqOps).mode == "assoc"
    monkeypatch.setenv("ZEROCHAIN_MSM_SCAN", "")
    assert pip.Msm(FqOps).mode == "hs"
    monkeypatch.setenv("ZEROCHAIN_MSM_SCAN", "tree")
    with pytest.raises(ValueError, match="scan mode"):
        pip.Msm(FqOps)


def test_segmented_prefix_scan_restarts_at_each_start():
    from zerochain_tpu_torch.msm.scans import segmented_prefix_scan

    F, grp, pts, _, _ = _case("g1", 20, 8)
    starts = torch.zeros(20, dtype=torch.bool)
    starts[[0, 3, 4, 11, 19]] = True
    got = grp.to_affine_host(segmented_prefix_scan(
        F, grp.from_affine_host(pts, device="cpu"), starts))
    want, acc = [], None
    for i, p in enumerate(pts):
        acc = p if starts[i] else cv.g1_add(acc, p)
        want.append(acc)
    assert got == want


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_assoc_equals_the_jax_assoc_msm(group):
    if not os.environ.get("ZEROCHAIN_ASSOC_JAX"):
        pytest.skip("set ZEROCHAIN_ASSOC_JAX=1 to compile the JAX 'assoc' Msm "
                    "(many minutes a group on a CPU)")
    import jax.numpy as jnp

    from zerochain_tpu.ec import g1 as jg1
    from zerochain_tpu.ec import g2 as jg2
    from zerochain_tpu.ec.fields import FqOps as JFq, Fq2Ops as JFq2
    from zerochain_tpu.msm import pippenger as jpip

    F, grp, pts, scal, want = _case(group, 8, 8)
    got = grp.to_affine_host(pip.Msm(F, c=4, n_bits=8, mode="assoc")(
        grp.from_affine_host(pts, device="cpu"), _bits(scal, 8)))
    jg, JF = (jg1, JFq) if group == "g1" else (jg2, JFq2)
    jbits = jnp.stack([jpip.scalars_to_bits(s, 8) for s in scal], -1)
    jout = jpip.Msm(JF, c=4, n_bits=8, mode="assoc")(jg.from_affine_host(pts), jbits)
    assert got == jg.to_affine_host(jout) == want


@pytest.mark.parametrize("c", [4, 6, 10])
def test_suffix_msm_widths(c):
    """SuffixMsm at c = 4, 6, 10, signed (the prover's) and unsigned, the
    'totals' tail (window_totals' plain version), against the mirror."""
    F, grp, pts, scal, want = _case("g1", 32, 40, seed=c)
    P = grp.from_affine_host(pts, device="cpu")
    words = torch.from_numpy(np.stack([L.ints_to_words_np(s, L.FR.n)
                                       for s in scal], -1))
    for signed in (True, False):
        m = SuffixMsm(FqOps, c=c, n_bits=40, signed=signed)
        assert m.nb == ((1 << (c - 1)) + 1 if signed else 1 << c)
        assert grp.to_affine_host(m(P, m.digits(words))) == want


@pytest.mark.parametrize("c", [4, 10])
def test_suffix_msm_split_tail_widths(c):
    """The split tail (split_lanes / split_tail's plain versions) at c = 4
    and 10 on a chunk of 1,024 points."""
    F, grp, pts, scal, want = _case("g1", 1024, 20, B=1, seed=c)
    m = SuffixMsm(FqOps, c=c, n_bits=20, signed=True, tail="split")
    assert m.column_split(1024)
    words = torch.from_numpy(np.stack([L.ints_to_words_np(s, L.FR.n)
                                       for s in scal], -1))
    got = grp.to_affine_host(m(grp.from_affine_host(pts, device="cpu"),
                               m.digits(words)))
    assert got == want


def test_kernel_window_limits():
    """Each MSM kernel's wrapper takes the window width or names its limit
    in a ValueError (before it would launch)."""
    F, grp, pts, _, _ = _case("g1", 8, 8)
    P = grp.from_affine_host(pts, device="cpu")
    rows = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="2 <= nb <= 2\\^30"):
        cuda_scan.window_totals(F, P, rows, rows, (1 << 30) + 1)
    with pytest.raises(ValueError, match="1 <= nb <= 2\\^30"):
        cuda_ec.bucket_sums(F, P, rows, rows, 0)
    with pytest.raises(ValueError, match="c >= 0"):
        cuda_ec.horner(F, pip.tmap(lambda t: t.reshape(12, 2, 4), P), -1)
    big = SuffixMsm(FqOps, c=11, signed=True, tail="split")  # nb = 1025
    rows = torch.zeros((1, 1024), dtype=torch.int32)
    P = pip.tmap(lambda t: t.repeat(1, 128), P)
    with pytest.raises(ValueError, match="nb <= 1024"):
        cuda_scan.split_lanes(F, P, rows, rows, big.nb)
    with pytest.raises(ValueError, match="1 to 30 bits"):
        pip.Msm(FqOps, c=31)


def test_window_width_from_the_environment():
    """ZEROCHAIN_MSM_C sets pippenger.WINDOW_C, the default of Msm,
    FixedBaseMsm and SuffixMsm, as it sets the JAX package's."""
    code = ("from zerochain_tpu_torch.msm import pippenger as p, suffix as s\n"
            "from zerochain_tpu.msm import pippenger as jp\n"
            "from zerochain_tpu_torch.ec.fields import FqOps\n"
            "print(p.WINDOW_C, jp.WINDOW_C, p.Msm(FqOps).c, "
            "s.SuffixMsm(FqOps).c)\n")
    env = dict(os.environ, ZEROCHAIN_MSM_C="6", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["6", "6", "6", "6"]


def _fake_prep(self, pts, cols, n, chunk):
    """A stand-in for the provers' _prep: the padded size, no normalisation
    (the option under test only sizes the chunks)."""
    n = len(cols) if cols is not None else n
    return pts, -(-n // chunk) * chunk


@pytest.mark.parametrize("cap", [None, "4096", "1024"])
def test_chunk_g2_and_the_other_prover_options(cap, monkeypatch):
    """ZEROCHAIN_MSM_CHUNK_G2 caps the chunk B1 and B2 share
    (``msm_chunk_b``) as it caps the JAX prover's; ZEROCHAIN_MSM_SUFFIX_C
    and ZEROCHAIN_MSM_SCAN_G1 / _G2 reach the provers' MSMs.  The provers
    are built with a stand-in for their normalisation of the CRS."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from zerochain_tpu.prover_tpu import pipeline as jpl
    from zerochain_tpu_torch.prover import pipeline as tpl

    if cap is None:
        monkeypatch.delenv("ZEROCHAIN_MSM_CHUNK_G2", raising=False)
    else:
        monkeypatch.setenv("ZEROCHAIN_MSM_CHUNK_G2", cap)
    monkeypatch.delenv("ZEROCHAIN_MSM_CHUNK", raising=False)
    monkeypatch.setattr(tpl.ConfidentialProver, "_prep", _fake_prep)
    monkeypatch.setattr(jpl.ConfidentialProver, "_prep", _fake_prep)

    z = np.zeros((12, 1), np.int32)
    port_q = tuple(tuple(torch.from_numpy(z) for _ in range(3)) for _ in range(4)) + (
        tuple((torch.from_numpy(z), torch.from_numpy(z)) for _ in range(3)),)
    jz = jnp.zeros((32, 1), jnp.int32)
    jax_q = tuple((jz, jz, jz) for _ in range(4)) + (((jz, jz),) * 3,)
    vk = SimpleNamespace(alpha_g1=cv.G1_GEN, beta_g1=cv.G1_GEN,
                         delta_g1=cv.G1_GEN, beta_g2=cv.G2_GEN,
                         delta_g2=cv.G2_GEN)

    monkeypatch.setenv("ZEROCHAIN_MSM_SUFFIX_C", "6")
    port = tpl.ConfidentialProver(None, _device_queries=port_q, _vk=vk,
                                  device="cpu")
    ref = jpl.ConfidentialProver(None, _device_queries=jax_q, _vk=vk)
    assert port.msm_chunk_b == ref.msm_chunk_b
    assert port.msm_chunk_b == min(int(cap or 16384), 16384)
    assert (port.msm_chunk_a, port.msm_chunk_l, port.msm_chunk_h) == (
        ref.msm_chunk_a, ref.msm_chunk_l, ref.msm_chunk_h)
    assert port.msm_g1.c == port.msm_g2.c == ref.msm_g1.c == 6

    monkeypatch.setenv("ZEROCHAIN_MSM_IMPL", "hs")
    monkeypatch.setenv("ZEROCHAIN_MSM_SCAN_G1", "assoc")
    monkeypatch.setenv("ZEROCHAIN_MSM_SCAN_G2", "hs")
    port = tpl.ConfidentialProver(None, _device_queries=port_q, _vk=vk,
                                  device="cpu")
    ref = jpl.ConfidentialProver(None, _device_queries=jax_q, _vk=vk)
    assert (port.msm_g1.mode, port.msm_g2.mode) == (ref.msm_g1.mode,
                                                    ref.msm_g2.mode) == (
        "assoc", "hs")
    assert port.msm_g1.c == ref.msm_g1.c == pip.WINDOW_C


def test_normalize_many_matches_the_jax_one():
    """One inversion over all the Zs, two multiplies a point: the affine
    coordinates of the JAX normalize_many and of the mirror."""
    from zerochain_tpu.ec import jubjub as jjj
    from zerochain_tpu.ff import limbs as JL
    from zerochain_tpu_torch.convert import to_ref_limbs

    gen = mjj.find_group_hash(b"\x02\x00\x00\x00", b"zcgepoch")
    base = [mjj.mul(gen, 5 + 11 * i) for i in range(6)]
    ext = jj.to_extended(base, device="cpu")
    batches = [jj.double(ext), jj.add(jj.double(ext), ext), ext]
    got = jj.normalize_many(batches)
    ref = jjj.normalize_many([tuple(to_ref_limbs(L.FR, t, mont=True) for t in p)
                              for p in batches])
    for k, ((x, y), (jx, jy)) in enumerate(zip(got, ref)):
        xs, ys = L.FR.to_ints(x, mont=True), L.FR.to_ints(y, mont=True)
        assert xs == JL.from_limbs(JL.FR, jx, mont=True)
        assert ys == JL.from_limbs(JL.FR, jy, mont=True)
        want = [mjj.mul(p, 2 if k == 0 else 3 if k == 1 else 1) for p in base]
        assert list(zip(xs, ys)) == want
