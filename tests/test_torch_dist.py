"""The port's ``dist/`` in a gloo world of four CPU processes
(tests/torch_dist_world.py) against the JAX package's ``dist`` on a mesh of
four of the virtual CPU devices (same shard boundaries) and against the
port's single-device functions:

- ``DistNtt`` (``ntt``, ``intt``, ``coset_ntt``, ``icoset_ntt`` at d1 = d2 =
  16) and ``quotient`` at B = 2: canonical integers equal to the JAX
  ``DistNtt``'s and words equal to the port's ``NttPlan`` chain (tolerance
  0; the packages' Fr Montgomery radices differ, so the JAX side is compared
  as integers);
- the same with the twiddle rows built on the device (``HOST_TWIDDLES``
  below d): each rank's rows equal w^(j*r) for its own rows j, and the
  transforms equal ``NttPlan``'s;
- ``distributed_ntt`` against ``groth16.domain.ntt``;
- ``sharded_msm_g1`` (32 points, the naive local sum) and ``sharded_suffix``
  (G1, N = 16, B = 2, c = 4, a point at infinity) against the mirror and
  the port's single-device ``window_partials`` / ``combine``, and against
  the JAX functions: equal after ``normalize`` (the packages add in other
  orders);
- every rank holds the same words.

The ranks run while the test process evaluates the JAX transforms.  XLA
compiles the JAX sharded MSMs for about two minutes on a CPU (their own
test_dist.py), so the comparisons with them run only with
``ZEROCHAIN_DIST_JAX=1``."""

import os

import numpy as np
import pytest
import torch

import torch_dist_world as world
from zerochain_tpu_torch.ec import g1
from zerochain_tpu_torch.ec import weierstrass as W
from zerochain_tpu_torch.ec.fields import FqOps
from zerochain_tpu_torch.ff import limbs as L
from zerochain_tpu_torch.groth16 import domain as dom
from zerochain_tpu_torch.mirror import curves as cv
from zerochain_tpu_torch.msm import pippenger as pip
from zerochain_tpu_torch.ntt import plan_for

torch.set_num_threads(2)  # several test workers share the cores

D = world.NTT_D1 * world.NTT_D2
TRANSFORMS = ("ntt", "intt", "coset_ntt", "icoset_ntt")


def _mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:world.WORLD]), ("pt",))


def _jax_transforms():
    """The JAX package's DistNtt on the same inputs -> canonical ints."""
    from zerochain_tpu.dist.ntt import DistNtt
    from zerochain_tpu.ff import limbs as JL

    out = {}
    dn = DistNtt(world.NTT_D1, world.NTT_D2, _mesh(), "pt")
    x = JL.to_limbs(JL.FR, world.fr_values(5, D), mont=True)
    for name in TRANSFORMS:
        out[name] = JL.from_limbs(JL.FR, getattr(dn, name)(x), mont=True)
    a, b, c = (JL.to_limbs(JL.FR, world.fr_values(6 + k, 2 * D), mont=True)
               .reshape(JL.FR.n, 2, D) for k in range(3))
    out["quotient"] = JL.from_limbs(JL.FR, np.asarray(dn.quotient(a, b, c))
                                    .reshape(JL.FR.n, -1), mont=True)
    return out


@pytest.fixture(scope="module")
def jax_msms():
    """The JAX package's sharded MSMs on the same inputs -> affine points
    (and the suffix MSM's window partials)."""
    if not os.environ.get("ZEROCHAIN_DIST_JAX"):
        pytest.skip("set ZEROCHAIN_DIST_JAX=1 to compile the JAX sharded "
                    "MSMs (about two minutes on a CPU)")
    import jax.numpy as jnp

    from zerochain_tpu.dist.msm import sharded_msm_g1, sharded_suffix
    from zerochain_tpu.ec import g1 as jg1
    from zerochain_tpu.ec.fields import FqOps as JFq
    from zerochain_tpu.ff import limbs as JL
    from zerochain_tpu.msm import pippenger as jpip
    from zerochain_tpu.msm.suffix import SuffixMsm as JSuffixMsm

    mesh = _mesh()
    out = {}
    pts, scal = world.msm_g1_inputs()
    res = sharded_msm_g1(jg1.from_affine_host(pts),
                         jpip.scalars_to_bits(scal, 32), mesh, "pt",
                         use_pippenger=False)
    out["msm_g1"] = jg1.to_affine_host(jpip.tmap(lambda t: t[..., None], res))[0]

    pts, scal = world.suffix_inputs()
    m = JSuffixMsm(JFq, c=4, n_bits=31, window_group=4, signed=True)
    limbs = jnp.asarray(np.stack(
        [np.stack([JL._int_to_limbs(v, JL.FR.n) for v in s], 1) for s in scal],
        -1))
    part = sharded_suffix(m, jg1.from_affine_host(pts), m.digits(limbs), mesh,
                          "pt")
    out["suffix_partials"] = tuple(np.asarray(t) for t in part)
    out["suffix"] = jg1.to_affine_host(m.combine(part))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    handle = world.start_world("ntt_msm", tmp_path_factory.mktemp("dist"))
    jax_out = _jax_transforms()
    return world.finish_world(handle), jax_out


def _leaves(v):
    if isinstance(v, torch.Tensor):
        return [v]
    return [t for c in v for t in (c if isinstance(c, tuple) else (c,))]


def test_every_rank_holds_the_same_words(run):
    ranks, _ = run
    assert len(ranks) == world.WORLD
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k, v in ranks[0].items():
            if k == "twiddles":  # each rank's own rows
                continue
            assert all(torch.equal(a, b)
                       for a, b in zip(_leaves(v), _leaves(r[k]))), k


@pytest.mark.parametrize("built", ["host", "device"])
def test_dist_twiddle_rows(run, built):
    from zerochain_tpu_torch.mirror.field import R, fr_inv

    d1, d2 = world.NTT_D1, world.NTT_D2
    omega = dom.omega_for(D)
    for rank, out in enumerate(run[0]):
        tw = out["twiddles"]
        rows = range(rank * d1 // world.WORLD, (rank + 1) * d1 // world.WORLD)
        assert tw["rows"] == (rows.start, rows.stop)
        for got, w in zip(tw[built], (omega, fr_inv(omega))):
            assert tuple(got.shape) == (L.FR.n, len(rows), d2)
            want = [pow(w, j * r, R) for j in rows for r in range(d2)]
            assert L.FR.to_ints(got.reshape(L.FR.n, -1), mont=True) == want


@pytest.mark.parametrize("name", TRANSFORMS + ("quotient",))
def test_dist_ntt_device_twiddles(run, name):
    from zerochain_tpu_torch.ntt import quotient

    plan = plan_for(D, "cpu")
    if name == "quotient":
        want = quotient(plan, *(
            L.FR.array(world.fr_values(6 + k, 2 * D), "cpu", mont=True)
            .reshape(L.FR.n, 2, D) for k in range(3)))
    else:
        want = getattr(plan, name)(
            L.FR.array(world.fr_values(5, D), "cpu", mont=True))
    for out in run[0]:
        assert torch.equal(out["device_twiddles." + name], want)


@pytest.mark.parametrize("name", TRANSFORMS)
def test_dist_ntt_family(run, name):
    ranks, jax_out = run
    got = ranks[0][name]
    assert L.FR.to_ints(got, mont=True) == jax_out[name]
    x = L.FR.array(world.fr_values(5, D), "cpu", mont=True)
    assert torch.equal(got, getattr(plan_for(D, "cpu"), name)(x))


def test_dist_quotient(run):
    ranks, jax_out = run
    got = ranks[0]["quotient"]
    assert tuple(got.shape) == (L.FR.n, 2, D)
    assert L.FR.to_ints(got, mont=True) == jax_out["quotient"]
    plan = plan_for(D, "cpu")
    a, b, c = (L.FR.array(world.fr_values(6 + k, 2 * D), "cpu", mont=True)
               .reshape(L.FR.n, 2, D) for k in range(3))
    a_c, b_c, c_c = (plan.coset_ntt(plan.intt(e)) for e in (a, b, c))
    q = L.sub(L.FR, L.mont_mul(L.FR, a_c, b_c), c_c)
    want = plan.icoset_ntt(plan.divide_by_z_on_coset(q))
    assert torch.equal(got, want)


def test_distributed_ntt(run):
    vals = world.fr_values(7, D)
    got = L.FR.to_ints(run[0][0]["distributed_ntt"], mont=True)
    assert got == dom.ntt(vals, dom.omega_for(D))


def test_sharded_msm_g1(run):
    pts, scal = world.msm_g1_inputs()
    got = g1.to_affine_host(pip.tmap(lambda t: t[..., None], run[0][0]["msm_g1"]))
    assert got == [cv.g1_msm(pts, scal)]


def test_sharded_suffix(run):
    pts, scal = world.suffix_inputs()
    msm = world.suffix_msm()
    part = run[0][0]["suffix"]
    single = msm.window_partials(g1.from_affine_host(pts, device="cpu"),
                                 world.suffix_digits(msm, scal))
    got, want = (W.normalize(FqOps, p) for p in (part, single))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = g1.to_affine_host(msm.combine(part))
    assert got == g1.to_affine_host(msm.combine(single))
    assert got == [cv.g1_msm(pts, s) for s in scal]


def test_sharded_msm_g1_equals_the_jax_one(run, jax_msms):
    got = g1.to_affine_host(pip.tmap(lambda t: t[..., None], run[0][0]["msm_g1"]))
    assert got == [jax_msms["msm_g1"]]


def test_sharded_suffix_equals_the_jax_one(run, jax_msms):
    from zerochain_tpu_torch.convert import points_from_ref

    msm = world.suffix_msm()
    part = run[0][0]["suffix"]
    got = W.normalize(FqOps, part)
    want = W.normalize(FqOps, points_from_ref(jax_msms["suffix_partials"]))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert g1.to_affine_host(msm.combine(part)) == jax_msms["suffix"]
