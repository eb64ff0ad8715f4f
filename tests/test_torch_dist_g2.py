"""The port's ``dist.sharded_msm`` over G2 with a proof-batch axis (16
points, B = 2, the bucket MSM on each of four gloo ranks,
tests/torch_dist_world.py) against the mirror, the port's single-device
``Msm`` and the JAX package's ``dist.sharded_msm`` on a mesh of four
virtual CPU devices: equal after ``normalize``, the same words on every
rank.  A file of its own, because XLA compiles the JAX G2 MSM for about
seven minutes on a CPU (test_dist.py's G2 case): that comparison runs only
with ``ZEROCHAIN_DIST_JAX=1``, while the ranks run."""

import os

import numpy as np
import pytest
import torch

import torch_dist_world as world
from zerochain_tpu_torch.ec import g2
from zerochain_tpu_torch.ec.fields import Fq2Ops
from zerochain_tpu_torch.mirror import curves as cv
from zerochain_tpu_torch.msm import pippenger as pip

torch.set_num_threads(2)  # several test workers share the cores


def _jax_sharded_msm():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from zerochain_tpu.dist.msm import sharded_msm
    from zerochain_tpu.ec import g2 as jg2
    from zerochain_tpu.ec.fields import Fq2Ops as JFq2
    from zerochain_tpu.msm import pippenger as jpip

    pts, scal = world.msm_g2_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:world.WORLD]), ("pt",))
    bits = jnp.stack([jpip.scalars_to_bits(s, 16) for s in scal], -1)
    res = sharded_msm(JFq2, jg2.from_affine_host(pts), bits, mesh, "pt",
                      use_pippenger=True)
    return jg2.to_affine_host(res)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    handle = world.start_world("msm_g2", tmp_path_factory.mktemp("dist_g2"))
    jax_out = _jax_sharded_msm() if os.environ.get("ZEROCHAIN_DIST_JAX") else None
    return world.finish_world(handle), jax_out


def _want():
    pts, scal = world.msm_g2_inputs()
    want = []
    for s in scal:
        acc = None
        for p, k in zip(pts, s):
            acc = cv.g2_add(acc, cv.g2_mul(p, k))
        want.append(acc)
    return want


def test_sharded_msm_g2_batched(run):
    pts, scal = world.msm_g2_inputs()
    got = g2.to_affine_host(run[0][0]["msm_g2"])
    bits = torch.stack([pip.scalars_to_bits(s, 16) for s in scal], -1)
    single = pip.Msm(Fq2Ops)(g2.from_affine_host(pts, device="cpu"), bits)
    assert got == g2.to_affine_host(single) == _want()


def test_sharded_msm_g2_equals_the_jax_one(run):
    if run[1] is None:
        pytest.skip("set ZEROCHAIN_DIST_JAX=1 to compile the JAX G2 sharded "
                    "MSM (about seven minutes on a CPU)")
    assert g2.to_affine_host(run[0][0]["msm_g2"]) == run[1] == _want()


def test_every_rank_holds_the_same_words(run):
    ranks = run[0]
    ref = [t for c in ranks[0]["msm_g2"] for t in c]
    for r in ranks[1:]:
        assert all(torch.equal(a, b)
                   for a, b in zip(ref, [t for c in r["msm_g2"] for t in c]))
