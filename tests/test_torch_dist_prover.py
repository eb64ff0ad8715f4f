"""``MiniProver`` with ``ZEROCHAIN_DIST=1`` in a gloo world of four CPU
processes (tests/torch_dist_world.py), on the suffix path and the hs path:
the quotient as four-step distributed transforms, every MSM chunk's points
split over the ranks.  Each rank's proofs must equal the port's
single-device ``MiniProver`` proofs at the same (r, s) (exact integers);
the host verifier accepts them and rejects a swapped input.  Without a
process group the prover raises.

The two paths run as two worlds at once, while the test process proves the
single-device batch; the CRS is generated once and handed to the ranks as a
cache file."""

import pytest
import torch

import torch_dist_world as world
from zerochain_tpu_torch.dist import comm
from zerochain_tpu_torch.prover import MiniProver

torch.set_num_threads(2)  # several test workers share the cores

IMPLS = ("suffix", "hs")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_prover")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZEROCHAIN_MSM_CHUNK", "256")  # inherited by the ranks
        prover = MiniProver.from_toxic_waste(**world.MINI_TOXIC,
                                             chunk=256, chunk_g2=256,
                                             device="cpu")
        handles = {}
        for impl in IMPLS:
            (tmp / impl).mkdir()
            prover.save_queries(str(tmp / impl / "mini_crs.npz"))
            handles[impl] = world.start_world("prover_" + impl, tmp / impl)
        single = prover.prove(world.MINI_ASSIGNMENTS, rs=world.MINI_RS)
        ranks = {impl: world.finish_world(h) for impl, h in handles.items()}
    return prover, [(p.a, p.b, p.c) for p in single], single, ranks


@pytest.mark.parametrize("impl", IMPLS)
def test_dist_proofs_equal_single_device(run, impl):
    _, single, _, ranks = run
    assert len(ranks[impl]) == world.WORLD
    for r in ranks[impl]:
        assert r["proofs"] == single


def test_dist_proofs_verify(run):
    from zerochain_tpu_torch.groth16.core import prepare_verifying_key, verify_proof

    prover, ints, proofs, ranks = run
    assert ranks["suffix"][0]["proofs"] == ints  # the proofs below are the ranks'
    pvk = prepare_verifying_key(prover.vk)
    pubs = prover.public_inputs(world.MINI_ASSIGNMENTS)
    for proof, pub in zip(proofs, pubs):
        assert verify_proof(pvk, proof, pub)
    assert not verify_proof(pvk, proofs[0], pubs[1])


@pytest.mark.parametrize("impl", IMPLS)
def test_dist_collectives(run, impl):
    """One all-to-all and one all-gather a distributed transform (the
    quotient's 7: d = 256 >= 2 * 4^2), one all-gather an MSM chunk."""
    prover = run[0]
    n_chunks = sum(len(c) for c in (prover.a_chunks, prover.b1_chunks,
                                    prover.b2_chunks, prover.l_chunks,
                                    prover.h_chunks))
    for r in run[3][impl]:
        got = r["collectives"]
        assert got["all_to_all"] == 7
        assert got["all_gather"] == 7 + n_chunks


def test_dist_without_a_group_raises(run, monkeypatch):
    import torch.distributed as dist

    prover = run[0]
    assert not dist.is_initialized()
    monkeypatch.setenv("ZEROCHAIN_DIST", "1")
    with pytest.raises(RuntimeError, match="process group"):
        MiniProver(None, _device_queries=prover._raw_queries, _vk=prover.vk,
                   device="cpu")


@pytest.mark.parametrize("backend,device,ok", [
    ("gloo", "cpu", True), ("nccl", "cpu", False),
    ("cpu:gloo,cuda:nccl", "cpu", True), ("cpu:nccl,cuda:gloo", "cpu", False),
    ("gloo", "meta", False)])
def test_backend_must_serve_the_device(monkeypatch, backend, device, ok):
    """dist/ refuses a group whose backend does not serve the tensors'
    device (gloo on the CPU, NCCL on the card) and never copies round it."""
    monkeypatch.setattr(comm.dist, "get_backend", lambda group=None: backend)
    t = torch.zeros(1, device=device)
    if ok:
        comm.check_backend(t)
    else:
        with pytest.raises(RuntimeError, match="process group"):
            comm.check_backend(t)
