"""The port's Groth16 backend (prover/backend.py: TorchBackend) on the
MiniCommit fixture.

- ``generate_parameters(..., backend=TorchBackend("cpu"))`` equals the
  bigint MIRROR backend's parameters, point for point.
- ``create_proof`` through it equals the MIRROR proof and the port's
  ``MiniProver`` proof on those parameters, integer for integer.

``create_proof`` runs five bucket MSMs (``msm.pippenger.Msm``), whose
bucket fold is 510 sequential point adds, all windows side by side; the CPU
runs them at the speed of tiny tensor operations."""

import pytest
import torch

from zerochain_tpu_torch.groth16.core import (
    MIRROR, create_proof, generate_parameters)
from zerochain_tpu_torch.mirror.field import R
from zerochain_tpu_torch.models.mini import MiniCommit

torch.set_num_threads(2)  # several test workers share the cores

TOXIC = dict(tau=424242, alpha=111, beta=222, gamma=333, delta=444)
ASSIGNMENT = dict(amount=0xFFFF0001)
RS = (R - 5, 0xDEADBEEF)


def _ints(p):
    return (p.a, p.b, p.c)


@pytest.fixture(scope="module")
def params():
    from zerochain_tpu_torch.prover import TorchBackend

    backend = TorchBackend(device="cpu")
    return backend, generate_parameters(MiniCommit(), **TOXIC, backend=backend)


def test_generate_parameters_matches_the_mirror(params):
    _, got = params
    want = generate_parameters(MiniCommit(), **TOXIC, backend=MIRROR)
    assert got.vk == want.vk
    for name in ("h", "l", "a", "b_g1", "b_g2"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.num_inputs == want.num_inputs


def test_create_proof_matches_the_mirror_and_the_prover(monkeypatch, params):
    from zerochain_tpu_torch.prover import MiniProver

    monkeypatch.setenv("ZEROCHAIN_MSM_CHUNK", "256")
    backend, p = params
    prover = MiniProver(p, device="cpu")
    circuit = prover.circuit_for(ASSIGNMENT)
    assert circuit == MiniCommit(amount=ASSIGNMENT["amount"])
    got = create_proof(circuit, p, *RS, backend=backend)
    assert _ints(got) == _ints(create_proof(circuit, p, *RS))
    (want,) = prover.prove([ASSIGNMENT], rs=[RS])
    assert _ints(got) == _ints(want)

