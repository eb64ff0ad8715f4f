"""The prover's bucket-MSM path, ``MiniProver(msm_impl="hs")``: its MSMs
are ``msm.pippenger.Msm``, whose Hillis-Steele levels are the
``hs_add_select`` kernel's plain version here.  It returns the proof of the
bigint prover ``groth16.core.create_proof``, which is the default
``MiniProver``'s proof (tests/test_torch_pipeline.py holds those two equal),
integer for integer, and the verifier accepts it.  The msm options follow
``ZEROCHAIN_MSM_IMPL`` and ``ZEROCHAIN_MSM_TOTALS`` as in the JAX package.

The bucket fold is 510 sequential point adds, all windows side by side;
the CPU runs them at the speed of tiny tensor operations."""

import pytest
import torch

from zerochain_tpu_torch.groth16.core import (
    create_proof, generate_parameters, prepare_verifying_key, verify_proof)
from zerochain_tpu_torch.mirror.field import R
from zerochain_tpu_torch.models.mini import MiniCommit

torch.set_num_threads(2)  # several test workers share the cores

ASSIGNMENT = dict(amount=0xFFFF0001)
RS = (R - 5, 0xDEADBEEF)


@pytest.fixture(scope="module")
def params():
    return generate_parameters(MiniCommit(), 424242, 111, 222, 333, 444)


def test_mini_prover_hs_gives_the_bigint_proof(monkeypatch, params):
    from zerochain_tpu_torch.msm import pippenger as pip
    from zerochain_tpu_torch.prover import MiniProver

    monkeypatch.setenv("ZEROCHAIN_MSM_CHUNK", "256")
    # the prover's default width c = 8 (conftest sets ZEROCHAIN_MSM_C=4)
    monkeypatch.setattr(pip, "WINDOW_C", 8)
    prover = MiniProver(params, device="cpu", msm_impl="hs")
    assert isinstance(prover.msm_g2, pip.Msm) and prover.msm_g2.c == 8
    (got,) = prover.prove([ASSIGNMENT], rs=[RS])
    want = create_proof(MiniCommit(amount=ASSIGNMENT["amount"]), params, *RS)
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    pvk = prepare_verifying_key(prover.vk)
    assert verify_proof(pvk, got, prover.public_inputs([ASSIGNMENT])[0])


def test_msm_options_read_the_env(monkeypatch, params):
    from zerochain_tpu_torch.msm import pippenger as pip
    from zerochain_tpu_torch.msm.suffix import SuffixMsm
    from zerochain_tpu_torch.prover import MiniProver

    monkeypatch.setenv("ZEROCHAIN_MSM_IMPL", "hs")
    monkeypatch.setattr(pip, "WINDOW_C", 8)  # the default; conftest sets 4
    prover = MiniProver(params, device="cpu")
    assert prover.msm_impl == "hs" and isinstance(prover.msm_g1, pip.Msm)
    assert prover.msm_g1.n_windows == 32
    monkeypatch.setenv("ZEROCHAIN_MSM_IMPL", "suffix")
    monkeypatch.setenv("ZEROCHAIN_MSM_TOTALS", "0")
    prover = MiniProver(params, device="cpu")
    assert isinstance(prover.msm_g2, SuffixMsm) and prover.msm_g2.tail == "split"
    with pytest.raises(ValueError):
        MiniProver(params, device="cpu", msm_impl="bucket")
