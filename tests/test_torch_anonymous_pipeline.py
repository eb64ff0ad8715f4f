"""The AnonymousTransfer slice as a whole: the port's AnonymousProver on the
CPU against the JAX AnonymousProver, on one CRS (the JAX prover's
``from_toxic_waste``, carried over by ``save_queries`` and
``convert.queries_from_ref_npz``) with the same (r, s): equal proofs,
integer for integer, that the host verifier accepts, and a perturbed or
swapped public input rejected.

The JAX prover's graphs at d = 65,536 compile for a long time on a CPU and
the port's plain MSMs take minutes there, so this waits behind
ZEROCHAIN_PIPELINE=1 as its confidential twin does."""

import os

import pytest
import torch

torch.set_num_threads(2)  # several test workers share the cores

pytestmark = pytest.mark.skipif(
    not os.environ.get("ZEROCHAIN_PIPELINE"),
    reason="set ZEROCHAIN_PIPELINE=1 to run the full AnonymousTransfer pipeline on a CPU",
)

TOXIC = dict(tau=1234577, alpha=998877, beta=665544, gamma=332211, delta=118822)


def test_anonymous_prover_matches_jax(tmp_path):
    from zerochain_tpu.prover_tpu.pipeline import AnonymousProver as JProver
    from zerochain_tpu_torch.prover import AnonymousProver

    from test_torch_anonymous import two_assignments
    from test_torch_pipeline import _both_provers

    prover, _ = _both_provers(tmp_path, JProver.from_toxic_waste(**TOXIC),
                              AnonymousProver, two_assignments())
    assert all(len(p) == 104 for p in prover.public_inputs(two_assignments()))
