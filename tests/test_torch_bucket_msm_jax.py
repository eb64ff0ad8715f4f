"""The bucket MSM's plain versions against the JAX ``Msm._window_total``
over G2 (test_torch_bucket_msm.py holds G1 and the mirror checks): each
row's total and every bucket, word for word.  A file of its own because XLA
compiles the JAX G2 window total in about 90 s on a CPU."""

import torch

from test_torch_bucket_msm import check_against_jax

torch.set_num_threads(2)  # several test workers share the cores


def test_g2_matches_the_jax_window_total():
    check_against_jax("g2")
