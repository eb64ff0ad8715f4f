"""The split tail of the port's suffix MSM (``SuffixMsm(tail="split")``,
whose depth scan is ``cuda_scan.column_scan``) against the JAX package's
``SuffixMsm`` on the CPU, G1 and G2, at N = 2048: the column layout with
T = 2 on the port's side.  The JAX side runs its composed prefix scan there
(its column-scan kernel runs only on a TPU or in interpret mode), so the two
add in different orders and the window partials are compared after
``normalize`` (exact, tolerance 0).

This file stands apart from test_torch_split_tail.py because XLA compiles
the JAX G1 ``SuffixMsm`` in about 20 s and the G2 one in about 60 s on a
CPU."""

import numpy as np
import pytest
import torch

from test_torch_split_tail import split_case

torch.set_num_threads(2)  # several test workers share the cores


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_split_tail_matches_the_jax_suffix_msm(group):
    import jax.numpy as jnp

    from zerochain_tpu.ec import g1 as jg1
    from zerochain_tpu.ec import g2 as jg2
    from zerochain_tpu.ec.fields import FqOps as JFq, Fq2Ops as JFq2
    from zerochain_tpu.ff import limbs as JL
    from zerochain_tpu.msm.suffix import SuffixMsm as JSuffixMsm

    n = 2048
    c = split_case(group, n, n_bits=8, B=1)
    assert c["split"].column_split(n) and c["split"].n_windows == 2
    got = c["tg"].to_affine_host(
        c["split"].window_partials(c["tp"], prep=c["prep"]))

    jg, JF = (jg1, JFq) if group == "g1" else (jg2, JFq2)
    jmsm = JSuffixMsm(JF, c=8, n_bits=8, signed=True)
    jwords = jnp.asarray(np.stack(
        [np.stack([JL._int_to_limbs(v, JL.FR.n) for v in s], 1)
         for s in c["scal"]], -1))
    jtot = jmsm.window_partials(jg.from_affine_host(c["pts"]),
                                jmsm.digits(jwords))
    want = jg.to_affine_host(tuple(
        tuple(np.asarray(x).reshape(x.shape[0], -1) for x in co)
        if isinstance(co, tuple) else np.asarray(co).reshape(co.shape[0], -1)
        for co in jtot))
    assert len(got) == 2 and got == want
