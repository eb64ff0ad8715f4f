"""Witness synthesis for the MiniCommit fixture circuit.

Reuses the confidential witness's plan and emitters; aux order matches
models/mini.py allocation order (proving + verifying fails on any aux
misalignment)."""

from __future__ import annotations

import functools

from .. import _device
from . import cuda_witness as cw
from .witness import (
    U32_ROWS,
    Plan,
    _bits_le,
    _u32_host,
    compute_fixed_base_chains,
    emit_u32_range,
    fixed_sources,
    new_aux,
    public_of,
)


@functools.lru_cache(maxsize=None)
def mini_plan() -> Plan:
    pl = Plan()
    pl.take("amount", U32_ROWS)
    g = pl.fixed("amount_g", 0, 32)
    return pl.finish([g])


def mini_witness(amount_u32):
    """(B,) int64 < 2^32 -> (aux (8, n_aux, B), public (8, 3, B)) mont."""
    plan = mini_plan()
    aux = new_aux(plan, amount_u32.shape[0], amount_u32.device)
    rows = plan.rows(aux)
    fb = compute_fixed_base_chains([_bits_le(amount_u32, 32)])
    emit_u32_range(rows("amount"), amount_u32)
    rows.check()
    cw.steps(plan.step_jobs({"fb": fixed_sources(fb)}), aux)
    return aux, public_of(plan, aux)


def witness_inputs_host(assignments: list[dict], device=None):
    dev = _device.resolve(device)
    return dict(amount_u32=_u32_host([a["amount"] for a in assignments], dev))
