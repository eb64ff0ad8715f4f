"""Witness synthesis for the MiniCommit fixture circuit.

Reuses the confidential compiler's gadget emitters; aux order matches
models/mini.py allocation order (proving + verifying fails on any aux
misalignment)."""

from __future__ import annotations

import torch

from .. import _device
from ..ff import limbs as L
from .witness import (
    _bits_le,
    _u32_host,
    Emitter,
    compute_fixed_base_chains,
    emit_fixed_base,
    emit_u32_range,
)

FR = L.FR


def mini_witness(amount_u32):
    """(B,) int64 < 2^32 -> (aux (8, n_aux, B), public (8, 3, B)) mont."""
    em = Emitter()
    B = amount_u32.shape[0]
    fb = compute_fixed_base_chains([_bits_le(amount_u32, 32)])
    emit_u32_range(em, amount_u32)
    g = emit_fixed_base(em, fb, 0, 32)
    one = L.ones_mont(FR, (B,), amount_u32.device)
    public = torch.stack([one, g[0], g[1]], dim=1)
    return em.concat(), public


def witness_inputs_host(assignments: list[dict], device=None):
    dev = _device.resolve(device)
    return dict(amount_u32=_u32_host([a["amount"] for a in assignments], dev))
