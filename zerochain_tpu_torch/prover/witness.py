"""Batched witness synthesis for the ConfidentialTransfer circuit.

The reference re-interprets the circuit per proof (bellman ConstraintSystem
trait calls); here the circuit is fixed, so witness generation is straight
tensor code: bit decompositions and window lookups are gathers, the
scalar-mul chains run inversion-free in extended Edwards coordinates, each
group of them in one chain-kernel launch (ec/cuda_jubjub.py), and affine
gadget values are recovered with a handful of batched inversions, one
``ff.inv`` launch each.  Aux values are emitted in
EXACTLY the allocation order of models/confidential.py.

Everything is batched over a trailing proof axis B.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import _device
from ..ec import cuda_jubjub
from ..ec import jubjub as ej
from ..ff import limbs as L
from ..mirror import jubjub as mjj
from ..mirror.field import R
from ..native.codec import scalars_to_bits_np

FR = L.FR

mul = partial(L.mont_mul, FR)
fadd = partial(L.add, FR)
fsub = partial(L.sub, FR)

ONE_MONT = FR.r_mod_p
D_MONT = mjj.EDWARDS_D * FR.r_mod_p % R

_TABLES: dict = {}


def _table_mont(device):
    """Fixed-base window tables (gen NoteCommitmentRandomness): x/y tensors
    (8, 84 * 8) in Montgomery form, window-major."""
    key = str(device)
    if key not in _TABLES:
        windows = mjj.fixed_base_circuit_generators(
            mjj.NOTE_COMMITMENT_RANDOMNESS)
        xs = [x for coords in windows for (x, _) in coords]
        ys = [y for coords in windows for (_, y) in coords]
        assert len(xs) == 84 * 8
        _TABLES[key] = (FR.array(xs, device, mont=True),
                        FR.array(ys, device, mont=True))
    return _TABLES[key]


def bit_mont(bits):
    """(k, B) 0/1 integers -> (8, k, B) Montgomery word tensor."""
    return FR.const(ONE_MONT, bits[None]) * bits[None].to(torch.int32)


def u32_to_mont(v):
    """(B,) int64 values < 2^32 -> (8, B) Montgomery."""
    words = torch.zeros((FR.n, *v.shape), dtype=torch.int32, device=v.device)
    words[0] = ((v << 32) >> 32).to(torch.int32)
    return L.to_mont(FR, words)


def _bits_le(value, n):
    """(B,) int64 -> (n, B) int64 LE bits."""
    shifts = torch.arange(n, device=value.device).reshape(n, 1)
    return (value[None] >> shifts) & 1


# ---------------------------------------------------------------- gadget math
def _affine_dbl_aux(x, y):
    """T, A, C for a doubling gadget from the INPUT affine point."""
    s = fadd(x, y)
    t = mul(s, s)
    a = mul(x, y)
    c = mul(mul(FR.const(D_MONT, a), a), a)
    return t, a, c


def _affine_add_aux(x1, y1, x2, y2):
    """U, A, B, C for an addition gadget from the two affine inputs."""
    u = mul(fadd(x1, y1), fadd(x2, y2))
    a = mul(y2, x1)
    b = mul(x2, y1)
    c = mul(mul(FR.const(D_MONT, a), a), b)
    return u, a, b, c


class Emitter:
    """Collects aux blocks (8, k, B) in allocation order."""

    def __init__(self):
        self.blocks = []

    def emit(self, arr):
        if arr.dim() == 2:
            arr = arr[:, None, :]
        self.blocks.append(arr)

    def concat(self):
        return torch.cat(self.blocks, dim=1)


def emit_u32_range(em: Emitter, value):
    """range_check.rs layout: num, 31 BE run bits, 30 ANDs, bit 31.

    Returns LE bits (32, B)."""
    bits_le = _bits_le(value, 32)
    em.emit(u32_to_mont(value))
    bits_be = bits_le.flip(0)
    em.emit(bit_mont(bits_be[:31]))
    ands = torch.cumprod(bits_be[:31], dim=0)[1:]  # and-chain of the ones run
    em.emit(bit_mont(ands))
    em.emit(bit_mont(bits_be[31:32]))
    return bits_le


def emit_field_bits(em: Emitter, bits):
    em.emit(bit_mont(bits))


def fixed_base_digits(bits, n_windows=84):
    """(n, B) bits -> (n_windows, B) 3-bit digits (zero-padded)."""
    n, B = bits.shape
    pad = n_windows * 3 - n
    b = torch.cat([bits, torch.zeros((pad, B), dtype=bits.dtype,
                                     device=bits.device)], dim=0)
    b = b.reshape(n_windows, 3, B)
    return b[:, 0] + 2 * b[:, 1] + 4 * b[:, 2]


def compute_fixed_base_chains(bits_list):
    """Run all fixed-base chains together.

    bits_list: list of (n_i, B) bit tensors (same generator).  Returns per
    chain: dict with lookup affines, precomp bits, chain result affines.
    """
    dev = bits_list[0].device
    digits = torch.stack(
        [fixed_base_digits(b) for b in bits_list], dim=1
    ).to(torch.int64)  # (84, n_chains, B)
    tx, ty = _table_mont(dev)  # (8, 84 * 8)
    flat = (digits + 8 * torch.arange(84, device=dev).reshape(84, 1, 1))

    def gather(tab):  # -> (8, 84, n_chains, B)
        return tab.index_select(1, flat.reshape(-1)).reshape(
            FR.n, *digits.shape)

    lx = gather(tx)
    ly = gather(ty)

    # chain of additions over windows (extended coords), one launch
    rx_all, ry_all = _normalize_stack(
        cuda_jubjub.fixed_chain(lx, ly))  # (8, 83, n_chains, B)
    return {
        "digits": digits,
        "lookup_x": lx,
        "lookup_y": ly,
        "res_x": rx_all,
        "res_y": ry_all,
    }


def _normalize_stack(xyz):
    """X, Y, Z of k extended points, (3, 8, k, ...) -> affine (8, k, ...),
    with one batched inversion for all of them."""
    X, Y, Z = xyz
    zinv = L.batch_inv_mont(FR, Z.reshape(FR.n, -1), axis=1).reshape(Z.shape)
    return mul(X, zinv), mul(Y, zinv)


def emit_fixed_base(em: Emitter, chains, chain_idx: int, n_bits: int):
    """Emit lookup + addition aux for one fixed-base chain; returns the
    result affine (x, y)."""
    nw = -(-n_bits // 3)
    lx = chains["lookup_x"][:, :, chain_idx]  # (8, 84, B)
    ly = chains["lookup_y"][:, :, chain_idx]
    digits = chains["digits"][:, chain_idx]  # (84, B)
    rx = chains["res_x"][:, :, chain_idx]  # (8, 83, B)
    ry = chains["res_y"][:, :, chain_idx]

    # precomp bit values per window: bit1 & bit2 of the digit
    b1 = (digits >> 1) & 1
    b2 = (digits >> 2) & 1
    precomp = bit_mont(b1 & b2)  # (8, 84, B)

    full_windows = n_bits // 3  # windows with 3 real bits
    # window 0: x, y, precomp
    em.emit(torch.stack([lx[:, 0], ly[:, 0], precomp[:, 0]], dim=1))

    # windows 1..nw-1: lookup(3) + addition(6)
    # addition w inputs: result affine of w-1 (res for w>=2, lookup0 for w=1)
    prev_x = torch.cat([lx[:, 0:1], rx[:, : nw - 2]], dim=1)
    prev_y = torch.cat([ly[:, 0:1], ry[:, : nw - 2]], dim=1)
    cur_lx = lx[:, 1:nw]
    cur_ly = ly[:, 1:nw]
    u, a, b, c = _affine_add_aux(prev_x, prev_y, cur_lx, cur_ly)
    x3 = rx[:, : nw - 1]
    y3 = ry[:, : nw - 1]

    def win_block(w):
        parts = [cur_lx[:, w], cur_ly[:, w]]
        if w + 1 < full_windows:  # window w+1 has a real precomp bit
            parts.append(precomp[:, w + 1])
        parts += [u[:, w], a[:, w], b[:, w], c[:, w], x3[:, w], y3[:, w]]
        return torch.stack(parts, dim=1)

    if full_windows >= nw:  # all windows full (252-bit scalars)
        block = torch.stack(
            [cur_lx, cur_ly, precomp[:, 1:nw], u, a, b, c, x3, y3], dim=2
        )  # (8, nw-1, 9, B)
        em.emit(block.reshape(FR.n, (nw - 1) * 9, block.shape[-1]))
    else:
        for w in range(nw - 1):
            em.emit(win_block(w))

    return rx[:, nw - 2], ry[:, nw - 2]


def compute_var_mul_chains(bases, bits):
    """bases: affine (x, y) each (8, n_chains, B); bits (252, n_chains, B).

    Returns dict of affine tensors for curbase doublings, selections, and
    addition results."""
    curs, results = cuda_jubjub.var_chain(bases, bits)  # one launch
    cur_x, cur_y = _normalize_stack(curs)
    res_x, res_y = _normalize_stack(results)
    return {
        "cur_x": cur_x,  # (8, 252, C, B)
        "cur_y": cur_y,
        "res_x": res_x,
        "res_y": res_y,
    }


def emit_var_mul(em: Emitter, chains, bits, chain_idx: int):
    """Emit doubling/selection/addition aux for one variable-base mul.

    bits: (252, B) for this chain.  Returns result affine (x, y)."""
    cx = chains["cur_x"][:, :, chain_idx]  # (8, 252, B)
    cy = chains["cur_y"][:, :, chain_idx]
    rx = chains["res_x"][:, :, chain_idx]
    ry = chains["res_y"][:, :, chain_idx]
    nb = bits.shape[0]

    one = L.ones_mont(FR, cx.shape[1:], cx.device)
    on = bits[None].to(torch.bool)
    selx = torch.where(on, cx, torch.zeros_like(cx))
    sely = torch.where(on, cy, one)

    # selection 0 aux
    em.emit(torch.stack([selx[:, 0], sely[:, 0]], dim=1))

    # steps 1..251: doubling(T,A,C,x3,y3), selection(x',y'), addition(6)
    t, a, c = _affine_dbl_aux(cx[:, : nb - 1], cy[:, : nb - 1])
    dx3 = cx[:, 1:]
    dy3 = cy[:, 1:]
    u, aa, bb, cc = _affine_add_aux(
        rx[:, : nb - 1], ry[:, : nb - 1], selx[:, 1:], sely[:, 1:]
    )
    block = torch.stack(
        [
            t, a, c, dx3, dy3,
            selx[:, 1:], sely[:, 1:],
            u, aa, bb, cc, rx[:, 1:], ry[:, 1:],
        ],
        dim=2,
    )  # (8, 251, 13, B)
    em.emit(block.reshape(FR.n, (nb - 1) * 13, block.shape[-1]))
    return rx[:, nb - 1], ry[:, nb - 1]


def emit_witness_point(em: Emitter, x, y):
    """EdwardsPoint::witness aux: x, y, x^2, y^2, x^2y^2."""
    x2 = mul(x, x)
    y2 = mul(y, y)
    x2y2 = mul(x2, y2)
    em.emit(torch.stack([x, y, x2, y2, x2y2], dim=1))
    return x, y


def emit_add_gadget(em: Emitter, x1, y1, x2, y2):
    """Standalone EdwardsPoint::add: U, A, B, C, x3, y3 (affine math)."""
    u, a, b, c = _affine_add_aux(x1, y1, x2, y2)
    # x3 = (A+B)/(1+C), y3 = (U-A-B)/(1-C): done via extended add + normalize
    ext = ej.add(ej.ext_from_affine(x1, y1), ej.ext_from_affine(x2, y2))
    x3, y3 = ej.normalize(ext)
    em.emit(torch.stack([u, a, b, c, x3, y3], dim=1))
    return x3, y3


def emit_not_small_order(em: Emitter, x, y):
    """3 doublings (5 aux each) + ephemeral inverse of the final x."""
    cur = ej.ext_from_affine(x, y)
    outs = []
    for _ in range(3):
        cur = ej.double(cur)
        outs.append(cur)
    ax, ay = _normalize_stack(cuda_jubjub.stack_xyz(outs))  # (8, 3, B)

    in_x = torch.cat([x[:, None], ax[:, :2]], dim=1)
    in_y = torch.cat([y[:, None], ay[:, :2]], dim=1)
    t, a, c = _affine_dbl_aux(in_x, in_y)
    block = torch.stack([t, a, c, ax, ay], dim=2)  # (8, 3, 5, B)
    em.emit(block.reshape(FR.n, 15, block.shape[-1]))

    # ephemeral inverse of the third doubling's x (num::assert_nonzero)
    inv = L.batch_inv_mont(
        FR, ax[:, 2].reshape(FR.n, -1), axis=1
    ).reshape(x.shape)
    em.emit(inv)


# ======================================================================
# full ConfidentialTransfer witness assembly
# ======================================================================

def confidential_witness(
    amount_u32,          # (B,) int64 < 2^32
    remaining_u32,       # (B,)
    fee_u32,             # (B,)
    dec_key_bits,        # (252, B) 0/1
    randomness_bits,     # (252, B)
    alpha_bits,          # (252, B)
    ekr,                 # enc_key_recipient affine mont: (x, y) each (8, B)
    ebl,                 # enc_balance_left
    ebr,                 # enc_balance_right
    pgk,                 # proof generation key
    gep,                 # g_epoch
):
    """-> (aux (8, n_aux, B), public (8, 23, B)), both Montgomery words.

    Aux order matches models/confidential.py allocation order exactly."""
    em = Emitter()
    B = dec_key_bits.shape[1]

    amount_bits = emit_u32_range(em, amount_u32)
    remaining_bits = emit_u32_range(em, remaining_u32)
    fee_bits = emit_u32_range(em, fee_u32)
    emit_field_bits(em, dec_key_bits)

    # ---- fixed-base group (all on NoteCommitmentRandomness) ----------
    fb = compute_fixed_base_chains(
        [
            dec_key_bits,                         # 0: enc_key_sender
            amount_bits,                          # 1: amount_g
            fee_bits,                             # 2: fee_g
            randomness_bits,                      # 3: c_right
            remaining_bits,                       # 4: rem_bal_g
            alpha_bits,                           # 5: alpha_g
        ]
    )

    eks = emit_fixed_base(em, fb, 0, 252)          # enc_key_sender
    # (inputize enc_key_sender: no aux)
    amount_g = emit_fixed_base(em, fb, 1, 32)
    fee_g = emit_fixed_base(em, fb, 2, 32)
    emit_field_bits(em, randomness_bits)

    # ---- variable-base group (bases now known) -----------------------
    # c_right result is needed as a var-mul base: compute from chain 3
    nw252 = 84
    c_right = (fb["res_x"][:, nw252 - 2, 3], fb["res_y"][:, nw252 - 2, 3])

    vm_bases = (
        torch.stack([eks[0], ekr[0], c_right[0], ebr[0], gep[0]], dim=1),
        torch.stack([eks[1], ekr[1], c_right[1], ebr[1], gep[1]], dim=1),
    )
    vm_bits = torch.stack(
        [
            randomness_bits,   # 0: val_rls = eks * randomness
            randomness_bits,   # 1: val_rlr = ekr * randomness
            dec_key_bits,      # 2: dec_key_sender_random = c_right * dk
            dec_key_bits,      # 3: dec_key_sender_pointr = ebr * dk
            dec_key_bits,      # 4: nonce = g_epoch * dk
        ],
        dim=1,
    )  # (252, 5, B)
    vm = compute_var_mul_chains(vm_bases, vm_bits)

    val_rls = emit_var_mul(em, vm, vm_bits[:, 0], 0)

    emit_witness_point(em, ekr[0], ekr[1])
    emit_not_small_order(em, ekr[0], ekr[1])

    val_rlr = emit_var_mul(em, vm, vm_bits[:, 1], 1)
    # (inputize enc_key_recipient)

    c_left_sender = emit_add_gadget(em, *amount_g, *val_rls)
    c_left_recipient = emit_add_gadget(em, *amount_g, *val_rlr)
    c_right_res = emit_fixed_base(em, fb, 3, 252)
    f_left_sender = emit_add_gadget(em, *fee_g, *val_rls)
    # (inputize x4)

    emit_witness_point(em, ebl[0], ebl[1])
    emit_witness_point(em, ebr[0], ebr[1])
    emit_not_small_order(em, ebl[0], ebl[1])
    emit_not_small_order(em, ebr[0], ebr[1])

    dksr = emit_var_mul(em, vm, vm_bits[:, 2], 2)
    bal_dksr = emit_add_gadget(em, ebl[0], ebl[1], *dksr)
    emit_add_gadget(em, *bal_dksr, *dksr)  # bi_left

    dksp = emit_var_mul(em, vm, vm_bits[:, 3], 3)
    rem_bal_g = emit_fixed_base(em, fb, 4, 32)
    val_rem_bal = emit_add_gadget(em, *c_left_sender, *rem_bal_g)
    val_rem_bal_balr = emit_add_gadget(em, *val_rem_bal, *dksp)
    emit_add_gadget(em, *f_left_sender, *val_rem_bal_balr)  # bi_right
    # (eq points, inputize enc_balance_left/right: no aux)

    # ---- rvk ----------------------------------------------------------
    emit_witness_point(em, pgk[0], pgk[1])
    emit_not_small_order(em, pgk[0], pgk[1])
    emit_field_bits(em, alpha_bits)
    alpha_g = emit_fixed_base(em, fb, 5, 252)
    rvk = emit_add_gadget(em, pgk[0], pgk[1], *alpha_g)
    emit_not_small_order(em, *rvk)
    # (inputize rvk)

    # ---- g_epoch / nonce ---------------------------------------------
    emit_witness_point(em, gep[0], gep[1])
    nonce = emit_var_mul(em, vm, vm_bits[:, 4], 4)
    # (inputize g_epoch, nonce)

    aux = em.concat()

    one = L.ones_mont(FR, (B,), aux.device)
    public = torch.stack(
        [
            one,
            eks[0], eks[1],
            ekr[0], ekr[1],
            c_left_sender[0], c_left_sender[1],
            c_left_recipient[0], c_left_recipient[1],
            c_right_res[0], c_right_res[1],
            f_left_sender[0], f_left_sender[1],
            ebl[0], ebl[1],
            ebr[0], ebr[1],
            rvk[0], rvk[1],
            gep[0], gep[1],
            nonce[0], nonce[1],
        ],
        dim=1,
    )
    return aux, public


# ---------------------------------------------------------------- host API
def bits_le_host(values, n_bits, device):
    return torch.from_numpy(
        scalars_to_bits_np(list(values), n_bits).astype(np.int64)).to(device)


def affine_mont_host(points, device):
    """[(x, y), ...] host ints -> (x, y) each (8, B) Montgomery."""
    xs = FR.array([p[0] for p in points], device, mont=True)
    ys = FR.array([p[1] for p in points], device, mont=True)
    return xs, ys


def _u32_host(values, device):
    return torch.tensor([int(v) & 0xFFFFFFFF for v in values],
                        dtype=torch.int64, device=device)


def witness_inputs_host(assignments: list[dict], device=None):
    """Build device inputs from a list of per-proof witness dicts with keys:
    amount, remaining_balance, fee (ints); dec_key, randomness, alpha (Fs
    ints); enc_key_recipient, encrypted_balance (left/right), pgk, g_epoch
    (affine int points)."""
    dev = _device.resolve(device)
    get = lambda k: [a[k] for a in assignments]  # noqa: E731
    return dict(
        amount_u32=_u32_host(get("amount"), dev),
        remaining_u32=_u32_host(get("remaining_balance"), dev),
        fee_u32=_u32_host(get("fee"), dev),
        dec_key_bits=bits_le_host(get("dec_key"), 252, dev),
        randomness_bits=bits_le_host(get("randomness"), 252, dev),
        alpha_bits=bits_le_host(get("alpha"), 252, dev),
        ekr=affine_mont_host(get("enc_key_recipient"), dev),
        ebl=affine_mont_host(get("enc_balance_left"), dev),
        ebr=affine_mont_host(get("enc_balance_right"), dev),
        pgk=affine_mont_host(get("pgk"), dev),
        gep=affine_mont_host(get("g_epoch"), dev),
    )
