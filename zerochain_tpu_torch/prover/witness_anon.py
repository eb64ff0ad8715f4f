"""Batched witness synthesis for the AnonymousTransfer circuit.

Same design as prover/witness.py (the ConfidentialTransfer witness): the
circuit is fixed, so witness generation is straight tensor code batched over
a trailing proof axis B.  The 12-member anonymity-set machinery of the
reference (core/proofs/src/circuit/anonimity_set.rs:32-483) carries the
anonymity-set axis as a tensor dimension: selector masks, the one-hot
Σ-folds and the 12 parallel ``enc_key_i * randomness`` chains.

The Jubjub chains run one kernel launch a group (ec/cuda_jubjub.py): the
five fixed-base chains in one ``fixed_chain`` launch, the 14 variable-base
chains (12 members, ``cr_minus_d * dec_key`` and the nonce) in one
``var_chain`` launch, and the seven distinct ``edwards_add_fold`` sums in
two more ``fixed_chain`` launches (the folds whose points are known before
the variable-base chains, then the two over their results): a fold is the
running sum of its 12 selected points from the identity, which is the
fixed-base window sum with the identity as window 0.

Aux values are emitted in EXACTLY the allocation order of
models/anonymous.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _device
from ..ec import cuda_jubjub
from ..ec import jubjub as ej
from ..ff import limbs as L
from .witness import (
    Emitter,
    _affine_add_aux,
    _bits_le,
    _normalize_stack,
    _u32_host,
    affine_mont_host,
    bits_le_host,
    compute_fixed_base_chains,
    compute_var_mul_chains,
    emit_add_gadget,
    emit_field_bits,
    emit_fixed_base,
    emit_not_small_order,
    emit_u32_range,
    emit_var_mul,
    emit_witness_point,
    mul,
)

FR = L.FR
ANONIMITY_SIZE = 12


def _ones_like(x):
    return L.ones_mont(FR, x.shape[1:], x.device)


def _select(bools, px, py):
    """bools (K, B) 0/1 ? (px, py) : the identity (0, 1), (8, K, B)."""
    on = bools[None].to(torch.bool)
    return (torch.where(on, px, torch.zeros_like(px)),
            torch.where(on, py, _ones_like(py)))


def _emit_witness_points_vec(em: Emitter, x, y):
    """12 EdwardsPoint::witness gadgets: per point [x, y, x², y², x²y²].

    x, y: (8, K, B)."""
    x2 = mul(x, x)
    y2 = mul(y, y)
    x2y2 = mul(x2, y2)
    block = torch.stack([x, y, x2, y2, x2y2], dim=2)  # (8, K, 5, B)
    em.emit(block.reshape(FR.n, block.shape[1] * 5, block.shape[-1]))
    return x, y


# ---------------------------------------------------------------- folds
def fold_windows(folds):
    """The window points of ``fixed_chain`` for independent folds.

    folds: list of (bools (K, B), px, py (8, K, B)).  -> (selections, lx,
    ly): each fold's selected points (selx, sely), and lx, ly (8, K + 1,
    n_folds, B) with the identity (0, 1) as window 0 and the selections as
    windows 1..K."""
    sels = [_select(b, x, y) for b, x, y in folds]
    sx0 = sels[0][0]
    zero = torch.zeros_like(sx0[:, :1])
    one = _ones_like(sx0[:, :1])
    lx = torch.stack([torch.cat([zero, sx], dim=1) for sx, _ in sels], dim=2)
    ly = torch.stack([torch.cat([one, sy], dim=1) for _, sy in sels], dim=2)
    return sels, lx, ly


def compute_folds(folds):
    """Binary::edwards_add_fold values of independent folds, all in one
    ``fixed_chain`` launch and one batched inversion.

    -> per fold (selx, sely, accx, accy), each (8, K, B): the selections
    and the running affine sums after each member."""
    sels, lx, ly = fold_windows(folds)
    accx, accy = _normalize_stack(cuda_jubjub.fixed_chain(lx, ly))  # (8, K, n, B)
    return [(sx, sy, accx[:, :, i], accy[:, :, i])
            for i, (sx, sy) in enumerate(sels)]


def _emit_fold(em: Emitter, fold):
    """Binary::edwards_add_fold aux: per member i the selection [x', y']
    then the add [U, A, B, C, x3, y3] (anonimity_set.rs:157-192).

    fold: (selx, sely, accx, accy) of ``compute_folds``.  Returns the final
    affine accumulator (x, y), each (8, B)."""
    selx, sely, accx, accy = fold
    # the fold starts from the (0, 1) zero_p witness
    prevx = torch.cat([torch.zeros_like(accx[:, :1]), accx[:, :-1]], dim=1)
    prevy = torch.cat([_ones_like(accy[:, :1]), accy[:, :-1]], dim=1)
    u, a, b, c = _affine_add_aux(prevx, prevy, selx, sely)
    block = torch.stack([selx, sely, u, a, b, c, accx, accy], dim=2)
    em.emit(block.reshape(FR.n, block.shape[1] * 8, block.shape[-1]))
    return accx[:, -1], accy[:, -1]


def _add_vec(x1, y1, x2, y2):
    """K independent EdwardsPoint::add gadgets: (U, A, B, C, x3, y3), each
    (8, K, B); one batched add, one batched inversion."""
    u, a, b, c = _affine_add_aux(x1, y1, x2, y2)
    x3, y3 = ej.normalize(ej.add(ej.ext_from_affine(x1, y1),
                                 ej.ext_from_affine(x2, y2)))
    return u, a, b, c, x3, y3


def _emit_add_vec(em: Emitter, vals):
    """The aux of ``_add_vec``'s K adds, grouped per add."""
    block = torch.stack(vals, dim=2)  # (8, K, 6, B)
    em.emit(block.reshape(FR.n, block.shape[1] * 6, block.shape[-1]))


def _emit_cond_eq(em: Emitter, bools, ax, ay, bx, by):
    """Binary::conditionally_equals aux: per member the two selections
    [a_x', a_y', b_x', b_y'] (the equality constraints add no aux)."""
    sax, say = _select(bools, ax, ay)
    sbx, sby = _select(bools, bx, by)
    block = torch.stack([sax, say, sbx, sby], dim=2)  # (8, K, 4, B)
    em.emit(block.reshape(FR.n, block.shape[1] * 4, block.shape[-1]))


# ======================================================================
# full AnonymousTransfer witness assembly
# ======================================================================

def anonymous_chains(amount_u32, remaining_u32, s_bits, t_bits,
                     dec_key_bits, randomness_bits, alpha_bits, enc_keys,
                     left_cts, left_bals, right_bals, gep, **_):
    """The witness's group arithmetic ahead of its emission: the five
    fixed-base chains, the 12 adds C_l_i + C_i, the folds of known points,
    cr_minus_d, the 14 variable-base chains and the folds over their
    results, in three ``fixed_chain`` launches and one ``var_chain`` launch.
    Takes the dict of ``witness_inputs_host`` (pgk is not needed here).

    -> dict: ``fb`` (compute_fixed_base_chains), ``right_ct``, ``lc_add``
    (the adds' U, A, B, C, x3, y3), ``pre`` / ``post`` (the fold inputs of
    the two fold launches, as ``compute_folds`` takes them) with their
    values ``pre_values`` / ``post_values``, ``right_fold``,
    ``cr_minus_d``, ``vm_bases``, ``vm_bits``, ``vm``
    (compute_var_mul_chains), ``emr`` (r * enc_key_i, (8, 12, B) each)."""
    B = dec_key_bits.shape[1]
    ekx, eky = enc_keys
    clx, cly = left_cts
    xor_bits = torch.bitwise_xor(s_bits, t_bits)

    # chain order is free; emission order is what must match
    fb = compute_fixed_base_chains(
        [
            _bits_le(amount_u32, 32),     # 0: amount_g
            _bits_le(remaining_u32, 32),  # 1: remaining_balance_g
            dec_key_bits,                 # 2: enc_key_sender
            randomness_bits,              # 3: right_ciphertext (r*G)
            alpha_bits,                   # 4: alpha_g
        ]
    )
    nw252 = 84
    right_ct = (fb["res_x"][:, nw252 - 2, 3], fb["res_y"][:, nw252 - 2, 3])

    lc_add = _add_vec(*left_bals, clx, cly)
    pre = [
        (s_bits, ekx, eky),               # expected enc_key_sender
        (t_bits, clx, cly),               # ct_left_t
        (xor_bits, clx, cly),             # ct_left_xor
        (s_bits, lc_add[4], lc_add[5]),   # lh_c
        (s_bits, *right_bals),            # right_fold
    ]
    pre_values = compute_folds(pre)
    right_fold = (pre_values[4][2][:, -1], pre_values[4][3][:, -1])
    cr_minus_d = ej.normalize(ej.add(ej.ext_from_affine(*right_fold),
                                     ej.ext_from_affine(*right_ct)))

    vm_bases = (
        torch.cat([ekx, cr_minus_d[0][:, None], gep[0][:, None]], dim=1),
        torch.cat([eky, cr_minus_d[1][:, None], gep[1][:, None]], dim=1),
    )  # (8, 14, B)
    rnd = randomness_bits[:, None, :]
    dk = dec_key_bits[:, None, :]
    vm_bits = torch.cat(
        [rnd.expand(252, ANONIMITY_SIZE, B), dk, dk], dim=1
    )  # (252, 14, B)
    vm = compute_var_mul_chains(vm_bases, vm_bits)
    emr = (vm["res_x"][:, -1, :ANONIMITY_SIZE],
           vm["res_y"][:, -1, :ANONIMITY_SIZE])

    post = [
        (t_bits, *emr),                   # enc_keys_random_fold_t
        (xor_bits, *emr),                 # rand_fold_xor
    ]
    return dict(fb=fb, right_ct=right_ct, lc_add=lc_add, pre=pre,
                pre_values=pre_values, right_fold=right_fold,
                cr_minus_d=cr_minus_d, vm_bases=vm_bases, vm_bits=vm_bits,
                vm=vm, emr=emr, post=post, post_values=compute_folds(post))


def anonymous_witness(
    amount_u32,          # (B,) int64 < 2^32
    remaining_u32,       # (B,)
    s_bits,              # (12, B) one-hot 0/1
    t_bits,              # (12, B) one-hot 0/1
    dec_key_bits,        # (252, B) 0/1
    randomness_bits,     # (252, B)
    alpha_bits,          # (252, B)
    enc_keys,            # (x, y) each (8, 12, B) Montgomery
    left_cts,            # (x, y) each (8, 12, B)
    left_bals,           # (x, y) each (8, 12, B)
    right_bals,          # (x, y) each (8, 12, B)
    pgk,                 # (x, y) each (8, B)
    gep,                 # (x, y) each (8, B)
):
    """-> (aux (8, n_aux, B), public (8, 105, B)), Montgomery words.

    Aux order matches models/anonymous.py allocation order exactly.
    right_ct is computed from randomness_bits, as the circuit derives it
    (r * G, the right ElGamal component), so no input carries it."""
    em = Emitter()
    B = dec_key_bits.shape[1]
    dev = dec_key_bits.device

    ekx, eky = enc_keys
    clx, cly = left_cts
    lbx, lby = left_bals
    rbx, rby = right_bals
    xor_bits = torch.bitwise_xor(s_bits, t_bits)
    nor_bits = (1 - s_bits) * (1 - t_bits)

    c = anonymous_chains(amount_u32, remaining_u32, s_bits, t_bits,
                         dec_key_bits, randomness_bits, alpha_bits, enc_keys,
                         left_cts, left_bals, right_bals, gep)
    fb, vm, vm_bits = c["fb"], c["vm"], c["vm_bits"]
    right_ct, right_fold = c["right_ct"], c["right_fold"]
    emrx, emry = c["emr"]
    fold_s_ek, fold_t_cl, fold_xor_cl, fold_s_lc, fold_s_rb = c["pre_values"]
    fold_t_emr, fold_xor_emr = c["post_values"]

    # ================== emission (circuit allocation order) ============
    # initialize acc.: zero_p witness (0, 1)
    zero_x = torch.zeros((FR.n, B), dtype=torch.int32, device=dev)
    emit_witness_point(em, zero_x, L.ones_mont(FR, (B,), dev))

    emit_u32_range(em, amount_u32)
    amount_g = emit_fixed_base(em, fb, 0, 32)
    emit_u32_range(em, remaining_u32)
    remaining_g = emit_fixed_base(em, fb, 1, 32)

    emit_field_bits(em, dec_key_bits)
    emit_field_bits(em, s_bits)  # Binary::new s (12 plain booleans)
    emit_field_bits(em, t_bits)  # Binary::new t

    _emit_witness_points_vec(em, ekx, eky)  # push enckeys
    _emit_fold(em, fold_s_ek)  # add folded enc keys
    emit_fixed_base(em, fb, 2, 252)  # compute enc_key_sender
    # (equal enc_key_sender: constraints only)

    # enc keys multiplied by randomness: bits then 12 var-mul chains
    emit_field_bits(em, randomness_bits)
    for i in range(ANONIMITY_SIZE):
        emit_var_mul(em, vm, vm_bits[:, i], i)

    _emit_witness_points_vec(em, clx, cly)  # ciphertext_left_set

    fold_t = _emit_fold(em, fold_t_emr)
    emit_add_gadget(em, *fold_t, *amount_g)  # expected ct left t
    _emit_fold(em, fold_t_cl)  # ct_left_t (equality: no aux)

    emit_field_bits(em, xor_bits)  # s_i xor t_i (12 xor aux)
    _emit_fold(em, fold_xor_emr)
    _emit_fold(em, fold_xor_cl)

    emit_field_bits(em, nor_bits)  # s_i nor t_i (12 nor aux)
    _emit_cond_eq(em, nor_bits, clx, cly, emrx, emry)

    # (inputize enc key set + ciphertext left set: no aux)

    _emit_witness_points_vec(em, lbx, lby)  # left balance witness
    _emit_add_vec(em, c["lc_add"])
    _emit_fold(em, fold_s_lc)  # lh_c

    _emit_witness_points_vec(em, rbx, rby)  # right balance witness
    _emit_fold(em, fold_s_rb)  # right_fold

    emit_field_bits(em, randomness_bits)  # second decomposition
    emit_fixed_base(em, fb, 3, 252)  # right_ciphertext = r*G
    emit_add_gadget(em, *right_fold, *right_ct)  # cr_minus_d
    crd_sk = emit_var_mul(em, vm, vm_bits[:, ANONIMITY_SIZE], ANONIMITY_SIZE)
    emit_add_gadget(em, *remaining_g, *crd_sk)  # rh_c (eq: no aux)

    # rvk (utils.rs:71-124)
    emit_witness_point(em, pgk[0], pgk[1])
    emit_not_small_order(em, pgk[0], pgk[1])
    emit_field_bits(em, alpha_bits)
    alpha_g = emit_fixed_base(em, fb, 4, 252)
    rvk = emit_add_gadget(em, pgk[0], pgk[1], *alpha_g)
    emit_not_small_order(em, *rvk)

    # g_epoch / nonce (utils.rs:126-154)
    emit_witness_point(em, gep[0], gep[1])
    nonce = emit_var_mul(em, vm, vm_bits[:, ANONIMITY_SIZE + 1],
                         ANONIMITY_SIZE + 1)

    aux = em.concat()

    # ---- 105 public inputs (anonymous_transfer.rs:454-478) ------------
    def interleave(x, y):  # (8, 12, B) pairs -> [x0, y0, x1, y1, ...]
        return torch.stack([x, y], dim=2).reshape(FR.n, 2 * ANONIMITY_SIZE, B)

    public = torch.cat(
        [
            L.ones_mont(FR, (1, B), dev),
            interleave(ekx, eky),
            interleave(clx, cly),
            interleave(lbx, lby),
            interleave(rbx, rby),
            torch.stack(
                [right_ct[0], right_ct[1], rvk[0], rvk[1],
                 gep[0], gep[1], nonce[0], nonce[1]],
                dim=1,
            ),
        ],
        dim=1,
    )
    return aux, public


# ---------------------------------------------------------------- host API
def _points_vec_host(lists, device):
    """[[(x, y)] * 12] * B -> (x, y) word tensors each (8, 12, B),
    Montgomery."""
    B = len(lists)

    def coord(i):
        flat = FR.array([p[i] for pts in lists for p in pts], device, mont=True)
        return flat.reshape(FR.n, B, ANONIMITY_SIZE).transpose(1, 2).contiguous()

    return coord(0), coord(1)


def _one_hot_host(indices, device, n=ANONIMITY_SIZE):
    arr = np.zeros((n, len(indices)), np.int64)
    for b, i in enumerate(indices):
        arr[int(i), b] = 1
    return torch.from_numpy(arr).to(device)


def witness_inputs_host(assignments: list[dict], device=None):
    """Device inputs of ``anonymous_witness`` from per-proof witness dicts
    with keys: amount, remaining_balance (ints); s_index, t_index (ints <
    12); dec_key, randomness, alpha (Fs ints); enc_keys, left_ciphertexts
    (12 affine points each); enc_balances (12 (left, right) pairs); pgk,
    g_epoch (affine points)."""
    dev = _device.resolve(device)
    get = lambda k: [a[k] for a in assignments]  # noqa: E731
    return dict(
        amount_u32=_u32_host(get("amount"), dev),
        remaining_u32=_u32_host(get("remaining_balance"), dev),
        s_bits=_one_hot_host(get("s_index"), dev),
        t_bits=_one_hot_host(get("t_index"), dev),
        dec_key_bits=bits_le_host(get("dec_key"), 252, dev),
        randomness_bits=bits_le_host(get("randomness"), 252, dev),
        alpha_bits=bits_le_host(get("alpha"), 252, dev),
        enc_keys=_points_vec_host(get("enc_keys"), dev),
        left_cts=_points_vec_host(get("left_ciphertexts"), dev),
        left_bals=_points_vec_host(
            [[b[0] for b in a["enc_balances"]] for a in assignments], dev),
        right_bals=_points_vec_host(
            [[b[1] for b in a["enc_balances"]] for a in assignments], dev),
        pgk=affine_mont_host(get("pgk"), dev),
        gep=affine_mont_host(get("g_epoch"), dev),
    )


@functools.lru_cache(maxsize=None)
def _g_epoch():
    from ..mirror import jubjub as jj

    return jj.find_group_hash(b"\x09\x00\x00\x00", b"zcgepoch")


def anon_assignment(seed: bytes, amount=10, remaining=90, current=100,
                    s_index=3, t_index=7) -> dict:
    """One ``prove`` assignment: the sender at s_index and the recipient at
    t_index among 10 decoys, keys and randomness derived from seed, the
    sender's balance encrypting current."""
    from ..mirror.field import S
    from ..protocol.elgamal import Ciphertext
    from ..protocol.keys import EncryptionKey, ProofGenerationKey

    pgk = ProofGenerationKey.from_seed(seed)
    dec_key = pgk.into_decryption_key()
    ek_sender = EncryptionKey.from_decryption_key(dec_key)
    ek_recipient = EncryptionKey.from_seed(seed + b"recipient")
    decoys = [EncryptionKey.from_seed(seed + b"decoy %d" % i).point
              for i in range(10)]
    randomness = int.from_bytes(seed.ljust(32, b"r"), "little") % S
    alpha = int.from_bytes(seed.ljust(32, b"a"), "big") % S
    lo, hi = sorted((s_index, t_index))

    def insert_pair(lst, s_val, t_val):
        res = list(lst)
        res.insert(lo, s_val if lo == s_index else t_val)
        res.insert(hi, s_val if hi == s_index else t_val)
        return res

    lcs = insert_pair(
        [Ciphertext.encrypt(0, randomness, EncryptionKey(d)).left
         for d in decoys],
        Ciphertext.neg_encrypt(amount, randomness, ek_sender).left,
        Ciphertext.encrypt(amount, randomness, ek_recipient).left,
    )
    balances = insert_pair(
        [Ciphertext.encrypt(10 + i, (0x100 + i) % S, EncryptionKey(d))
         for i, d in enumerate(decoys)],
        Ciphertext.encrypt(current, 0x71, ek_sender),
        Ciphertext.encrypt(55, 0x72, ek_recipient),
    )
    return dict(
        amount=amount, remaining_balance=remaining,
        s_index=s_index, t_index=t_index, dec_key=dec_key.fs,
        randomness=randomness, alpha=alpha,
        enc_keys=insert_pair(decoys, ek_sender.point, ek_recipient.point),
        left_ciphertexts=lcs,
        enc_balances=[(b.left, b.right) for b in balances],
        pgk=pgk.point, g_epoch=_g_epoch(),
    )


def bench_assignments(n: int) -> list[dict]:
    """Self-contained AnonymousTransfer witness dicts for benchmarking:
    one real sender/recipient pair hidden among 10 decoys
    (ANONIMITY_SIZE=12, core/proofs/src/constants.rs:1-2)."""
    out = []
    for k in range(n):
        s_index, t_index = (3 + k) % 12, (7 + 5 * k) % 12
        if s_index == t_index:
            t_index = (t_index + 1) % 12
        out.append(anon_assignment(b"anon-bench-%d" % k, s_index=s_index,
                                   t_index=t_index))
    return out
