"""Batched witness synthesis for the AnonymousTransfer circuit.

Same design as prover/witness.py (the ConfidentialTransfer witness): the
circuit is fixed, so witness generation is straight tensor code batched over
a trailing proof axis B, into one preallocated aux tensor laid out by a
:class:`~.witness.Plan`.  The 12-member anonymity-set machinery of the
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

The gadget aux is three programs and one step launch
(prover/cuda_witness.py): program "lc" (the 12 adds C_l_i + C_i, whose sums
one fold needs) before the first folds, program "crd" (cr_minus_d, a
variable-base chain's base) before the variable-base chains, then the
chains' and folds' per-step aux in one ``steps`` launch and program "main"
(the witnessed points, the other adds and the not-small-order checks).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _device
from ..ec import cuda_jubjub
from ..ff import limbs as L
from . import cuda_witness as cw
from .witness import (
    U32_ROWS,
    Ins,
    Plan,
    _bits_le,
    _normalize_stack,
    _u32_host,
    affine_mont_host,
    bits_le_host,
    compute_fixed_base_chains,
    compute_var_mul_chains,
    emit_field_bits,
    emit_u32_range,
    fixed_sources,
    new_aux,
    public_of,
    var_sources,
)

FR = L.FR
ANONIMITY_SIZE = 12


def _ones_like(x):
    return L.ones_mont(FR, x.shape[1:], x.device)


# ---------------------------------------------------------------- folds
def fold_windows(folds):
    """The window points of ``fixed_chain`` for independent folds.

    folds: list of (bools (K, B), px, py (8, K, B)).  -> (selections, lx,
    ly): each fold's selected points (selx, sely), and lx, ly (8, K + 1,
    n_folds, B) with the identity (0, 1) as window 0 and the selections as
    windows 1..K."""
    sels = [cw.select_point(b, x, y) for b, x, y in folds]
    sx0 = sels[0][0]
    zero = torch.zeros_like(sx0[:, :1])
    one = _ones_like(sx0[:, :1])
    lx = torch.stack([torch.cat([zero, sx], dim=1) for sx, _ in sels], dim=2)
    ly = torch.stack([torch.cat([one, sy], dim=1) for _, sy in sels], dim=2)
    return sels, lx, ly


def fold_group(folds):
    """Binary::edwards_add_fold values of independent folds, all in one
    ``fixed_chain`` launch and one batched inversion.

    -> (values, sources): per fold (selx, sely, accx, accy), each (8, K, B),
    the selections and the running affine sums after each member; and the
    folds' step-job sources (the selections and sums as (8, K, n_folds, B))."""
    sels, lx, ly = fold_windows(folds)
    accx, accy = _normalize_stack(cuda_jubjub.fixed_chain(lx, ly))  # (8, K, n, B)
    values = [(sx, sy, accx[:, :, i], accy[:, :, i])
              for i, (sx, sy) in enumerate(sels)]
    return values, ((lx[:, 1:], ly[:, 1:], accx, accy), None)


def compute_folds(folds):
    """The per-fold values of :func:`fold_group`."""
    return fold_group(folds)[0]


def _emit_cond_eq(em, bools, ax, ay, bx, by):
    """Binary::conditionally_equals aux: per member the two selections
    [a_x', a_y', b_x', b_y'] (the equality constraints add no aux)."""
    sax, say = cw.select_point(bools, ax, ay)
    sbx, sby = cw.select_point(bools, bx, by)
    block = torch.stack([sax, say, sbx, sby], dim=2)  # (8, K, 4, B)
    em.emit(block.reshape(FR.n, block.shape[1] * 4, block.shape[-1]))


# ======================================================================
# full AnonymousTransfer witness assembly
# ======================================================================

@functools.lru_cache(maxsize=None)
def anonymous_plan() -> Plan:
    """models/anonymous.py's allocation order."""
    K = ANONIMITY_SIZE
    pl = Plan()
    pl.witness_point("zero_p")  # initialize acc.: the (0, 1) witness
    pl.take("amount", U32_ROWS)
    amount_g = pl.fixed("amount_g", 0, 32)
    pl.take("remaining", U32_ROWS)
    remaining_g = pl.fixed("remaining_g", 1, 32)
    pl.take("dec_key_bits", 252)
    pl.take("s_bits", K)  # Binary::new s (12 plain booleans)
    pl.take("t_bits", K)
    eks = pl.witness_points("enc_keys", K)
    pl.fold("fold_s_ek", "pre", 0, K)  # add folded enc keys
    pl.fixed("enc_key_sender", 2, 252)  # (equal enc_key_sender: no aux)
    pl.take("randomness_bits", 252)
    for i in range(K):  # enc keys multiplied by randomness
        pl.var(f"emr.{i}", i)
    cls = pl.witness_points("left_cts", K)
    fold_t = pl.fold("fold_t_emr", "post", 0, K)
    pl.add("expected_ct_left_t", fold_t, amount_g)
    pl.fold("fold_t_cl", "pre", 1, K)  # ct_left_t (equality: no aux)
    pl.take("xor_bits", K)  # s_i xor t_i
    pl.fold("fold_xor_emr", "post", 1, K)
    pl.fold("fold_xor_cl", "pre", 2, K)
    pl.take("nor_bits", K)  # s_i nor t_i
    pl.take("cond_eq", 4 * K)
    # (inputize enc key set + ciphertext left set: no aux)
    lbs = pl.witness_points("left_bals", K)
    for i in range(K):  # C_l_i + C_i, before the folds that read them
        pl.add(f"lc_add.{i}", lbs[i], cls[i], prog="lc")
    pl.fold("fold_s_lc", "pre", 3, K)  # lh_c
    rbs = pl.witness_points("right_bals", K)
    pl.fold("fold_s_rb", "pre", 4, K)  # right_fold
    pl.take("randomness_bits.2", 252)  # second decomposition
    right_ct = pl.fixed("right_ct", 3, 252)  # r * G
    # cr_minus_d = right_fold + right_ct, from the program's input rows
    pl.add("cr_minus_d", Ins(0), Ins(1), prog="crd")
    crd_sk = pl.var("crd_sk", K)
    pl.add("rh_c", remaining_g, crd_sk)  # (eq: no aux)
    # rvk (utils.rs:71-124)
    pgk = pl.witness_point("pgk")
    pl.not_small_order("pgk.nso", pgk)
    pl.take("alpha_bits", 252)
    alpha_g = pl.fixed("alpha_g", 4, 252)
    rvk = pl.add("rvk", pgk, alpha_g)
    pl.not_small_order("rvk.nso", rvk)
    # g_epoch / nonce (utils.rs:126-154)
    gep = pl.witness_point("gep")
    nonce = pl.var("nonce", K + 1)
    # 105 public inputs (anonymous_transfer.rs:454-478) after ONE
    return pl.finish(eks + cls + lbs + rbs + [right_ct, rvk, gep, nonce])


def anonymous_chains(rows=None, *, amount_u32, remaining_u32, s_bits, t_bits,
                     dec_key_bits, randomness_bits, alpha_bits, enc_keys,
                     left_cts, left_bals, right_bals, gep, **_):
    """The witness's group arithmetic ahead of its per-step aux: the five
    fixed-base chains, program "lc" (the 12 adds C_l_i + C_i into their aux
    rows), the folds of known points, program "crd" (cr_minus_d), the 14
    variable-base chains and the folds over their results, in three
    ``fixed_chain`` launches and one ``var_chain`` launch.  Takes the dict
    of ``witness_inputs_host`` (pgk is not needed here); ``rows``: the host
    rows' writer of the witness's aux (a fresh aux if None).

    -> dict: ``fb`` (compute_fixed_base_chains), ``right_ct``, ``pre`` /
    ``post`` (the fold inputs of the two fold launches, as ``fold_group``
    takes them) with their values ``pre_values`` / ``post_values`` and
    step-job sources ``pre_sources`` / ``post_sources``, ``right_fold``,
    ``cr_minus_d``, ``vm_bases``, ``vm_bits``, ``vm``
    (compute_var_mul_chains), ``emr`` (r * enc_key_i, (8, 12, B) each)."""
    plan = anonymous_plan()
    B = dec_key_bits.shape[1]
    if rows is None:
        rows = plan.rows(new_aux(plan, B, dec_key_bits.device))
    aux = rows.aux
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

    rows.points("left_bals", *left_bals)
    rows.points("left_cts", clx, cly)
    cw.gadgets(plan.programs["lc"], aux)
    lc = plan.at["lc_add.0"] + 4  # x3, y3 of each add, 6 rows apart
    lc_x3 = aux[:, lc: lc + 6 * ANONIMITY_SIZE: 6]
    lc_y3 = aux[:, lc + 1: lc + 6 * ANONIMITY_SIZE: 6]
    pre = [
        (s_bits, ekx, eky),               # expected enc_key_sender
        (t_bits, clx, cly),               # ct_left_t
        (xor_bits, clx, cly),             # ct_left_xor
        (s_bits, lc_x3, lc_y3),           # lh_c
        (s_bits, *right_bals),            # right_fold
    ]
    pre_values, pre_sources = fold_group(pre)
    right_fold = (pre_values[4][2][:, -1], pre_values[4][3][:, -1])
    cw.gadgets(plan.programs["crd"], aux,
               torch.stack([*right_fold, *right_ct], dim=1))
    crd = plan.at["cr_minus_d"] + 4
    cr_minus_d = (aux[:, crd], aux[:, crd + 1])

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
    post_values, post_sources = fold_group(post)
    return dict(fb=fb, right_ct=right_ct, pre=pre, pre_values=pre_values,
                pre_sources=pre_sources, right_fold=right_fold,
                cr_minus_d=cr_minus_d, vm_bases=vm_bases, vm_bits=vm_bits,
                vm=vm, emr=emr, post=post, post_values=post_values,
                post_sources=post_sources)


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
    plan, aux, jobs = anonymous_setup(
        amount_u32, remaining_u32, s_bits, t_bits, dec_key_bits,
        randomness_bits, alpha_bits, enc_keys, left_cts, left_bals,
        right_bals, pgk, gep)
    cw.steps(jobs, aux)
    cw.gadgets(plan.programs["main"], aux)
    return aux, public_of(plan, aux)


def anonymous_setup(amount_u32, remaining_u32, s_bits, t_bits, dec_key_bits,
                    randomness_bits, alpha_bits, enc_keys, left_cts, left_bals,
                    right_bals, pgk, gep):
    """The witness up to its last gadget kernels (programs "lc" and "crd"
    have run): -> (plan, aux with the host rows written, the step jobs over
    the normalised chains and folds)."""
    plan = anonymous_plan()
    B = dec_key_bits.shape[1]
    dev = dec_key_bits.device
    aux = new_aux(plan, B, dev)
    rows = plan.rows(aux)
    xor_bits = torch.bitwise_xor(s_bits, t_bits)
    nor_bits = (1 - s_bits) * (1 - t_bits)

    c = anonymous_chains(rows, amount_u32=amount_u32, remaining_u32=remaining_u32,
                         s_bits=s_bits, t_bits=t_bits, dec_key_bits=dec_key_bits,
                         randomness_bits=randomness_bits, alpha_bits=alpha_bits,
                         enc_keys=enc_keys, left_cts=left_cts, left_bals=left_bals,
                         right_bals=right_bals, gep=gep)
    emrx, emry = c["emr"]

    # ---- the host rows (the chains wrote left_bals' and left_cts' points)
    rows.points("zero_p", torch.zeros((FR.n, B), dtype=torch.int32, device=dev),
                L.ones_mont(FR, (B,), dev))
    emit_u32_range(rows("amount"), amount_u32)
    emit_u32_range(rows("remaining"), remaining_u32)
    for name, bits in (("dec_key_bits", dec_key_bits), ("s_bits", s_bits),
                       ("t_bits", t_bits), ("randomness_bits", randomness_bits),
                       ("xor_bits", xor_bits), ("nor_bits", nor_bits),
                       ("randomness_bits.2", randomness_bits),
                       ("alpha_bits", alpha_bits)):
        emit_field_bits(rows(name), bits)
    for name, (x, y) in (("enc_keys", enc_keys), ("right_bals", right_bals),
                         ("pgk", pgk), ("gep", gep)):
        rows.points(name, x, y)
    _emit_cond_eq(rows("cond_eq"), nor_bits, *left_cts, emrx, emry)
    rows.check()
    return plan, aux, plan.step_jobs({
        "fb": fixed_sources(c["fb"]), "vm": var_sources(c["vm"], c["vm_bits"]),
        "pre": c["pre_sources"], "post": c["post_sources"]})


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
