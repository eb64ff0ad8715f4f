"""The bucket ('hs') MSM's two kernels through their plain versions:
``cuda_ec.bucket_sums_plain`` (the buckets of sorted digit rows) and
``cuda_ec.bucket_fold_plain`` (the running-sum fold), against the bigint
mirror and against the JAX ``Msm._window_total``.

Rows (N = 48 points, c = 4: 16 buckets): uniform digits, a heavy bucket
(more than half the row in bucket 1, as the witness's booleans give window
0), an all-zero row, a row of one key; the points have Z != 1 and include
identities, and one run holds P = Q and P = -Q.

- Mirror: every bucket is the sum of its points and the fold's total is
  sum_v v * B_v, on affine points (exact).
- JAX: ``_window_total`` (mode 'hs', its composed Hillis-Steele levels on
  the CPU) of each row gives the port's total word for word; on one-hot rows
  (1 where the row's digit is v) it gives bucket v, whose run it sums in the
  same order and association, word for word.  G1 here (XLA compiles it in
  ~20 s); G2 (~90 s) in test_torch_bucket_msm_jax.py, so that each file
  stays near a minute.

The kernels themselves run only on a card (``chip_smoke.py``); their device
code is stepped through on the CPU in test_torch_csrc_host.py."""

import numpy as np
import pytest
import torch

from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ec import cuda_ec
from zerochain_tpu_torch.ec import g1 as tg1
from zerochain_tpu_torch.ec import g2 as tg2
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.mirror import curves as cv

torch.set_num_threads(2)  # several test workers share the cores

GROUPS = {"g1": (tg1, cv.G1_GEN, cv.g1_mul, cv.g1_add, cv.g1_neg),
          "g2": (tg2, cv.G2_GEN, cv.g2_mul, cv.g2_add, cv.g2_neg)}
N, C = 48, 4
NB = 1 << C


def make_case(name):
    """Points (Z != 1; identities at 3 and 30; 5 and 6 equal, 7 their
    negated sum, 20 and 21 opposite), digit rows (M, N) and the mirror's
    affine points."""
    tg, gen, mul, add, neg = GROUPS[name]
    rng = np.random.RandomState(101)
    base = [mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(12)]
    aff = [base[int(rng.randint(0, 12))] for _ in range(N)]
    aff[3] = aff[30] = None
    aff[6] = aff[5]
    aff[7] = neg(add(aff[5], aff[5]))
    aff[20] = neg(aff[21])
    P = tg.double(tg.from_affine_host(aff, device="cpu"))  # Z != 1
    pts = [None if p is None else add(p, p) for p in aff]
    keys = rng.randint(0, NB, (4, N))
    keys[1, rng.permutation(N)[:30]] = 1                  # heavy bucket 1
    keys[2] = 0                                           # all zero
    keys[3] = 7                                           # one key
    # row 0, the run of 9 in sorted order: inf, A, A, -2A: P = Q, then
    # P = -Q (in the Hillis-Steele levels and in the kernel's slice)
    keys[0][keys[0] == 9] = 8
    keys[0, [3, 5, 6, 7]] = 9
    return tg, P, pts, torch.from_numpy(keys)


def port_buckets(tg, P, keys):
    keys_s, order = torch.sort(keys, dim=-1, stable=True)
    return cuda_ec.bucket_sums_plain(tg.F, P, keys_s.to(torch.int32),
                                     order.to(torch.int32), NB)


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_buckets_and_fold_match_the_mirror(name):
    tg, P, pts, keys = make_case(name)
    _, _, mul, add, _ = GROUPS[name]
    bk = port_buckets(tg, P, keys)
    got = tg.to_affine_host(bk)
    tot = tg.to_affine_host(cuda_ec.bucket_fold_plain(tg.F, bk))
    for m in range(keys.shape[0]):
        want_tot = None
        for v in range(NB):
            want = None
            for i in range(N):
                if keys[m, i] == v and pts[i] is not None:
                    want = add(want, pts[i])
            if v == 0:
                assert got[m * NB] is None          # bucket 0 is the identity
                continue
            assert got[m * NB + v] == want, (m, v)
            if want is not None:
                want_tot = add(want_tot, mul(want, v))
        assert tot[m] == want_tot
    assert tot[2] is None                           # the all-zero row
    assert got[9] is None                           # inf + A + A - 2A


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    tg, P, _, keys = make_case("g1")
    keys_s, order = torch.sort(keys, dim=-1, stable=True)
    ks, od = keys_s.to(torch.int32), order.to(torch.int32)
    got = cuda_ec.bucket_sums(tg.F, P, ks, od, NB)
    want = cuda_ec.bucket_sums_plain(tg.F, P, ks, od, NB)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    fold = cuda_ec.bucket_fold(tg.F, got)
    assert all(torch.equal(a, b) for a, b in
               zip(fold, cuda_ec.bucket_fold_plain(tg.F, got)))
    with pytest.raises(TypeError):
        cuda_ec.bucket_sums(tg.F, P, keys_s, od, NB)         # int64 keys
    meta = tuple(t.to("meta") for t in P)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_ec.bucket_sums(tg.F, meta, ks.to("meta"), od.to("meta"), NB)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_ec.bucket_fold(tg.F, tuple(t.to("meta") for t in got))


def _to_ref(pt):
    import jax.numpy as jnp

    def conv(c):
        return jnp.asarray(convert.to_ref_limbs(TL.FQ, c, mont=True))

    return tuple(tuple(conv(x) for x in c) if isinstance(c, tuple) else conv(c)
                 for c in pt)


def _leaves(pt):
    return [t for c in pt for t in (c if isinstance(c, tuple) else (c,))]


def check_against_jax(name):
    """The port's buckets and totals against the JAX Msm._window_total, word
    for word: each row's total, and bucket v as the total of the one-hot
    row (keys == v)."""
    import jax

    from zerochain_tpu.ec.fields import FqOps as JFq, Fq2Ops as JFq2
    from zerochain_tpu.msm import pippenger as jpip

    tg, P, _, keys = make_case(name)
    M = keys.shape[0]
    onehot = torch.stack([(keys[m] == v).to(keys.dtype)
                          for m in range(M) for v in range(1, NB)])
    rows = torch.cat([keys, onehot]).to(torch.int32)
    jmsm = jpip.Msm(JFq if name == "g1" else JFq2, c=C, n_bits=4 * C,
                    window_group=1, mode="hs")
    run = jax.jit(jax.vmap(jmsm._window_total, in_axes=(None, 0), out_axes=-1))
    want = run(_to_ref(P), np.asarray(rows.numpy()))
    want = convert.points_from_ref(
        tuple(tuple(np.asarray(t) for t in c) if isinstance(c, tuple)
              else np.asarray(c) for c in want))

    bk = port_buckets(tg, P, keys)
    tot = cuda_ec.bucket_fold_plain(tg.F, bk)
    for g, w in zip(_leaves(tot), _leaves(want)):
        assert torch.equal(g, w[:, :M])
    for g, w in zip(_leaves(bk), _leaves(want)):
        assert torch.equal(g[:, :, 1:].reshape(12, -1), w[:, M:])


def test_g1_matches_the_jax_window_total():
    check_against_jax("g1")


def test_msm_rows_in_one_pass_give_the_grouped_msm():
    """The Msm (every window's rows sorted at once by Msm.rows, one
    bucket_sums, one bucket_fold, the Horner combine) gives the words of the
    same plain versions run a window at a time, as the JAX Msm groups its
    windows, and the mirror's points."""
    from zerochain_tpu_torch.ec.fields import FqOps
    from zerochain_tpu_torch.msm import pippenger as pip

    tg, P, pts, _ = make_case("g1")
    rng = np.random.RandomState(103)
    scal = [[int(rng.randint(0, 1 << 16)) for _ in range(N)] for _ in range(3)]
    bits = torch.stack([pip.scalars_to_bits(s, 16, "cpu") for s in scal], -1)
    msm = pip.Msm(FqOps, c=C, n_bits=16)
    one = msm(P, bits)
    digits = pip.digits_from_bits(bits, C, msm.n_windows)      # (nw, N, 3)
    totals = []
    for w in range(msm.n_windows):
        keys_s, order = torch.sort(digits[w].T.to(torch.int32), dim=-1,
                                   stable=True)
        bk = cuda_ec.bucket_sums_plain(FqOps, P, keys_s,
                                       order.to(torch.int32), NB)
        totals.append(cuda_ec.bucket_fold_plain(FqOps, bk))
    grouped = cuda_ec.horner_plain(
        FqOps, tuple(torch.stack(c, 1) for c in zip(*totals)), C)
    assert all(torch.equal(a, b) for a, b in zip(one, grouped))
    want = []
    for s in scal:
        acc = None
        for p, k in zip(pts, s):
            if p is not None and k:
                acc = cv.g1_add(acc, cv.g1_mul(p, k))
        want.append(acc)
    assert tg.to_affine_host(one) == want
