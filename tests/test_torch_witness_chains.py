"""The witness stage's chain kernels and field inverse (ec/cuda_jubjub.py,
ff/cuda_ff.py: inv) against the bigint mirror and the JAX package.

``var_chain_plain`` / ``fixed_chain_plain`` are the plain versions of the
one-launch Jubjub chains: after normalisation every recorded point must be
the mirror's (the running double-and-add, or the running sum of the window
points).  ``inv_plain`` is the plain version of ``zc_ff_inv``: it must give
the JAX ``batch_inv_mont``'s words (through ``convert``, since the two
packages' Fr Montgomery radices differ) with zeros and ones planted.  The
wrappers take the plain versions on CPU tensors and refuse other devices;
the witness routes every chain group and batched inversion through one
wrapper call.  All comparisons are exact (tolerance 0); the kernels
themselves run on the card (``chip_smoke.py``), and their per-thread bodies
on the host build (``test_torch_csrc_host.py``)."""

import numpy as np
import pytest
import torch

from zerochain_tpu_torch import convert
from zerochain_tpu_torch.ec import cuda_jubjub
from zerochain_tpu_torch.ec import jubjub as tej
from zerochain_tpu_torch.ff import cuda_ff
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.mirror import jubjub as mjj
from zerochain_tpu_torch.prover import witness as twit

torch.set_num_threads(2)  # several test workers share the cores

FR = TL.FR


def _points(rng, n):
    gen = mjj.generator(mjj.NOTE_COMMITMENT_RANDOMNESS)
    return [mjj.mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(n)]


def _affine(xyz):
    """(3, 8, k, *lanes) -> per lane, the list of k affine int points."""
    x, y = twit._normalize_stack(xyz)
    k = x.shape[1]
    xs = FR.to_ints(x.movedim(1, -1).reshape(FR.n, -1), mont=True)
    ys = FR.to_ints(y.movedim(1, -1).reshape(FR.n, -1), mont=True)
    pts = list(zip(xs, ys))
    return [pts[i * k:(i + 1) * k] for i in range(len(pts) // k)]


@pytest.mark.parametrize("n_bits", [32, 252])
def test_var_chain_plain_against_the_mirror(n_bits):
    C, B = 5, 3
    rng = np.random.RandomState(97 + n_bits)
    pts = _points(rng, C * B)
    x, y = twit.affine_mont_host(pts, "cpu")
    bits = torch.from_numpy(rng.randint(0, 2, (n_bits, C, B))).to(torch.int64)
    bits[:, 0, 0] = 0
    bits[:, 2, 1] = 1
    cur, res = cuda_jubjub.var_chain_plain(
        (x.reshape(FR.n, C, B), y.reshape(FR.n, C, B)), bits)
    assert cur.shape == res.shape == (3, FR.n, n_bits, C, B)
    got_cur, got_res = _affine(cur), _affine(res)
    flat_bits = bits.reshape(n_bits, -1)
    for lane, base in enumerate(pts):
        c, r = base, mjj.ZERO
        want_cur, want_res = [], []
        for i in range(n_bits):
            if flat_bits[i, lane]:
                r = mjj.add(r, c)
            want_cur.append(c)
            want_res.append(r)
            c = mjj.double(c)
        assert got_cur[lane] == want_cur
        assert got_res[lane] == want_res
        scalar = sum(int(flat_bits[i, lane]) << i for i in range(n_bits))
        assert got_res[lane][-1] == mjj.mul(base, scalar)


def test_fixed_chain_plain_against_the_mirror():
    nc, B, nw = 2, 3, 84
    rng = np.random.RandomState(101)
    digits = torch.from_numpy(rng.randint(0, 8, (nw, nc, B))).to(torch.int64)
    digits[:, 1, 2] = 0
    tx, ty = twit._table_mont("cpu")
    flat = (digits + 8 * torch.arange(nw).reshape(nw, 1, 1)).reshape(-1)
    lx = tx.index_select(1, flat).reshape(FR.n, nw, nc, B)
    ly = ty.index_select(1, flat).reshape(FR.n, nw, nc, B)
    out = cuda_jubjub.fixed_chain_plain(lx, ly)
    assert out.shape == (3, FR.n, nw - 1, nc, B)
    got = _affine(out)
    table = mjj.fixed_base_circuit_generators(mjj.NOTE_COMMITMENT_RANDOMNESS)
    for lane in range(nc * B):
        ch, b = divmod(lane, B)
        acc = table[0][int(digits[0, ch, b])]
        want = []
        for w in range(1, nw):
            acc = mjj.add(acc, table[w][int(digits[w, ch, b])])
            want.append(acc)
        assert got[lane] == want


def _planted(p, seed, n=45):
    rng = np.random.RandomState(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n)]
    vals[0] = vals[7] = vals[30] = 0
    vals[1] = vals[20] = 1
    vals[2] = p - 1
    return vals


@pytest.mark.parametrize("name", ["Fq", "Fr", "Fs"])
def test_inv_plain_against_the_mirror(name):
    spec = {"Fq": TL.FQ, "Fr": TL.FR, "Fs": TL.FS}[name]
    p = spec.p
    vals = _planted(p, 103)
    got = cuda_ff.inv_plain(spec, spec.array(vals, "cpu", mont=True))
    assert spec.to_ints(got, mont=True) == [pow(v, -1, p) if v else 0 for v in vals]
    # any batch shape: the inverse is elementwise
    grid = spec.array(vals[:44], "cpu", mont=True).reshape(spec.n, 4, 11)
    assert torch.equal(cuda_ff.inv(spec, grid), got[:, :44].reshape(spec.n, 4, 11))
    assert torch.equal(TL.batch_inv_mont(spec, grid, axis=1), cuda_ff.inv(spec, grid))
    assert torch.equal(TL.inv_mont(spec, got), spec.array(
        [v % p for v in vals], "cpu", mont=True))


def test_inv_plain_matches_jax():
    """Fr, where the packages' Montgomery radices differ (2^256, 2^264)."""
    from zerochain_tpu.ff import limbs as JL

    vals = _planted(FR.p, 105)
    got = cuda_ff.inv_plain(FR, FR.array(vals, "cpu", mont=True))
    want = JL.batch_inv_mont(JL.FR, JL.to_limbs(JL.FR, vals, mont=True), axis=1)
    assert torch.equal(got, convert.from_ref_limbs(FR, np.asarray(want), mont=True))


def test_wrappers_route_and_refuse():
    rng = np.random.RandomState(107)
    x, y = twit.affine_mont_host(_points(rng, 4), "cpu")
    bases = (x.reshape(FR.n, 2, 2), y.reshape(FR.n, 2, 2))
    bits = torch.from_numpy(rng.randint(0, 2, (6, 2, 2)))
    for a, b in zip(cuda_jubjub.var_chain(bases, bits),
                    cuda_jubjub.var_chain_plain(bases, bits)):
        assert torch.equal(a, b)
    lx = x.reshape(FR.n, 2, 2)
    ly = y.reshape(FR.n, 2, 2)
    assert torch.equal(cuda_jubjub.fixed_chain(lx, ly),
                       cuda_jubjub.fixed_chain_plain(lx, ly))
    assert all(v == 0 for v in cuda_jubjub.launches.values())
    meta = tuple(t.to("meta") for t in bases)
    with pytest.raises(ValueError):
        cuda_jubjub.var_chain(meta, bits.to("meta"))
    with pytest.raises(ValueError):
        cuda_jubjub.fixed_chain(lx.to("meta"), ly.to("meta"))
    with pytest.raises(ValueError):
        cuda_ff.inv(FR, x.to("meta"))
    with pytest.raises(TypeError):
        cuda_jubjub.var_chain((bases[0].to(torch.int64), bases[1]), bits)
    with pytest.raises(ValueError):
        cuda_jubjub.var_chain(bases, bits[:, :1])
    with pytest.raises(ValueError):
        cuda_jubjub.fixed_chain(lx[:, :1], ly[:, :1])
    with pytest.raises(ValueError):
        cuda_ff.inv(FR, x[:4])


def test_witness_calls_each_wrapper_once(monkeypatch):
    """compute_var_mul_chains / compute_fixed_base_chains make one chain call
    each, and each of their normalisations one inverse call: the launches
    the card makes for them."""
    calls = {"var_chain": 0, "fixed_chain": 0, "inv": 0}

    def counted(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    for name in ("var_chain", "fixed_chain"):
        monkeypatch.setattr(cuda_jubjub, name, counted(name, getattr(cuda_jubjub, name)))
    monkeypatch.setattr(cuda_ff, "inv", counted("inv", cuda_ff.inv))
    rng = np.random.RandomState(109)
    bits = torch.from_numpy(rng.randint(0, 2, (8, 2)))
    twit.compute_fixed_base_chains([bits, bits.flip(0)])
    assert calls == {"var_chain": 0, "fixed_chain": 1, "inv": 1}
    x, y = twit.affine_mont_host(_points(rng, 4), "cpu")
    vm = twit.compute_var_mul_chains(
        (x.reshape(FR.n, 2, 2), y.reshape(FR.n, 2, 2)),
        torch.from_numpy(rng.randint(0, 2, (5, 2, 2))))
    assert calls == {"var_chain": 1, "fixed_chain": 1, "inv": 3}
    assert vm["cur_x"].shape == (FR.n, 5, 2, 2)
    want = tej.to_affine_host(tej.double(tej.to_extended(
        [(a, b) for a, b in zip(FR.to_ints(x, mont=True), FR.to_ints(y, mont=True))],
        device="cpu")))
    got = list(zip(FR.to_ints(vm["cur_x"][:, 1].reshape(FR.n, -1), mont=True),
                   FR.to_ints(vm["cur_y"][:, 1].reshape(FR.n, -1), mont=True)))
    assert got == want
