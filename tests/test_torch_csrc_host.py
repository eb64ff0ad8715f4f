"""The port's CUDA device code, compiled as plain C++ and held against the
plain PyTorch versions.

``zerochain_tpu_torch/csrc/*.cuh`` and the per-thread steps of
``totals_kernel.cu`` and ``column_scan_kernel.cu`` are written so that they
also build with a host compiler (the carry-chain instructions of the field
multiply emulated on a carry flag in a variable: the same instruction
sequence).  This file builds ``tests/torch_csrc_host_check.cpp`` with ``g++``
and feeds it the same inputs as the plain versions: field ops and point
add/double/mixed-add word for word, the lazy Fq values of the curve
formulas (operands in [0, 2p)) and the point ops on such operands, ``window_totals`` (each row's threads
stepped through in order and summed as the kernel sums them) after
``normalize``, ``column_scan`` (every lane stepped through) word for word,
the two kernels of ``split_tail_kernel.cu`` (the lane pass lane by lane,
word for word; the tail's threads phase by phase and level by level, after
``normalize``),
the bucket sums of ``hs_kernel.cu`` (each row's threads stepped through
phase by phase: fill, slices, merge of the slices' edge pieces) after
``normalize``, the chain programs of ``group_program.cuh`` (the ladder, the
Horner combine and the bucket fold, one lane a group) word for word, and the witness stage's kernels
word for word: the Fermat inverse of ``ff_kernels.cu``, the Edwards add and
double of ``edwards.cuh`` and the per-lane Jubjub chains of
``jubjub_kernels.cu``.  All comparisons are exact
(tolerance 0).  The kernels themselves run only on a card, where
``chip_smoke.py`` checks them; this covers their arithmetic and control flow
where there is none."""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from zerochain_tpu_torch.ec import cuda_ec
from zerochain_tpu_torch.ec import cuda_jubjub
from zerochain_tpu_torch.ec import g1 as tg1
from zerochain_tpu_torch.ec import g2 as tg2
from zerochain_tpu_torch.ec import jubjub as tej
from zerochain_tpu_torch.ff import cuda_ff
from zerochain_tpu_torch.ff import limbs as TL
from zerochain_tpu_torch.mirror import curves as cv
from zerochain_tpu_torch.mirror import jubjub as mjj
from zerochain_tpu_torch.mirror.field import R
from zerochain_tpu_torch.msm import cuda_scan
from zerochain_tpu_torch.msm.suffix import SuffixMsm
from zerochain_tpu_torch.prover import witness as twit

torch.set_num_threads(2)  # several test workers share the cores

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "zerochain_tpu_torch" / "csrc"
GROUPS = {"g1": (tg1, cv.G1_GEN, cv.g1_mul, cv.g1_neg),
          "g2": (tg2, cv.G2_GEN, cv.g2_mul, cv.g2_neg)}


@pytest.fixture(scope="module")
def host_bin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the device code cannot be built for the host")
    out = tmp_path_factory.mktemp("csrc_host") / "host_check"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-x", "c++", "-I", str(CSRC), "-o", str(out),
         str(ROOT / "tests" / "torch_csrc_host_check.cpp")],
        check=True, capture_output=True, text=True, timeout=600)
    return str(out)


def _run(host_bin, text):
    out = subprocess.run([host_bin], input=text, capture_output=True,
                         text=True, timeout=600, check=True)
    return [line.split() for line in out.stdout.strip().split("\n")]


def _hex(t):
    return " ".join("%08x" % (int(x) & 0xFFFFFFFF) for x in t.reshape(-1).tolist())


@pytest.mark.parametrize("name", ["fq", "fr", "fs"])
def test_field_ops(host_bin, name):
    spec = {"fq": TL.FQ, "fr": TL.FR, "fs": TL.FS}[name]
    rng = np.random.RandomState(41)
    p = spec.p
    edge = [0, 1, p - 1, p - 2, (1 << 32) - 1]
    vals_a = edge + [int.from_bytes(rng.bytes(48), "little") % p for _ in range(40)]
    vals_b = edge[::-1] + [int.from_bytes(rng.bytes(48), "little") % p for _ in range(40)]
    a = spec.array(vals_a, "cpu")
    b = spec.array(vals_b, "cpu")
    text = "\n".join(f"{name} {_hex(a[:, i])} {_hex(b[:, i])}"
                     for i in range(len(vals_a)))
    got = _run(host_bin, text)
    want = []
    mul, add, sub = (cuda_ff.mont_mul_plain(spec, a, b),
                     cuda_ff.add_plain(spec, a, b), cuda_ff.sub_plain(spec, a, b))
    for i in range(len(vals_a)):
        want += [_hex(mul[:, i]).split(), _hex(add[:, i]).split(),
                 _hex(sub[:, i]).split()]
    assert got == want


def _points(name, rng, n):
    tg, gen, mul, neg = GROUPS[name]
    base = [mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(6)]
    return tg, neg, [base[int(rng.randint(0, 6))] for _ in range(n)]


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_point_ops(host_bin, name):
    tg, neg, pts = _points(name, np.random.RandomState(43), 6)
    F = tg.F
    # generic, P = Q, P = -Q, P = inf, Q = inf, both inf; p is 2P (Z != 1)
    ps = [pts[0], pts[1], pts[2], None, pts[3], None]
    qs = [pts[4], None, None, pts[0], None, None]
    p = tg.double(tg.from_affine_host(ps, device="cpu"))
    two = tg.to_affine_host(p)
    qs[1], qs[2] = two[1], neg(two[2])
    q = tg.from_affine_host(qs, device="cpu")

    def col(pt, i):
        return " ".join(_hex(pl[:, i]) for pl in cuda_ec._planes(F, pt))

    got = _run(host_bin, "\n".join(
        f"{name} {col(p, i)} {col(q, i)}" for i in range(6)))
    add = cuda_ec.add_plain(F, p, q)
    dbl = cuda_ec.double_plain(F, p)
    want = []
    for i in range(6):
        want += [col(add, i).split(), col(dbl, i).split(),
                 col(add, i).split(), col(add, i).split()]
    assert got == want


def _fq_words(v):
    return " ".join("%08x" % ((v >> (32 * i)) & 0xFFFFFFFF) for i in range(12))


def _fq_int(words):
    return sum(int(w, 16) << (32 * i) for i, w in enumerate(words))


@pytest.mark.parametrize("case", ["edges", "random", "difference_p"])
def test_field_lazy(host_bin, case):
    """The lazy Fq values of the curve formulas (field.cuh): operands
    anywhere in [0, 2p); a * b, a + b, a - b and -a must lie in [0, 2p) and
    be congruent to the mirror's result, canonicalise to it word for word,
    and the zero test must see 0 and p alike."""
    p = TL.FQ.p
    r_inv = pow(1 << 384, -1, p)
    rng = np.random.RandomState(61)
    if case == "edges":
        edge = [0, 1, p - 1, p, p + 1, 2 * p - 1, p - 2, 2 * p - 2]
        pairs = [(a, b) for a in edge for b in edge]
    elif case == "random":
        pairs = [(int.from_bytes(rng.bytes(48), "little") % (2 * p),
                  int.from_bytes(rng.bytes(48), "little") % (2 * p)) for _ in range(64)]
    else:  # a - b = p before canonicalisation, and a = b in other words
        bs = [0, 1, 5, p - 1] + [int.from_bytes(rng.bytes(48), "little") % p
                                 for _ in range(12)]
        pairs = [(b + p, b) for b in bs] + [(b, b + p) for b in bs]
    got = _run(host_bin, "\n".join(f"fql {_fq_words(a)} {_fq_words(b)}"
                                    for a, b in pairs))
    assert len(got) == 9 * len(pairs)
    for i, (a, b) in enumerate(pairs):
        lines = got[9 * i:9 * i + 9]
        want = [a * b * r_inv % p, (a + b) % p, (a - b) % p, -a % p]
        for k in range(4):
            raw, canon = _fq_int(lines[k]), _fq_int(lines[4 + k])
            assert raw < 2 * p and raw % p == want[k], (case, i, k)
            assert canon == want[k], (case, i, k)
        assert lines[8] == [str(int(a % p == 0)), str(int((a - b) % p == 0))]


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_point_ops_lazy(host_bin, name):
    """add, double and madd on points whose every coordinate component
    arrives as its value plus p (in [p, 2p), the zeros as p): a generic
    pair, P = Q and P = -Q, and the identity on either side, must give the
    plain versions' canonical words on the canonical inputs."""
    tg, neg, pts = _points(name, np.random.RandomState(67), 6)
    F = tg.F
    fp = TL.FQ.p
    ps = [pts[0], pts[1], pts[2], None, pts[3]]
    qs = [pts[4], None, None, pts[5], None]
    p = tg.double(tg.from_affine_host(ps, device="cpu"))
    two = tg.to_affine_host(p)
    qs[1], qs[2] = two[1], neg(two[2])
    q = tg.from_affine_host(qs, device="cpu")

    def col(pt, i):
        return " ".join(_hex(pl[:, i]) for pl in cuda_ec._planes(F, pt))

    def lifted(pt, i):
        return " ".join(_fq_words(_fq_int(_hex(pl[:, i]).split()) + fp)
                        for pl in cuda_ec._planes(F, pt))

    got = _run(host_bin, "\n".join(
        f"{name} {lifted(p, i)} {lifted(q, i)}" for i in range(5)))
    add = cuda_ec.add_plain(F, p, q)
    dbl = cuda_ec.double_plain(F, p)
    want = []
    for i in range(5):
        want += [col(add, i).split(), col(dbl, i).split(),
                 col(add, i).split(), col(add, i).split()]
    assert got == want


def _outs(name, lines, lead):
    outs = []
    for line in lines:
        w = torch.tensor([int(x, 16) for x in line], dtype=torch.int64)
        outs.append(((w << 32) >> 32).to(torch.int32).reshape(12, *lead))
    if name == "g1":
        return tuple(outs)
    return tuple((outs[2 * k], outs[2 * k + 1]) for k in range(3))


def _k3(host_bin, name, P, sd, od, T, min_run):
    """The host build's window totals: T threads a row (0: the kernel's
    plan), min_run non-zero digits a thread before a row takes more warps."""
    N = od.shape[-1]
    M = sd.numel() // N
    nb = int(sd.abs().max()) + 1 if sd.numel() else 2
    text = f"k3 {int(name == 'g2')} {N} {M} {max(nb, 2)} {T} {min_run}\n"
    text += "\n".join(_hex(pl) for pl in cuda_ec._planes(GROUPS[name][0].F, P)) + "\n"
    text += " ".join(map(str, sd.reshape(-1).tolist())) + "\n"
    text += " ".join(map(str, od.reshape(-1).tolist())) + "\n"
    return _outs(name, _run(host_bin, text), sd.shape[:-1])


@pytest.mark.parametrize("dist", ["uniform", "zero_heavy"])
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_window_totals_steps(host_bin, name, dist):
    N, B = 64, 2
    rng = np.random.RandomState(47)
    tg, neg, pts = _points(name, rng, N)
    F = tg.F
    pts[3] = None
    pts[10] = pts[11]
    pts[20] = neg(pts[21])
    P = tg.from_affine_host(pts, device="cpu")
    msm = SuffixMsm(F, c=8, n_bits=24, signed=True)
    if dist == "uniform":
        scal = [[int(rng.randint(0, 1 << 24)) for _ in range(N)] for _ in range(B)]
    else:
        scal = [[int(rng.choice([0, 0, 0, 1, 1, int(rng.randint(0, 1 << 24))]))
                 for _ in range(N)] for _ in range(B)]
    scal[0][10] = scal[0][11] = 5
    scal[0][20] = scal[0][21] = 7
    words = torch.stack([TL.FR.array([s % R for s in row], "cpu") for row in scal], dim=-1)
    sd, od = msm.prep(msm.digits(words))
    # one non-zero digit a thread at least: the rows take one or two warps;
    # the cases at the head of a thread's slice: P = Q, then P = -Q
    nnz = int((sd[0, 0] != 0).sum())
    run = -(-nnz // cuda_scan.row_threads(nnz, 1))
    od[..., 1] = od[..., 0]
    sd[..., 1] = sd[..., 0]
    od[..., run + 1] = od[..., run]
    sd[..., run + 1] = -sd[..., run]
    want = cuda_scan.window_totals_plain(F, P, sd, od, msm.nb)
    got = _k3(host_bin, name, P, sd, od, 0, 1)
    assert tg.to_affine_host(got) == tg.to_affine_host(want)


@pytest.mark.parametrize("T", [0, 1, 4, 32, 128])
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_window_totals_thread_counts(host_bin, name, T):
    """Fixed thread counts and the kernel's own plan (T = 0) on hand-made
    sorted rows: uniform magnitudes, all zero, fewer non-zero digits than
    threads, and drops greater than one at the ends of the slices."""
    N = 64
    rng = np.random.RandomState(59)
    tg, neg, pts = _points(name, rng, N)
    F = tg.F
    pts[5] = None
    P = tg.from_affine_host(pts, device="cpu")
    rows = []
    mags = sorted(rng.randint(1, 129, N).tolist(), reverse=True)
    rows.append(mags)                                    # uniform, no zero
    rows.append([0] * N)                                 # all zero
    rows.append([3, 2, 2] + [0] * (N - 3))               # fewer than the threads
    # 16 non-zero digits: at T = 4 slices of 4 ending in 50 | 40 | 9 | 2
    # whose next heads are 40, 9 and 2 (drops of 10, 31, 7 and the last 2)
    rows.append([100, 100, 90, 50, 40, 40, 39, 40 - 30, 9, 9, 9, 9, 6, 5, 4, 2]
                + [0] * (N - 16))
    rows[3][7] = 40 - 30
    rows[3] = sorted(rows[3], reverse=True)
    sd = torch.tensor(rows, dtype=torch.int32)
    sd = torch.where(torch.from_numpy(rng.rand(*sd.shape) < 0.4), -sd, sd)
    od = torch.stack([torch.from_numpy(rng.permutation(N)) for _ in rows]).to(torch.int32)
    od[0, 1] = od[0, 0]                                  # P = Q in the first slice
    sd[0, 1] = sd[0, 0]
    want = cuda_scan.window_totals_plain(F, P, sd, od, 129)
    got = _k3(host_bin, name, P, sd, od, T, 2)
    assert tg.to_affine_host(got) == tg.to_affine_host(want)


def _jac_points(name, rng, n):
    """n Jacobian points with Z != 1 (doubled affine points)."""
    tg, neg, pts = _points(name, rng, n)
    return tg, neg, pts, tg.double(tg.from_affine_host(pts, device="cpu"))


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_chain_ladder_one_lane(host_bin, name):
    """The ladder program on one lane a point: a general base, the identity
    as base, all-zero and all-one bits; the words of ladder_plain."""
    n_bits, count = 12, 4
    rng = np.random.RandomState(61)
    tg, _, _, base = _jac_points(name, rng, count)
    F = tg.F
    for c in F.leaves(base[2]):                           # point 1: identity
        c[:, 1] = 0
    bits = torch.from_numpy(rng.randint(0, 2, (n_bits, count))).to(torch.int32)
    bits[:, 2] = 0
    bits[:, 3] = 1
    want = cuda_ec.ladder_plain(F, base, bits)
    text = f"lad {int(name == 'g2')} {n_bits} {count}\n"
    text += "\n".join(_hex(pl) for pl in cuda_ec._planes(F, base)) + "\n"
    text += " ".join(map(str, bits.reshape(-1).tolist())) + "\n"
    got = _run(host_bin, text)
    assert got == [_hex(pl).split() for pl in cuda_ec._planes(F, want)]
    assert tg.to_affine_host(want)[1] is None


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_chain_horner_one_lane(host_bin, name):
    """The Horner program on one lane a point, nw = 4, c = 3: general
    windows, a window equal to 2^c times the running result (the add
    doubles), its negative (the add gives the identity), identities."""
    nw, c, count = 4, 3, 5
    rng = np.random.RandomState(67)
    tg, neg, pts, jac = _jac_points(name, rng, nw * count)
    F = tg.F
    tot = tuple(tuple(x.reshape(12, nw, count) for x in co) if isinstance(co, tuple)
                else co.reshape(12, nw, count) for co in jac)
    top = tuple(F.map(lambda a: a[:, nw - 1].clone(), co) for co in tot)
    dbl = top
    for _ in range(c):
        dbl = cuda_ec.double_plain(F, dbl)
    ndbl = (dbl[0], F.plain.neg(dbl[1]), dbl[2])
    for co, d, nd in zip(tot, dbl, ndbl):                 # window nw - 2
        for leaf, dl, nl in zip(F.leaves(co), F.leaves(d), F.leaves(nd)):
            leaf[:, nw - 2, 0] = dl[:, 0]                 # point 0: P = Q
            leaf[:, nw - 2, 1] = nl[:, 1]                 # point 1: P = -Q
    for leaf in F.leaves(tot[2]):
        leaf[:, 0, 2] = 0                                 # point 2: T_0 = inf
        leaf[:, nw - 1, 3] = 0                            # point 3: T_top = inf
    want = cuda_ec.horner_plain(F, tot, c)
    text = f"hor {int(name == 'g2')} {nw} {c} {count}\n"
    text += "\n".join(_hex(pl) for pl in cuda_ec._planes(F, tot)) + "\n"
    got = _run(host_bin, text)
    assert got == [_hex(pl).split() for pl in cuda_ec._planes(F, want)]


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_column_scan_lanes(host_bin, name):
    """Every lane of two programs at T = 2, with padding points, P + P and
    P + (-P) down a lane: the kernel's steps give the plain version's words."""
    M, T, VL = 2, 2, cuda_scan.VL
    rng = np.random.RandomState(53)
    tg, neg, pts = _points(name, rng, M * T * VL)
    F = tg.F
    pts[7] = None                       # program 0, lane 7, t = 0: padding
    pts[VL + 8] = None                  # t = 1 of lane 8
    pts[VL + 9] = pts[9]                # P + P
    pts[VL + 10] = neg(pts[10])         # P + (-P)
    P = tg.from_affine_host(pts, device="cpu")
    P = tuple(tuple(x.reshape(12, M, T * VL) for x in c) if isinstance(c, tuple)
              else c.reshape(12, M, T * VL) for c in P)
    want = cuda_scan.column_scan_plain(F, P)
    planes = cuda_ec._planes(F, P)
    text = f"cs {int(name == 'g2')} {M} {T}\n"
    text += "\n".join(_hex(pl) for pl in planes) + "\n"
    lines = _run(host_bin, text)
    assert lines == [_hex(pl).split() for pl in cuda_ec._planes(F, want)]


@pytest.mark.parametrize("name", ["fq", "fr", "fs"])
def test_field_inverse(host_bin, name):
    """The one-thread Fermat power of zc_ff_inv against inv_plain (the
    Montgomery trick), with zeros and ones planted among random elements."""
    spec = {"fq": TL.FQ, "fr": TL.FR, "fs": TL.FS}[name]
    rng = np.random.RandomState(71)
    p = spec.p
    vals = [0, 1, p - 1, 2, 0, spec.r_mod_p, 1, 0]
    vals += [int.from_bytes(rng.bytes(48), "little") % p for _ in range(24)]
    a = spec.array(vals, "cpu")
    got = _run(host_bin, "\n".join(f"{name}i {_hex(a[:, i])}" for i in range(len(vals))))
    want = cuda_ff.inv_plain(spec, a)
    assert got == [_hex(want[:, i]).split() for i in range(len(vals))]
    ints = spec.to_ints(want, mont=True)
    assert all((v * w - 1) % p == 0 if v % p else w == 0
               for v, w in zip(spec.to_ints(a, mont=True), ints))


def _jubjub_points(rng, n):
    gen = mjj.generator(mjj.NOTE_COMMITMENT_RANDOMNESS)
    base = [mjj.mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(6)]
    return [base[int(rng.randint(0, 6))] for _ in range(n)]


def _ext_col(pt, i):
    return " ".join(_hex(c[:, i]) for c in pt)


def test_edwards_ops(host_bin):
    """edwards.cuh's add and double (and add in place) against ec/jubjub.py's
    on the plain field ops: general points with Z != 1, P = Q, P = -Q and the
    identity on either side."""
    rng = np.random.RandomState(73)
    pts = _jubjub_points(rng, 6)
    qts = _jubjub_points(rng, 6)
    qts[1] = pts[1]
    qts[2] = mjj.neg(pts[2])
    pts[3] = mjj.ZERO
    qts[4] = mjj.ZERO
    ops = tej.PLAIN_OPS
    p = tej.double(tej.to_extended(pts, device="cpu"), ops)  # Z != 1
    q = tej.double(tej.to_extended(qts, device="cpu"), ops)
    got = _run(host_bin, "\n".join(f"jj {_ext_col(p, i)} {_ext_col(q, i)}"
                                    for i in range(6)))
    add, dbl = tej.add(p, q, ops), tej.double(p, ops)
    want = []
    for i in range(6):
        want += [_ext_col(add, i).split(), _ext_col(dbl, i).split(),
                 _ext_col(add, i).split()]
    assert got == want


def _words_of(line, shape):
    w = torch.tensor([int(x, 16) for x in line], dtype=torch.int64)
    return ((w << 32) >> 32).to(torch.int32).reshape(shape)


@pytest.mark.parametrize("n_bits", [252, 32])
def test_jubjub_var_chain_lanes(host_bin, n_bits):
    """jj_var_lane on every lane of C = 5 chains x B = 3 proofs against
    var_chain_plain, word for word: seeded bits with an all-zero and an
    all-one lane, an all-zero and an all-one step, and the identity as one
    base."""
    C, B = 5, 3
    rng = np.random.RandomState(79 + n_bits)
    pts = _jubjub_points(rng, C * B)
    pts[7] = mjj.ZERO
    x, y = twit.affine_mont_host(pts, "cpu")
    bases = (x.reshape(8, C, B), y.reshape(8, C, B))
    bits = torch.from_numpy(rng.randint(0, 2, (n_bits, C, B))).to(torch.int64)
    bits[:, 0, 0] = 0
    bits[:, 1, 2] = 1
    bits[3] = 0
    bits[5] = 1
    want_cur, want_res = cuda_jubjub.var_chain_plain(bases, bits)
    text = f"jvar {n_bits} {C * B}\n{_hex(bases[0])}\n{_hex(bases[1])}\n"
    text += " ".join(map(str, bits.reshape(-1).tolist())) + "\n"
    cur, res = _run(host_bin, text)
    assert torch.equal(_words_of(cur, want_cur.shape), want_cur)
    assert torch.equal(_words_of(res, want_res.shape), want_res)


def test_jubjub_fixed_chain_lanes(host_bin):
    """jj_fixed_lane on 6 chains x 3 proofs of window points looked up as the
    witness looks them up (digit 0 planted on whole chains) against
    fixed_chain_plain, word for word."""
    nc, B, nw = 6, 3, 84
    rng = np.random.RandomState(83)
    digits = torch.from_numpy(rng.randint(0, 8, (nw, nc, B))).to(torch.int64)
    digits[:, 0, 1] = 0
    digits[:, 4, 2] = 7
    tx, ty = twit._table_mont("cpu")
    flat = (digits + 8 * torch.arange(nw).reshape(nw, 1, 1)).reshape(-1)
    lx = tx.index_select(1, flat).reshape(8, nw, nc, B)
    ly = ty.index_select(1, flat).reshape(8, nw, nc, B)
    want = cuda_jubjub.fixed_chain_plain(lx, ly)
    (got,) = _run(host_bin, f"jfix {nw} {nc * B}\n{_hex(lx)}\n{_hex(ly)}\n")
    assert torch.equal(_words_of(got, want.shape), want)


def _bucket_rows(rng, N, nb):
    """Sorted digit rows for the bucket sums: uniform, all zero, one key,
    a heavy bucket (more than half the row in bucket 1), and runs laid on
    the slices of T = 4 and 8 (16 zeros, then runs of 12, 12, 6, 12, 6:
    exactly one or two slices, starting at a slice's first position or
    crossing a slice's end)."""
    assert N == 64
    rows = [sorted(rng.randint(0, nb, N).tolist()),
            [0] * N,
            [5] * N,
            sorted([1] * 40 + rng.randint(0, nb, N - 40).tolist()),
            [0] * 16 + [2] * 12 + [3] * 12 + [4] * 6 + [6] * 12 + [9] * 6]
    return torch.tensor(rows, dtype=torch.int32)


@pytest.mark.parametrize("T", [1, 3, 4, 8, 128])
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_bucket_sums_threads(host_bin, name, T):
    """zc_hs_bucket_sums stepped through with T threads a row (slices of 64
    down to 1 digit, and more threads than digits), on points with Z != 1,
    against bucket_sums_plain after normalisation.  Inside runs: P = Q
    (one point twice), P = -Q and identity points, also at a run's head
    where a slice's edge piece is the identity."""
    N, nb = 64, 16
    rng = np.random.RandomState(89)
    tg, neg, pts, _ = _jac_points(name, rng, N)
    pts[3] = None
    pts[20] = neg(pts[21])
    P = tg.double(tg.from_affine_host(pts, device="cpu"))   # Z != 1
    keys = _bucket_rows(rng, N, nb)
    M = keys.shape[0]
    order = torch.stack([torch.from_numpy(rng.permutation(N)) for _ in range(M)]).to(torch.int32)
    # row 4, run of 3s at 28..39: P = Q at its head, then P = -Q, then an
    # identity; row 3's heavy bucket: P = -Q at its head (the identity)
    order[4, 28:33] = torch.tensor([7, 7, 20, 21, 3], dtype=torch.int32)
    head = int((keys[3] == 1).nonzero()[0])
    order[3, head: head + 2] = torch.tensor([20, 21], dtype=torch.int32)
    order[0, 10:12] = order[0, 9]
    want = cuda_ec.bucket_sums_plain(tg.F, P, keys, order, nb)
    text = f"bs {int(name == 'g2')} {N} {M} {nb} {T}\n"
    text += "\n".join(_hex(pl) for pl in cuda_ec._planes(tg.F, P)) + "\n"
    text += " ".join(map(str, keys.reshape(-1).tolist())) + "\n"
    text += " ".join(map(str, order.reshape(-1).tolist())) + "\n"
    got = _outs(name, _run(host_bin, text), (M, nb))
    assert tg.to_affine_host(got) == tg.to_affine_host(want)
    assert all(p is None for p in tg.to_affine_host(tuple(
        tg.F.map(lambda a: a[:, :, 0], c) for c in got)))


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_chain_fold_one_lane(host_bin, name):
    """The bucket fold on one lane a row, nb = 8: general buckets (Z != 1),
    a bucket equal to the running sum (the first add doubles), its negative
    (the running sum becomes the identity), an empty bucket after the top
    one (the second add doubles), an all-identity row; the words of
    bucket_fold_plain."""
    nb, count = 8, 5
    rng = np.random.RandomState(97)
    tg, neg, pts, jac = _jac_points(name, rng, nb * count)
    F = tg.F
    bk = tuple(tuple(x.reshape(12, count, nb) for x in co) if isinstance(co, tuple)
               else co.reshape(12, count, nb) for co in jac)
    for co in bk:
        for leaf in F.leaves(co):
            leaf[:, 0, nb - 2] = leaf[:, 0, nb - 1]       # row 0: P = Q
            leaf[:, 1, nb - 2] = leaf[:, 1, nb - 1]
    ny = F.plain.neg(bk[1])                               # row 1: P = -Q
    for leaf, nl in zip(F.leaves(bk[1]), F.leaves(ny)):
        leaf[:, 1, nb - 2] = nl[:, 1, nb - 2]
    for leaf in F.leaves(bk[2]):
        leaf[:, 2, nb - 2] = 0                            # row 2: empty bucket
        leaf[:, 3, :] = 0                                 # row 3: all empty
    want = cuda_ec.bucket_fold_plain(F, bk)
    text = f"fold {int(name == 'g2')} {nb} {count}\n"
    text += "\n".join(_hex(pl) for pl in cuda_ec._planes(F, bk)) + "\n"
    got = _run(host_bin, text)
    assert got == [_hex(pl).split() for pl in cuda_ec._planes(F, want)]
    assert tg.to_affine_host(want)[3] is None


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_split_lanes(host_bin, name):
    """split_tail_kernel.cu's lane pass stepped through lane by lane on the
    rows of test_torch_split_kernels.py at N = 2048 and 4096 (random signed
    digits with P = Q and P = -Q inside a lane, an all-zero row, a one-key
    row, a non-zero count ending inside a lane, a zero-heavy row): the lane
    totals and slots of split_lanes_plain, word for word."""
    from test_torch_split_kernels import NB, split_plain, split_rows

    for n in (2048, 4096):
        c = split_rows(name, n)
        M = c["sd"].shape[0]
        text = f"sl {int(name == 'g2')} {n} {M} {NB}\n"
        text += "\n".join(_hex(pl) for pl in cuda_ec._planes(c["F"], c["tp"])) + "\n"
        text += " ".join(map(str, c["sd"].reshape(-1).tolist())) + "\n"
        text += " ".join(map(str, c["od"].reshape(-1).tolist())) + "\n"
        lanes, slots, _ = split_plain(name, n)
        want = cuda_ec._planes(c["F"], lanes) + cuda_ec._planes(c["F"], slots)
        assert _run(host_bin, text) == [_hex(pl).split() for pl in want]


@pytest.mark.parametrize("T", [1, 4, 32, 128])
@pytest.mark.parametrize("name", ["g1", "g2"])
def test_split_tail_threads(host_bin, name, T):
    """split_tail_kernel.cu's tail stepped through with T threads a program
    (from one thread for all lanes to more threads than lanes), on the lane
    pass of the rows of test_torch_split_kernels.py at N = 2048 and 4096,
    against split_tail_plain after normalisation."""
    from test_torch_split_kernels import NB, split_plain, split_rows

    for n in (2048, 4096):
        c = split_rows(name, n)
        M = c["sd"].shape[0]
        lanes, slots, want = split_plain(name, n)
        text = f"st {int(name == 'g2')} {n} {M} {NB} {T}\n"
        text += "\n".join(_hex(pl) for pl in cuda_ec._planes(c["F"], lanes)) + "\n"
        text += "\n".join(_hex(pl) for pl in cuda_ec._planes(c["F"], slots)) + "\n"
        text += " ".join(map(str, c["sd"].reshape(-1).tolist())) + "\n"
        got = _outs(name, _run(host_bin, text), (M,))
        assert c["tg"].to_affine_host(got) == want


class _HostNtt:
    """Stands in for the card in ``NttPlan.kernel``: each pass and pointwise
    step of ``csrc/ntt_kernel.cu`` run by the host build, with a tile of
    2^tile_lg elements; counts its launches."""

    def __init__(self, host_bin, tile_lg):
        self.host_bin, self.tile_lg, self.count = host_bin, tile_lg, 0

    def _words(self, line, like):
        w = torch.tensor([int(x, 16) for x in line], dtype=torch.int64)
        return ((w << 32) >> 32).to(torch.int32).reshape(like.shape)

    def ntt_pass(self, src, dst, lg, s0, k, tw, pre, post, post_const, inverse):
        post_mode = 0 if post is None else 1 if post_const else 2
        text = (f"ntt {lg} {src.shape[1]} {self.tile_lg} {s0} {k} "
                f"{int(pre is not None)} {post_mode}\n{_hex(src)}\n{_hex(tw)}\n")
        text += "".join(_hex(v) + "\n" for v in (pre, post) if v is not None)
        (line,) = _run(self.host_bin, text)
        dst.copy_(self._words(line, dst))
        self.count += 1

    def pointwise(self, a, b, c, z, out):
        count = a.numel() // TL.FR.n
        text = f"ntp {count} {int(b is not None)}\n" + "".join(
            _hex(v) + "\n" for v in (a, b, c, z) if v is not None)
        (line,) = _run(self.host_bin, text)
        out.copy_(self._words(line, out))
        self.count += 1


@pytest.mark.parametrize("layout", ["m1", "m2", "view"])
@pytest.mark.parametrize("d,tile_lg", [(8, 4), (64, 3), (256, 3), (256, 4)])
def test_ntt_passes(host_bin, d, tile_lg, layout):
    """ntt_kernel.cu's passes stepped block by block with a reduced tile of
    2^tile_lg elements (d = 64 and 256 in 2-3 passes, d = 8 in one pass of
    two groups a tile), through ``NttPlan.kernel`` (the card path's
    schedule, tables and scalings): ntt, intt, coset_ntt, icoset_ntt,
    divide_by_z_on_coset and the quotient equal the plan's plain versions
    on the CPU word for word, at one row, two rows and a transposed
    DistNtt-like view; the quotient in 3 (2 passes) + 1 + passes launches."""
    from zerochain_tpu_torch.ntt import ntt as tntt

    rng = np.random.RandomState(d + tile_lg)
    plan = tntt.plan_for(d, "cpu")
    shape = {"m1": (d,), "m2": (2, d), "view": (2, d, 3)}[layout]

    def rand():
        n = int(np.prod(shape))
        vals = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]
        vals[:3] = [0, 1, R - 1]
        x = TL.FR.array(vals, "cpu").reshape(TL.FR.n, *shape)
        return x.transpose(-1, -2) if layout == "view" else x

    launcher = _HostNtt(host_bin, tile_lg)
    n_pass = len(tntt.schedule(plan.lg, tile_lg))
    assert n_pass == max(1, -(-plan.lg // tile_lg))
    x = rand()
    for name in ("ntt", "intt", "coset_ntt", "icoset_ntt", "divide_by_z_on_coset"):
        got = plan.kernel(name, x, launcher=launcher)
        assert torch.equal(got, getattr(plan, name)(x)), name
    evs = [rand() for _ in range(3)]
    launcher.count = 0
    got = plan.kernel("quotient", *evs, launcher=launcher)
    assert torch.equal(got, tntt.quotient(plan, *evs))
    assert launcher.count == 3 * 2 * n_pass + 1 + n_pass


def _fr_random(rng, shape, zeros=()):
    """Canonical Fr words of ``shape`` (8 leading), flat entries ``zeros``
    planted as 0."""
    n = int(np.prod(shape[1:]))
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    for k in zeros:
        vals[k] = 0
    return TL.FR.array(vals, "cpu").reshape(shape)


def test_witness_steps_host(host_bin):
    """W1's per-thread step (witness_kernel.cu: wit_step) on every step and
    proof of a variable-base job, two fixed-base jobs (32 and 252 bits, the
    last window with 2 and 3 real bits) and a fold, against steps_plain,
    word for word: random elements with zeros planted, bits with an
    all-zero and an all-one lane, digits 0-7."""
    from zerochain_tpu_torch.prover import cuda_witness as cw

    rng = np.random.RandomState(89)
    C, B, nb, K = 2, 3, 6, 4
    var_pts = tuple(_fr_random(rng, (8, nb, C, B), zeros=(1, 7)) for _ in range(4))
    bits = torch.from_numpy(rng.randint(0, 2, (nb, C, B)).astype(np.uint8))
    bits[:, 0, 0] = 0
    bits[:, 1, 2] = 1
    fix_pts = (_fr_random(rng, (8, 84, C, B)), _fr_random(rng, (8, 84, C, B)),
               _fr_random(rng, (8, 83, C, B), zeros=(5,)), _fr_random(rng, (8, 83, C, B)))
    digits = torch.from_numpy(rng.randint(0, 8, (84, C, B)).astype(np.uint8))
    fold_pts = tuple(_fr_random(rng, (8, K, C, B)) for _ in range(4))
    jobs, off = [], 0
    for kind, pts, data, index, n_bits in ((cw.VAR, var_pts, bits, 1, 0),
                                           (cw.FIXED, fix_pts, digits, 0, 32),
                                           (cw.FIXED, fix_pts, digits, 1, 252),
                                           (cw.FOLD, fold_pts, None, 1, 0)):
        jobs.append(cw.StepJob(kind, off, pts, index, data, n_bits))
        off += jobs[-1].n_rows
    want = torch.zeros((8, off, B), dtype=torch.int32)
    cw.steps_plain(jobs, want)
    text = f"wst {len(jobs)} {off} {B}\n"
    for j in jobs:
        text += (f"{j.kind} {j.aux_off} {j.n_steps} {j.n_bits} {j.points[0].shape[1]} "
                 f"{j.points[2].shape[1]} {C} {j.index}\n")
        text += "\n".join(_hex(t) for t in j.points) + "\n"
        if j.data is not None:
            text += " ".join(map(str, j.data.reshape(-1).tolist())) + "\n"
    (got,) = _run(host_bin, text)
    assert torch.equal(_words_of(got, want.shape), want)


def test_witness_program_host(host_bin):
    """W2's program interpreter (witness_kernel.cu: wg_run, one lane a proof)
    against gadgets_plain, word for word: an add gadget and two
    not-small-order gadgets (one on the small-order (0, -1), so a batched
    inversion holds a zero) of points from the program's input rows, and
    five inversions of one depth with zeros planted (one proof all zeros)."""
    from zerochain_tpu_torch.prover import cuda_witness as cw
    from zerochain_tpu_torch.prover import witness as twit

    rng = np.random.RandomState(97)
    B = 3
    pts = _jubjub_points(rng, 2 * B)
    small = [(0, R - 1), pts[0], (0, R - 1)]
    cols = [pts[:B], pts[B:], small]
    ins = torch.stack([c for pt in cols for c in twit.affine_mont_host(pt, "cpu")], dim=1)
    inv_in = _fr_random(rng, (8, 5, B), zeros=(1, 5, 6, 7, 8, 9))
    ins = torch.cat([ins, inv_in], dim=1)                  # (8, 6 + 5, B)
    prog = cw.Program()
    p, q, s = ((prog.load(2 * k, cw.INS), prog.load(2 * k + 1, cw.INS)) for k in range(3))
    vals = (twit.add_gadget(prog, *p, *q) + twit.not_small_order_gadget(prog, *p)
            + twit.not_small_order_gadget(prog, *s)
            + [prog.inv(prog.load(6 + k, cw.INS)) for k in range(5)])
    for row, v in enumerate(vals):
        prog.store(v, row)
    c = prog.compile()
    assert c.counts["inv"] == 2                            # one Fermat power a depth
    want = torch.zeros((8, len(vals), B), dtype=torch.int32)
    cw.gadgets_plain(c, want, ins)
    text = (f"wgp {len(c.ops)} {len(c.stage_end)} {c.n_slots} {len(vals)} {ins.shape[1]} {B}\n"
            + " ".join(map(str, c.ops.reshape(-1).tolist())) + "\n"
            + " ".join(map(str, c.stage_end.tolist())) + "\n"
            + _hex(want.zero_()) + "\n" + _hex(ins) + "\n")
    cw.gadgets_plain(c, want, ins)
    (got,) = _run(host_bin, text)
    assert torch.equal(_words_of(got, want.shape), want)
    assert torch.equal(want[:, -5:], cuda_ff.inv_plain(TL.FR, inv_in))


@pytest.fixture(scope="module")
def pairing_rows():
    """Two pairings (a generator pair and a non-generator pair) through the
    plain versions: the Miller set's input rows and output f, and the final
    exponentiation's output."""
    from zerochain_tpu_torch.ec import cuda_pairing as cp
    from zerochain_tpu_torch.ec import pairing as tp

    ps = [cv.G1_GEN, cv.g1_mul(cv.G1_GEN, 0x1234567)]
    qs = [cv.G2_GEN, cv.g2_mul(cv.G2_GEN, 0x89ABCDE)]
    (px, py), (qx, qy) = tp.g1_tensors(ps, "cpu"), tp.g2_tensors(qs, "cpu")
    ins = torch.stack([px, py, qx[:, 0], qx[:, 1], qy[:, 0], qy[:, 1]], 1).contiguous()
    f = cp.execute_plain(cp.miller_set("pairing"), ins)
    return {"miller": (cp.miller_set("pairing"), ins, f),
            "final_exp": (cp.final_exp_set(), f, cp.execute_plain(cp.final_exp_set(), f))}


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("kind", ["miller", "final_exp"])
def test_pairing_sets_host(host_bin, pairing_rows, kind, lanes):
    """pairing_kernel.cu's stage body (pp_stage) walking the Miller set
    (mode "pairing") and the final-exponentiation set for two pairings,
    every stage stepped lane by lane, against execute_plain word for word."""
    from zerochain_tpu_torch.ec import cuda_pairing as cp

    pset, ins, want = pairing_rows[kind]
    consts = cp._consts("cpu")
    B = ins.shape[2]
    text = (f"ppr {len(pset.ops)} {len(pset.stage_end)} {len(pset.prog_stage) - 1} "
            f"{len(pset.seq)} {pset.n_slots} {consts.shape[1]} {pset.n_in} {pset.n_out} "
            f"{B} {lanes}\n"
            + " ".join(map(str, pset.ops.reshape(-1).tolist())) + "\n"
            + " ".join(map(str, pset.stage_end.tolist())) + "\n"
            + " ".join(map(str, pset.prog_stage.tolist())) + "\n"
            + " ".join(map(str, pset.seq.reshape(-1).tolist())) + "\n"
            + _hex(consts) + "\n" + _hex(ins) + "\n")
    (got,) = _run(host_bin, text)
    assert torch.equal(_words_of(got, want.shape), want)
