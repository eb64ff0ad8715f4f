"""The plain versions of the split tail's two kernels (msm/cuda_scan.py:
``split_lanes_plain`` and ``split_tail_plain``, the counterparts of
csrc/split_tail_kernel.cu) against the mirror and against the composed tail
they replace, G1 and G2, at N = 2048 (D = 2 depths a lane) and N = 4096
(D = 4).

The composed tail is the split tail as the JAX package builds it around its
column-scan kernel: the column-major layout, ``column_scan_plain``,
``scans.exclusive_scan_last`` over the 1024 lane totals, the picks (an add of
the lane offset and the in-lane prefix) and ``scans.scan_reduce_last`` over
the buckets, every add ``cuda_ec.add_plain``.  The lane pass gives the
composed tail's own depth-scan words at every pick and for every lane below
the row's non-zero count; the tail adds in another order, so the sums are
compared after ``normalize`` (exact, tolerance 0).

Rows of one chunk (``split_rows``): random signed digits with P = Q and
P = -Q inside a lane; an all-zero row; a one-key row (every digit of one
magnitude, so every pick lands in the last lane); a non-zero count that ends
in the middle of a lane, its last non-zero digit negative on a padding point
(the lane ends on an identity whose Y is negated, which a further mixed add
would turn into other words); a zero-heavy row as a witness gives.  The points
include padding points (the identity).  tests/test_torch_csrc_host.py steps
the kernels' own threads through on the same rows."""

import functools

import numpy as np
import pytest
import torch

from zerochain_tpu_torch.ec import cuda_ec
from zerochain_tpu_torch.ec import g1 as tg1
from zerochain_tpu_torch.ec import g2 as tg2
from zerochain_tpu_torch.ec import weierstrass as W
from zerochain_tpu_torch.ec.fields import FqOps, Fq2Ops
from zerochain_tpu_torch.mirror import curves as cv
from zerochain_tpu_torch.mirror.field import R
from zerochain_tpu_torch.msm import cuda_scan, scans
from zerochain_tpu_torch.msm.pippenger import tmap
from zerochain_tpu_torch.msm.suffix import SuffixMsm

torch.set_num_threads(2)  # several test workers share the cores

GROUPS = {
    "g1": (tg1, FqOps, cv.G1_GEN, cv.g1_mul, cv.g1_add),
    "g2": (tg2, Fq2Ops, cv.G2_GEN, cv.g2_mul, cv.g2_add),
}
VL = cuda_scan.VL
NB = 129  # signed c = 8 digits: |d| <= 128
ROWS = ("random", "zero", "one_key", "mid_lane", "zero_heavy")


@functools.lru_cache(maxsize=None)
def split_rows(group, n):
    """16 base points spread over n points (three of them padding), and one
    sorted signed digit row of each kind in ROWS with its order."""
    tg, F, gen, mul, add = GROUPS[group]
    rng = np.random.RandomState(31 + n)
    base = [mul(gen, int(rng.randint(2, 1 << 30))) for _ in range(16)]
    kind = rng.randint(0, 16, n)
    kind[[3, n // 2, n - 1]] = -1
    pts = [base[k] if k >= 0 else None for k in kind]
    D = n // VL
    mags = np.zeros((len(ROWS), n), dtype=np.int64)
    mags[0] = np.sort(rng.randint(0, NB, n))[::-1]
    mags[2] = 77
    nz = 5 * D + 1                                   # ends inside lane 5
    mags[3, :nz] = np.sort(rng.randint(1, NB, nz))[::-1]
    nz = n // 3 + 7
    mags[4, :nz] = np.sort(rng.choice([1, 1, 1, 2, 3, 64, 128], nz))[::-1]
    mags[0, 1] = mags[0, 0]                          # P = Q at lane 0's first add
    mags[0, D + 1] = mags[0, D]                      # P = -Q inside lane 1
    sign = np.where(rng.rand(len(ROWS), n) < 0.5, -1, 1)
    sd = mags * sign
    od = np.stack([rng.permutation(n) for _ in ROWS])
    od[0, 0] = od[0, 1] = 5
    sd[0, 1] = sd[0, 0]
    od[0, D] = od[0, D + 1] = 6
    sd[0, D + 1] = -sd[0, D]
    od[3, 5 * D] = 3                                 # the last non-zero digit:
    sd[3, 5 * D] = -mags[3, 5 * D]                   # a padding point, Y negated
    return dict(tg=tg, F=F, add=add, mul=mul, base=base, kind=kind, pts=pts,
                tp=tg.from_affine_host(pts, device="cpu"),
                sd=torch.from_numpy(sd).to(torch.int32),
                od=torch.from_numpy(od).to(torch.int32))


@functools.lru_cache(maxsize=None)
def split_plain(group, n):
    """split_lanes_plain and split_tail_plain on split_rows(group, n): the
    lane totals, the slots and the sums (as affine points)."""
    c = split_rows(group, n)
    lanes, slots = cuda_scan.split_lanes_plain(c["F"], c["tp"], c["sd"], c["od"], NB)
    sums = cuda_scan.split_tail_plain(c["F"], lanes, slots, c["sd"], NB)
    return lanes, slots, c["tg"].to_affine_host(sums)


def mirror_sums(c):
    """sum_p d_p * P[order_p] per row, by the mirror: each base point times
    the sum of its digits."""
    out = []
    for sd_row, od_row in zip(c["sd"].tolist(), c["od"].tolist()):
        coef = [0] * len(c["base"])
        for d, i in zip(sd_row, od_row):
            if c["kind"][i] >= 0:
                coef[c["kind"][i]] += d
        acc = None
        for b, k in zip(c["base"], coef):
            if k % R:
                acc = c["add"](acc, c["mul"](b, k % R))
        out.append(acc)
    return out


def composed_tail(c):
    """The split tail as it was composed around column_scan, with plain
    adds -> (the depth scan in logical order, the sums)."""
    F, sd, od = c["F"], c["sd"], c["od"]
    n = od.shape[-1]
    D = n // VL
    split = SuffixMsm(F, c=8, signed=True, tail="split")
    pts_cm = split.column_layout(c["tp"], sd, od)
    pre = cuda_scan.column_scan_plain(F, pts_cm) if D > 1 else pts_cm
    tot = tmap(lambda a: a[..., (D - 1) * VL:], pre)
    excl = scans.exclusive_scan_last(F, tot, add=cuda_ec.add_plain)
    cnt = cuda_scan.bucket_counts(sd, NB)
    idx = (cnt - 1).clamp(min=0).to(torch.int64)

    def gather_at(ix):
        return lambda a: torch.gather(a, -1, ix.expand(12, *ix.shape))

    picked = cuda_ec.add_plain(F, tmap(gather_at((idx % D) * VL + idx // D), pre),
                               tmap(gather_at(idx // D), excl))
    picked = W.select(F, cnt == 0, W.identity(F, tuple(cnt.shape), "cpu"), picked)
    phys = cuda_scan.logical_to_phys(torch.arange(n), n)
    logical = tmap(lambda a: a.index_select(-1, phys), pre)
    return logical, scans.scan_reduce_last(F, picked, NB - 1, add=cuda_ec.add_plain)


def _words(pt, F):
    return [t for co in pt for t in F.leaves(co)]


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_split_lanes_plain_gives_the_depth_scan(group, n):
    """Every slot of a pick is the composed tail's depth-scan word at that
    position, every other slot the identity; every lane's total is the depth
    scan at the lane's last non-zero position (the identity for a lane with
    none), and, on the mirror, the sum of the lane's signed points."""
    c = split_rows(group, n)
    F, sd, D = c["F"], c["sd"], n // VL
    lanes, slots, _ = split_plain(group, n)
    logical, _ = composed_tail(c)
    mag = sd.abs()
    nnz = (mag != 0).sum(-1)
    M = sd.shape[0]
    ident = W.identity(F, (1,), "cpu")
    for m in range(M):
        for v in range(NB):
            hit = ((mag[m] == v) & (torch.cat([mag[m, 1:], mag.new_zeros(1)]) < v)).nonzero()
            want = (tmap(lambda a: a[:, m, hit[0, 0]: hit[0, 0] + 1], logical)
                    if v and len(hit) else ident)
            got = tmap(lambda a: a[:, m, v: v + 1], slots)
            assert all(torch.equal(x, y) for x, y in zip(_words(got, F), _words(want, F))), (m, v)
        for vl in range(VL):
            last = min(vl * D + D, int(nnz[m])) - 1
            want = (tmap(lambda a: a[:, m, last: last + 1], logical)
                    if last >= vl * D else ident)
            got = tmap(lambda a: a[:, m, vl: vl + 1], lanes)
            assert all(torch.equal(x, y) for x, y in zip(_words(got, F), _words(want, F))), (m, vl)
    # on the mirror: the lanes of row 0 holding P = Q and P = -Q, and the
    # last lane that holds non-zero digits in each row
    aff = c["tg"].to_affine_host(lanes)
    for m, vl in [(0, 0), (0, 1)] + [(m, (int(nnz[m]) - 1) // D) for m in range(M)
                                     if nnz[m]]:
        acc = None
        for p in range(vl * D, min(vl * D + D, int(nnz[m]))):
            pt = c["pts"][int(c["od"][m, p])]
            if pt is not None:
                acc = c["add"](acc, pt if sd[m, p] > 0 else cv.g1_neg(pt)
                               if group == "g1" else cv.g2_neg(pt))
        assert aff[m * VL + vl] == acc, (m, vl)
    if D == 2:
        assert aff[1] is None  # row 0, lane 1: P + (-P)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_split_tail_plain_matches_the_mirror_and_the_composed_tail(group, n):
    c = split_rows(group, n)
    _, _, got = split_plain(group, n)
    assert got == mirror_sums(c)
    assert got == c["tg"].to_affine_host(composed_tail(c)[1])
    assert got[ROWS.index("zero")] is None
    assert got[ROWS.index("random")] is not None


def test_split_wrappers_route_cpu_tensors_to_the_plain_versions():
    c = split_rows("g1", 2048)
    before = dict(cuda_scan.launches)
    lanes, slots = cuda_scan.split_lanes(FqOps, c["tp"], c["sd"], c["od"], NB)
    want_l, want_s, _ = split_plain("g1", 2048)
    assert all(torch.equal(a, b) for a, b in zip(lanes + slots, want_l + want_s))
    got = cuda_scan.split_tail(FqOps, lanes, slots, c["sd"], NB)
    want = cuda_scan.split_tail_plain(FqOps, lanes, slots, c["sd"], NB)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cuda_scan.launches == before
    # a SuffixMsm's split tail on a chunk of 1024 lanes is these two
    split = SuffixMsm(FqOps, c=8, n_bits=7, signed=True, tail="split")
    assert split.n_windows == 1 and split.nb == NB
    part = split.window_partials(c["tp"], prep=(c["sd"][None], c["od"][None]))
    assert all(torch.equal(a[:, 0], b) for a, b in zip(part, want))


def test_split_wrappers_check_their_input():
    c = split_rows("g1", 2048)
    tp, sd, od = c["tp"], c["sd"], c["od"]
    short = tmap(lambda a: a[:, :1000].contiguous(), tp)
    with pytest.raises(ValueError):
        cuda_scan.split_lanes(FqOps, short, sd[:, :1000], od[:, :1000], NB)
    with pytest.raises(ValueError):
        cuda_scan.split_lanes(FqOps, tp, sd, od, VL + 1)
    with pytest.raises(TypeError):
        cuda_scan.split_lanes(FqOps, tp, sd, od.long(), NB)
    with pytest.raises(ValueError):
        cuda_scan.split_lanes(FqOps, tp, sd[:, :1024], od, NB)
    lanes, slots, _ = split_plain("g1", 2048)
    with pytest.raises(ValueError):
        cuda_scan.split_tail(FqOps, lanes, slots, sd, NB + 1)
    with pytest.raises(ValueError):
        cuda_scan.split_tail(FqOps, lanes, slots, sd[:2], NB)
    with pytest.raises(TypeError):
        cuda_scan.split_tail(FqOps, lanes, slots, sd.long(), NB)
