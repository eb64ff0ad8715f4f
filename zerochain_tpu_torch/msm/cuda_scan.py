"""The suffix-MSM kernels: ``window_totals``, ``split_lanes`` / ``split_tail``
and ``column_scan``.

For every program m (one window of one proof) it returns

    out[m] = sum_i d[m, i] * P[order[m, i]]

over one chunk of N points, where ``sorted_digits[m]`` are the chunk's digits
for that program sorted by magnitude descending and ``order[m]`` the matching
point indices.  ``window_totals`` wraps the kernel of
``csrc/totals_kernel.cu`` (the counterpart of ``window_totals`` /
``_totals_kernel`` in ``zerochain_tpu/msm/pallas_scan.py``);
``window_totals_plain`` is the plain PyTorch version.  The wrapper takes the
plain version only for CPU tensors; for CUDA tensors it launches the kernel
or raises.

The two add the points in different orders, so their Jacobian words differ
while the group element is the same: compare after ``normalize`` (exact,
tolerance 0 on the affine coordinates and the infinity flag).

The incoming points must be affine-or-infinity (Z in {0, one}): the kernel's
run scan uses the mixed add.

``column_scan`` wraps ``csrc/column_scan_kernel.cu`` (the counterpart of
``column_scan`` / ``_column_scan_kernel`` in the same JAX module), the depth
scan of the split tail of the suffix MSM (``SuffixMsm(tail="split")``).  A
chunk of N = T * 1024 points is laid out column-major: logical position i
lives at physical ``(i mod T) * 1024 + i div T`` (``logical_to_phys``,
``phys_perm``), and the scan runs down the depth axis T of each of the 1024
lanes with mixed adds, so its input too must have Z in {0, one}.
``column_scan_plain`` is its plain version; the two run the same formula in
the same order and return identical words.  The split tail no longer runs it:
``column_scan`` stays as an op.

``split_lanes`` and ``split_tail`` wrap the two kernels of
``csrc/split_tail_kernel.cu``, the split tail itself for a chunk of N = D * 1024
points, one launch each for all programs of the chunk (the counterparts of
``_column_scan_kernel`` and of the JAX split tail in
``zerochain_tpu/msm/suffix.py``): the lane pass, each of 1024 lanes of the
sorted row scanned down its D depths as far as the row's non-zero digits reach,
with the points taken through ``order``; then the lane offsets, the bucket picks
and their sum.  Together they return what ``window_totals`` returns.
``split_lanes_plain`` gives the lane pass's words; ``split_tail_plain`` adds in
another order than its kernel: compare after ``normalize``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ec import cuda_ec
from ..ec import weierstrass as W
from . import scans
from .pippenger import first_leaf, tcat, tmap

launches = {"g1_window_totals": 0, "g2_window_totals": 0,
            "g1_column_scan": 0, "g2_column_scan": 0,
            "g1_split_lanes": 0, "g2_split_lanes": 0,
            "g1_split_tail": 0, "g2_split_tail": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------
def _neg_y_where(F, pts, mask):
    x, y, z = pts
    return (x, F.select(mask, F.neg(y), y), z)


_PLAIN_SLAB = 1 << 21  # coordinate elements (points x ncomp) per pass


def bucket_counts(sorted_digits, nb: int):
    """(*lead, N) digits, |digit| descending -> (*lead, nb - 1) counts
    cnt[..., t - 1] = #{i : |d_i| >= t}, by binary search on the ascending
    magnitudes."""
    N = sorted_digits.shape[-1]
    lead = tuple(sorted_digits.shape[:-1])
    asc = sorted_digits.abs().flip(-1).reshape(-1, N).contiguous()
    ts = torch.arange(1, nb, dtype=asc.dtype, device=asc.device)
    pos = torch.searchsorted(asc, ts.expand(asc.shape[0], nb - 1).contiguous())
    return (N - pos).reshape(*lead, nb - 1)


def window_totals_plain(F, points, sorted_digits, order, nb: int):
    """points: leaves (12, N); sorted_digits, order: (*lead, N), |digit|
    descending; nb: bucket thresholds + 1 (max |digit| < nb).
    -> Jacobian leaves (12, *lead)."""
    F = F.plain
    N = order.shape[-1]
    lead = tuple(order.shape[:-1])
    M = order.numel() // N
    slab = max(1, _PLAIN_SLAB // (N * F.ncomp))
    if M > slab:  # bound the temporaries: slabs of programs
        sd2, od2 = sorted_digits.reshape(M, N), order.reshape(M, N)
        parts = [
            window_totals_plain(F, points, sd2[m: m + slab],
                                od2[m: m + slab], nb)
            for m in range(0, M, slab)
        ]
        return tmap(lambda a: a.reshape(12, *lead), tcat(parts, 1))
    idx = order.reshape(-1).to(torch.int64)
    pts = tmap(lambda a: a.index_select(1, idx).reshape(12, *lead, N), points)
    pts = _neg_y_where(F, pts, sorted_digits < 0)
    pre = scans.prefix_scan(F, pts, add=cuda_ec.add_plain)

    cnt = bucket_counts(sorted_digits, nb)
    empty = cnt == 0
    pick = (cnt - 1).clamp(min=0)
    picked = tmap(
        lambda a: torch.gather(a, -1, pick.expand(12, *pick.shape)), pre)
    ident = W.identity(F, tuple(empty.shape), empty.device)
    picked = W.select(F, empty, ident, picked)
    return scans.tree_sum_last(F, picked, nb - 1, add=cuda_ec.add_plain)


# ---------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------
def _fn():
    lib = _build.lib("totals_kernel")
    fn = lib.zc_window_totals
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def _part_words(g2: bool, M: int, nb: int) -> int:
    """Words of window_totals' scratch for M rows of digits below nb (the
    kernel's own count: partial points and drop slots a row, two columns a
    thread)."""
    fn = _build.lib("totals_kernel").zc_window_totals_part_words
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(int(g2), M, nb)


# The largest nb window_totals takes: the kernel multiplies a running sum by
# a magnitude drop with a double-and-add from bit 30 down
# (csrc/totals_kernel.cu, jac_small_mul), so |digit| < 2^31 would do; the
# plain version's 2^30 thresholds are the tighter limit.
MAX_NB = 1 << 30

# Non-zero digits a thread takes at least before its row gets more warps
# (csrc/totals_kernel.cu: one warp up to 32 * MIN_RUN, two up to twice that,
# else four).
MIN_RUN = 32


def row_threads(nnz: int, min_run: int = MIN_RUN) -> int:
    """Threads the kernel gives a row of nnz non-zero digits."""
    per_warp = 32 * min_run
    return 32 if nnz <= per_warp else 64 if nnz <= 2 * per_warp else 128


def _checked_planes(F, points, sorted_digits, order):
    """The point planes of a suffix-MSM kernel's inputs, checked: int32
    (12, N) planes and int32 digits and order of one shape, all on one
    device."""
    planes = [t for coord in points for t in F.leaves(coord)]
    dev = planes[0].device
    N = order.shape[-1]
    if sorted_digits.shape != order.shape:
        raise ValueError("sorted_digits and order differ in shape")
    for t in planes:
        if t.dtype != torch.int32 or tuple(t.shape) != (12, N):
            raise ValueError(
                f"point planes must be int32 (12, {N}), got {t.dtype} "
                f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("point planes on different devices")
    for t in (sorted_digits, order):
        if t.dtype != torch.int32:
            raise TypeError("sorted_digits and order must be int32")
        if t.device != dev:
            raise ValueError("digits/order and points on different devices")
    return planes


def _point_of(F, outs):
    """Output planes in kernel order -> a point's coordinate tuple."""
    if F.ncomp == 1:
        return tuple(outs)
    return tuple((outs[2 * k], outs[2 * k + 1]) for k in range(3))


def window_totals(F, points, sorted_digits, order, nb: int):
    """See the module docstring.  points: leaves (12, N) with Z in {0, one};
    sorted_digits, order: (*lead, N) int32.  -> Jacobian leaves (12, *lead)."""
    if not 2 <= nb <= MAX_NB:
        raise ValueError(f"window_totals takes 2 <= nb <= 2^30 (digits of at "
                         f"most 30 bits and a sign), got nb={nb}")
    planes = _checked_planes(F, points, sorted_digits, order)
    dev = planes[0].device
    N = order.shape[-1]
    lead = tuple(order.shape[:-1])
    if dev.type == "cpu":
        return window_totals_plain(F, points, sorted_digits, order, nb)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    planes = [t.contiguous() for t in planes]
    sd = sorted_digits.contiguous()
    od = order.contiguous()
    M = od.numel() // N
    outs = [torch.empty((12, M), dtype=torch.int32, device=dev)
            for _ in planes]
    if M:
        in_ptrs = (ctypes.c_void_p * len(planes))(*[t.data_ptr() for t in planes])
        out_ptrs = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
        # per row: up to 4 warps' partial sums, the running sums at the
        # drops and a count of finished warps; per thread: two columns
        part = torch.empty(_part_words(F.ncomp == 2, M, nb), dtype=torch.int32,
                           device=dev)
        done = torch.zeros(M, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = _fn()(int(F.ncomp == 2), in_ptrs, sd.data_ptr(),
                       od.data_ptr(), out_ptrs, part.data_ptr(),
                       done.data_ptr(), N, M, nb, MIN_RUN,
                       torch.cuda.current_stream().cuda_stream)
        launches[("g1" if F.ncomp == 1 else "g2") + "_window_totals"] += 1
        if rc != 0:
            raise RuntimeError(f"window_totals/{F.name}: CUDA error {rc}")
    return _point_of(F, [t.reshape(12, *lead) for t in outs])


# ---------------------------------------------------------------------
# column_scan: the depth scan of the split tail
# ---------------------------------------------------------------------
VL = 1024  # lanes of the column-major layout


def logical_to_phys(i, n_elems: int):
    """Logical sorted position -> physical index j = (i mod T) * 1024 +
    i div T, with T = n_elems / 1024."""
    t_depth = n_elems // VL
    return (i % t_depth) * VL + i // t_depth


def phys_perm(n_elems: int, device=None) -> torch.Tensor:
    """p with p[j] = the logical position stored at physical j (int64)."""
    t_depth = n_elems // VL
    j = torch.arange(n_elems, dtype=torch.int64, device=device)
    return (j % VL) * t_depth + j // VL


def madd_plain(F, p, q):
    """p + q with q's Z in {0, one}: the mixed add of ``jac_madd``
    (csrc/jacobian.cuh), its cases taken in the same order, so the words
    agree with the kernel's."""
    F = F.plain
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    z1z1 = F.sqr(Z1)
    u2 = F.mul(X2, z1z1)
    s2 = F.mul(F.mul(Y2, Z1), z1z1)
    h = F.sub(u2, X1)
    rr = F.sub(s2, Y1)
    z3 = F.mul(Z1, h)
    z3 = F.add(z3, z3)
    i = F.sqr(F.add(h, h))
    j = F.mul(h, i)
    r2 = F.add(rr, rr)
    v = F.mul(X1, i)
    x3 = F.sub(F.sub(F.sqr(r2), j), F.add(v, v))
    y1j = F.mul(Y1, j)
    y3 = F.sub(F.mul(r2, F.sub(v, x3)), F.add(y1j, y1j))

    h0 = F.is_zero(h)
    r0 = F.is_zero(rr)
    res = (x3, y3, z3)
    same = h0 & r0
    if bool(same.any()):
        res = W.select(F, same, cuda_ec.double_plain(F, p), res)
    batch = F.batch_shape(X1)
    res = W.select(F, h0 & ~r0, W.identity(F, batch, F.device(X1)), res)
    res = W.select(F, F.is_zero(Z2), p, res)
    return W.select(F, F.is_zero(Z1), q, res)


def column_scan_plain(F, pts_cm):
    """See ``column_scan``: T - 1 batched mixed adds down the depth axis."""
    n = first_leaf(pts_cm).shape[-1]
    t_depth = n // VL
    cols = tmap(lambda a: a.reshape(*a.shape[:-1], t_depth, VL), pts_cm)
    run = tmap(lambda a: a[..., 0, :], cols)
    out = [run]
    for t in range(1, t_depth):
        run = madd_plain(F, run, tmap(lambda a: a[..., t, :], cols))
        out.append(run)
    stacked = tcat([tmap(lambda a: a.unsqueeze(-2), r) for r in out], -2)
    return tmap(lambda a: a.reshape(*a.shape[:-2], n), stacked)


def _cs_fn():
    lib = _build.lib("column_scan_kernel")
    fn = lib.zc_column_scan
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def column_scan(F, pts_cm):
    """Inclusive group prefix down the depth axis, per lane.

    pts_cm: leaves (12, *lead, N) with N = T * 1024 in the column-major
    layout, every point with Z in {0, one}.  Returns new leaves of the same
    layout: physical (t, vl) holds the sum of logical vl*T .. vl*T + t."""
    planes = [t for coord in pts_cm for t in F.leaves(coord)]
    ref = planes[0]
    n = ref.shape[-1]
    if n == 0 or n % VL:
        raise ValueError(f"column_scan needs N a multiple of {VL}, got {n}")
    for t in planes:
        if t.dtype != torch.int32 or t.shape != ref.shape or t.shape[0] != 12:
            raise ValueError(
                f"point planes must be int32 (12, *lead, {n}) of one shape, "
                f"got {t.dtype} {tuple(t.shape)}")
        if t.device != ref.device:
            raise ValueError("point planes on different devices")
    if ref.device.type == "cpu":
        return column_scan_plain(F, pts_cm)
    if ref.device.type != "cuda":
        raise ValueError(f"unsupported device {ref.device}")

    outs = [t.clone(memory_format=torch.contiguous_format) for t in planes]
    M = ref[0].numel() // n
    if M:
        ptrs = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
        with torch.cuda.device(ref.device):
            rc = _cs_fn()(int(F.ncomp == 2), ptrs, n // VL, M,
                          torch.cuda.current_stream().cuda_stream)
        launches[("g1" if F.ncomp == 1 else "g2") + "_column_scan"] += 1
        if rc != 0:
            raise RuntimeError(f"column_scan/{F.name}: CUDA error {rc}")
    return _point_of(F, outs)


# ---------------------------------------------------------------------
# split_lanes, split_tail: the split tail of the suffix MSM, two kernels a chunk
# ---------------------------------------------------------------------
# split_tail's threads a program (one CTA a program; the kernel takes any
# power of two up to 128).  64 puts every program of a chunk on the card at
# once (8 CTAs a SM at 128 registers a thread); on the H100 it beat 128 and
# 32 for G1 and tied 32 for G2 (PERF.md, Findings).
SPLIT_THREADS = 64


def _split_check(N: int, nb: int):
    if N == 0 or N % VL:
        raise ValueError(f"the split tail needs N a multiple of {VL}, got {N}")
    if not 2 <= nb <= VL:
        raise ValueError(f"the split tail needs 2 <= nb <= {VL}, got {nb}")


def _pick_slots(sd, nb: int):
    """(M, N) sorted digits -> (is_pick, pos), both (M, nb): whether some
    position p has |d_p| = v > |d_p+1| (the pick of buckets t in
    (|d_p+1|, v]), and that p (clamped to 0 where none)."""
    M = sd.shape[0]
    cnt = torch.cat([sd.new_zeros((M, 1)), bucket_counts(sd, nb)], -1)
    pos = (cnt - 1).clamp(min=0).to(torch.int64)
    v = torch.arange(nb, device=sd.device)
    return (cnt > 0) & (sd.abs().gather(-1, pos) == v), pos


def split_lanes_plain(F, points, sorted_digits, order, nb: int):
    """See ``split_lanes``: the sorted points (Y negated where the digit is
    negative) as 1024 lanes of D = N / 1024 depths, each scanned with
    ``madd_plain`` and held where the row's digits turn zero, as the
    kernel's lanes stop there; the kernel's words."""
    F = F.plain
    N = order.shape[-1]
    _split_check(N, nb)
    lead = tuple(order.shape[:-1])
    M = order.numel() // N
    dev = order.device
    slab = max(1, _PLAIN_SLAB // (N * F.ncomp))
    if M > slab:  # bound the temporaries: slabs of programs
        sd2, od2 = sorted_digits.reshape(M, N), order.reshape(M, N)
        parts = [split_lanes_plain(F, points, sd2[m: m + slab],
                                   od2[m: m + slab], nb)
                 for m in range(0, M, slab)]
        return tuple(tmap(lambda a: a.reshape(12, *lead, a.shape[-1]),
                          tcat([p[k] for p in parts], 1)) for k in range(2))
    D = N // VL
    idx = order.reshape(-1).to(torch.int64)
    pts = tmap(lambda a: a.index_select(1, idx).reshape(12, M, N), points)
    sd = sorted_digits.reshape(M, N)
    pts = _neg_y_where(F, pts, sd < 0)
    lanes = tmap(lambda a: a.reshape(12, M, VL, D), pts)
    live = (sd != 0).reshape(M, VL, D)
    run = W.select(F, live[..., 0], tmap(lambda a: a[..., 0], lanes),
                   W.identity(F, (M, VL), dev))
    pre = [run]
    for t in range(1, D):
        run = W.select(F, live[..., t],
                       madd_plain(F, run, tmap(lambda a: a[..., t], lanes)), run)
        pre.append(run)
    pre = tmap(lambda a: a.reshape(12, M, N),
               tcat([tmap(lambda a: a.unsqueeze(-1), r) for r in pre], -1))
    is_pick, pos = _pick_slots(sd, nb)
    slots = tmap(lambda a: torch.gather(a, -1, pos.expand(12, M, nb)), pre)
    slots = W.select(F, ~is_pick, W.identity(F, (M, nb), dev), slots)
    return (tmap(lambda a: a.reshape(12, *lead, VL), run),
            tmap(lambda a: a.reshape(12, *lead, nb), slots))


def split_tail_plain(F, lanes, slots, sorted_digits, nb: int):
    """See ``split_tail``: the lane offsets by an exclusive scan of the lane
    totals (``scans.prefix_scan``, work-efficient at a power-of-two width),
    each bucket's pick its lane's offset plus its slot, the buckets summed
    by ``scans.tree_sum_last``; every add ``cuda_ec.add_plain``."""
    F = F.plain
    N = sorted_digits.shape[-1]
    _split_check(N, nb)
    lead = tuple(sorted_digits.shape[:-1])
    M = sorted_digits.numel() // N
    dev = sorted_digits.device
    lanes = tmap(lambda a: a.reshape(12, M, VL), lanes)
    slots = tmap(lambda a: a.reshape(12, M, nb), slots)
    sd = sorted_digits.reshape(M, N)
    excl = scans._shift_in_identity(
        F, scans.prefix_scan(F, lanes, add=cuda_ec.add_plain))
    cnt = bucket_counts(sd, nb)
    pos = (cnt - 1).clamp(min=0).to(torch.int64)
    lane = pos // (N // VL)
    v = sd.abs().gather(-1, pos).to(torch.int64)

    def gather_at(ix):
        return lambda a: torch.gather(a, -1, ix.expand(12, *ix.shape))

    picked = cuda_ec.add_plain(F, tmap(gather_at(lane), excl),
                               tmap(gather_at(v), slots))
    picked = W.select(F, cnt == 0, W.identity(F, tuple(cnt.shape), dev), picked)
    total = scans.tree_sum_last(F, picked, nb - 1, add=cuda_ec.add_plain)
    return tmap(lambda a: a.reshape(12, *lead), total)


def _st_fn(name):
    lib = _build.lib("split_tail_kernel")
    fn = getattr(lib, name)
    if not getattr(fn, "_typed", False):
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        head = [ctypes.c_int, ptrs]
        if name == "zc_split_lanes":
            fn.argtypes = head + [ctypes.c_void_p, ctypes.c_void_p, ptrs, ptrs,
                                  ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p]
        else:
            fn.argtypes = head + [ptrs, ctypes.c_void_p, ptrs, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def _ptrs(planes):
    return (ctypes.c_void_p * len(planes))(*[t.data_ptr() for t in planes])


def split_lanes(F, points, sorted_digits, order, nb: int):
    """The split tail's lane pass (the counterpart of ``column_scan``).
    points: leaves (12, N) with Z in {0, one}, N = D * 1024; sorted_digits,
    order: (*lead, N) int32, |digit| descending and below nb along each row.
    Lane vl holds the sorted positions vl*D .. vl*D + D - 1 and is scanned
    down them as far as the row's non-zero digits reach.  -> (lane totals,
    leaves (12, *lead, 1024), the identity for a lane with no non-zero
    digit; slots, leaves (12, *lead, nb): slot v the in-lane prefix at the
    position p with |d_p| = v > |d_p+1|, where there is one, else the
    identity)."""
    planes = _checked_planes(F, points, sorted_digits, order)
    dev = planes[0].device
    N = order.shape[-1]
    _split_check(N, nb)
    lead = tuple(order.shape[:-1])
    if dev.type == "cpu":
        return split_lanes_plain(F, points, sorted_digits, order, nb)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    planes = [t.contiguous() for t in planes]
    sd = sorted_digits.contiguous()
    od = order.contiguous()
    M = od.numel() // N
    lanes = [torch.empty((12, M, VL), dtype=torch.int32, device=dev)
             for _ in planes]
    slots = [torch.empty((12, M, nb), dtype=torch.int32, device=dev)
             for _ in planes]
    if M:
        with torch.cuda.device(dev):
            rc = _st_fn("zc_split_lanes")(
                int(F.ncomp == 2), _ptrs(planes), sd.data_ptr(), od.data_ptr(),
                _ptrs(lanes), _ptrs(slots), N, M, nb,
                torch.cuda.current_stream().cuda_stream)
        launches[("g1" if F.ncomp == 1 else "g2") + "_split_lanes"] += 1
        if rc != 0:
            raise RuntimeError(f"split_lanes/{F.name}: CUDA error {rc}")
    return (_point_of(F, [t.reshape(12, *lead, VL) for t in lanes]),
            _point_of(F, [t.reshape(12, *lead, nb) for t in slots]))


def split_tail(F, lanes, slots, sorted_digits, nb: int):
    """The split tail after its lane pass: lanes, slots as ``split_lanes``
    returns them for sorted_digits (*lead, N) int32.  -> the programs' sums
    sum_{t=1}^{nb-1} prefix[c_t - 1] (c_t = #{i : |d_i| >= t}), Jacobian
    leaves (12, *lead): what ``window_totals`` returns for the same digits."""
    N = sorted_digits.shape[-1]
    _split_check(N, nb)
    lead = tuple(sorted_digits.shape[:-1])
    lp = [t for coord in lanes for t in F.leaves(coord)]
    sp = [t for coord in slots for t in F.leaves(coord)]
    dev = sorted_digits.device
    for t, width in [(t, VL) for t in lp] + [(t, nb) for t in sp]:
        if t.dtype != torch.int32 or tuple(t.shape) != (12, *lead, width):
            raise ValueError(f"lanes/slots must be int32 (12, *{lead}, {VL} / "
                             f"{nb}), got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("lanes/slots and digits on different devices")
    if sorted_digits.dtype != torch.int32:
        raise TypeError("sorted_digits must be int32")
    if dev.type == "cpu":
        return split_tail_plain(F, lanes, slots, sorted_digits, nb)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    lp = [t.contiguous() for t in lp]
    sp = [t.contiguous() for t in sp]
    sd = sorted_digits.contiguous()
    M = sd.numel() // N
    outs = [torch.empty((12, M), dtype=torch.int32, device=dev) for _ in lp]
    if M:
        area = max(SPLIT_THREADS, 1 << (nb - 2).bit_length())  # scan / tree entries
        # per program: two scan / tree areas, the lane offsets, the picks
        scratch = torch.empty(M * (2 * area + 2 * nb) * 3 * 12 * F.ncomp,
                              dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = _st_fn("zc_split_tail")(
                int(F.ncomp == 2), _ptrs(lp), _ptrs(sp), sd.data_ptr(),
                _ptrs(outs), scratch.data_ptr(), N, M, nb, SPLIT_THREADS, area,
                torch.cuda.current_stream().cuda_stream)
        launches[("g1" if F.ncomp == 1 else "g2") + "_split_tail"] += 1
        if rc != 0:
            raise RuntimeError(f"split_tail/{F.name}: CUDA error {rc}")
    return _point_of(F, [t.reshape(12, *lead) for t in outs])
