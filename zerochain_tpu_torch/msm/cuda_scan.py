"""The suffix-MSM kernels: ``window_totals`` and ``column_scan``.

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
the same order and return identical words.
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
            "g1_column_scan": 0, "g2_column_scan": 0}


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

    # cnt[t] = #{i : |d_i| >= t} by binary search on ascending magnitudes
    asc = sorted_digits.abs().flip(-1).reshape(-1, N).contiguous()
    ts = torch.arange(1, nb, dtype=asc.dtype, device=asc.device)
    pos = torch.searchsorted(asc, ts.expand(asc.shape[0], nb - 1).contiguous())
    cnt = (N - pos).reshape(*lead, nb - 1)
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
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


# Non-zero digits a thread takes at least before its row gets more warps
# (csrc/totals_kernel.cu: one warp up to 32 * MIN_RUN, two up to twice that,
# else four).
MIN_RUN = 32


def row_threads(nnz: int, min_run: int = MIN_RUN) -> int:
    """Threads the kernel gives a row of nnz non-zero digits."""
    per_warp = 32 * min_run
    return 32 if nnz <= per_warp else 64 if nnz <= 2 * per_warp else 128


def window_totals(F, points, sorted_digits, order, nb: int):
    """See the module docstring.  points: leaves (12, N) with Z in {0, one};
    sorted_digits, order: (*lead, N) int32.  -> Jacobian leaves (12, *lead)."""
    planes = [t for coord in points for t in F.leaves(coord)]
    dev = planes[0].device
    N = order.shape[-1]
    lead = tuple(order.shape[:-1])
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
        # per row: up to 4 warps' partial sums and a count of finished warps
        part = torch.empty(M * 4 * 3 * 12 * F.ncomp, dtype=torch.int32,
                           device=dev)
        done = torch.zeros(M, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = _fn()(int(F.ncomp == 2), in_ptrs, sd.data_ptr(),
                       od.data_ptr(), out_ptrs, part.data_ptr(),
                       done.data_ptr(), N, M, MIN_RUN,
                       torch.cuda.current_stream().cuda_stream)
        launches[("g1" if F.ncomp == 1 else "g2") + "_window_totals"] += 1
        if rc != 0:
            raise RuntimeError(f"window_totals/{F.name}: CUDA error {rc}")
    outs = [t.reshape(12, *lead) for t in outs]
    if F.ncomp == 1:
        return tuple(outs)
    return tuple((outs[2 * k], outs[2 * k + 1]) for k in range(3))


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
    if F.ncomp == 1:
        return tuple(outs)
    return tuple((outs[2 * k], outs[2 * k + 1]) for k in range(3))
