"""The suffix-MSM bucket-sum kernel: ``window_totals``.

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
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ec import cuda_ec
from ..ec import weierstrass as W
from .pippenger import first_leaf, tcat, tmap, tmap2

launches = {"g1_window_totals": 0, "g2_window_totals": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------
def _neg_y_where(F, pts, mask):
    x, y, z = pts
    return (x, F.select(mask, F.neg(y), y), z)


def _hs_prefix_scan(F, pts):
    """Inclusive prefix scan (group add) along the last axis, Hillis-Steele:
    log2(n) levels of one batched add."""
    n = first_leaf(pts).shape[-1]
    s = 1
    while s < n:
        merged = cuda_ec.add_plain(
            F, tmap(lambda a: a[..., : n - s], pts),
            tmap(lambda a: a[..., s:], pts))
        pts = tmap2(lambda a, mg: torch.cat([a[..., :s], mg], dim=-1),
                    pts, merged)
        s *= 2
    return pts


def _prefix_scan(F, pts):
    """Inclusive prefix scan along the last axis (a power of two) in two
    levels: the axis is cut into T runs that are scanned side by side, one
    batched add per position; the run totals are scanned with Hillis-Steele;
    every run then takes the total of the runs before it.  Runs are 16 long
    (sqrt(n) below n = 256), so a long axis costs few sequential adds: each
    is hundreds of small tensor operations whatever its width."""
    n = first_leaf(pts).shape[-1]
    if n < 16:
        return _hs_prefix_scan(F, pts)
    T = max(n // 16, 1 << ((n.bit_length() - 1) // 2))
    ln = n // T
    runs = tmap(lambda a: a.reshape(*a.shape[:-1], T, ln), pts)
    cols = [tmap(lambda a: a[..., 0], runs)]
    for j in range(1, ln):
        cols.append(cuda_ec.add_plain(
            F, cols[-1], tmap(lambda a: a[..., j], runs)))
    totals = _hs_prefix_scan(F, cols[-1])           # (..., T) inclusive
    lead = tuple(first_leaf(totals).shape[1:-1])
    ident = W.identity(F, (*lead, 1), first_leaf(totals).device)
    offs = tmap2(lambda i, t: torch.cat([i, t[..., :-1]], dim=-1),
                 ident, totals)                      # exclusive
    stacked = tuple(_stack_last(F, [c[k] for c in cols]) for k in range(3))
    offs_b = tmap(lambda a: a[..., None].expand(*a.shape, ln), offs)
    out = cuda_ec.add_plain(F, offs_b, stacked)
    return tmap(lambda a: a.reshape(*a.shape[:-2], n), out)


def _stack_last(F, coords):
    """Stack a list of field elements along a new last axis."""
    return F.map(lambda *ts: torch.stack(ts, dim=-1), *coords)


def _tree_sum_last(F, pts, n: int):
    """Pairwise tree reduction over the last axis (n entries)."""
    while n > 1:
        half = n // 2
        s = cuda_ec.add_plain(F, tmap(lambda x: x[..., :half], pts),
                              tmap(lambda x: x[..., half:2 * half], pts))
        if n % 2:
            s = tmap2(lambda x, y: torch.cat([x, y[..., n - 1:n]], dim=-1),
                      s, pts)
        pts = s
        n = (n + 1) // 2
    return tmap(lambda x: x[..., 0], pts)


_PLAIN_SLAB = 1 << 22  # coordinate elements (points x ncomp) per pass


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
    pre = _prefix_scan(F, pts)

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
    return _tree_sum_last(F, picked, nb - 1)


# ---------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------
def _fn():
    lib = _build.lib("totals_kernel")
    fn = lib.zc_window_totals
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def threads_for(n: int) -> int:
    """Threads per program: 128, fewer for short chunks (runs of >= 8)."""
    t = 128
    while t > 1 and t * 8 > n:
        t //= 2
    return t


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
        with torch.cuda.device(dev):
            rc = _fn()(int(F.ncomp == 2), in_ptrs, sd.data_ptr(),
                       od.data_ptr(), out_ptrs, N, M, threads_for(N),
                       torch.cuda.current_stream().cuda_stream)
        launches[("g1" if F.ncomp == 1 else "g2") + "_window_totals"] += 1
        if rc != 0:
            raise RuntimeError(f"window_totals/{F.name}: CUDA error {rc}")
    outs = [t.reshape(12, *lead) for t in outs]
    if F.ncomp == 1:
        return tuple(outs)
    return tuple((outs[2 * k], outs[2 * k + 1]) for k in range(3))
