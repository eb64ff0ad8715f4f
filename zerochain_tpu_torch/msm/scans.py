"""Group scans and reductions along the last axis of a point batch.

The counterparts of the scans of ``zerochain_tpu/msm/suffix.py``, under the
same names.  Each takes the group law's ``add`` as an argument: ``W.add``
(the point kernels on a CUDA tensor) where the MSM runs them, or
``cuda_ec.add_plain`` where a kernel's plain version runs them.

Points: leaves (12, *lead, n); the scans work on the last axis.
"""

from __future__ import annotations

import torch

from ..ec import weierstrass as W
from .pippenger import first_leaf, tmap, tmap2

# lf_scan hands widths up to this to hs_prefix_scan.  The JAX package stops
# at 256 to keep its XLA graphs small; here nothing is compiled, and 16
# keeps both the work (about 2n adds) and the number of sequential adds low.
LF_MIN = 16


def interleave_last(a, b):
    """a at even, b at odd slots of the last axis; a may be one longer."""
    m = b.shape[-1]
    out = torch.stack([a[..., :m], b], dim=-1).reshape(*b.shape[:-1], 2 * m)
    if a.shape[-1] > m:
        out = torch.cat([out, a[..., m:]], dim=-1)
    return out


def _ident_like(F, pts, width: int):
    """Identity points of batch (*lead, width) on the points' device."""
    lead = tuple(first_leaf(pts).shape[1:-1])
    return W.identity(F, (*lead, width), first_leaf(pts).device)


def _shift_in_identity(F, pts, ident_like=_ident_like):
    """(..., n) -> (..., n): identity at 0, pts[..., :-1] after it."""
    ident = ident_like(F, pts, 1)
    return tmap2(lambda i, x: torch.cat([i, x[..., :-1]], dim=-1), ident, pts)


def hs_prefix_scan(F, pts, add=W.add):
    """Inclusive prefix scan, Hillis-Steele: ceil(log2 n) levels, each one
    batched add of the points rolled by the level's distance, kept where
    no element lies at that distance to the left."""
    n = first_leaf(pts).shape[-1]
    if n == 1:
        return pts
    pos = torch.arange(n, device=first_leaf(pts).device)
    for d in range((n - 1).bit_length()):
        s = 1 << d
        merged = add(F, tmap(lambda a: torch.roll(a, s, dims=-1), pts), pts)
        keep = pos < s
        pts = tmap2(lambda x, m: torch.where(keep, x, m), pts, merged)
    return pts


def lf_scan(F, pts, add=W.add, ident_like=_ident_like):
    """Inclusive prefix scan, Ladner-Fischer (width a power of two):
    pairwise sums, a scan of them, an odd-position fix-up; about 2n adds at
    2 log2(n) depth.  Widths up to LF_MIN go to hs_prefix_scan.  ``add``
    need only be associative: its left operand is always the earlier part
    of the row; ``ident_like(F, pts, width)`` gives its identity."""
    n = first_leaf(pts).shape[-1]
    if n == 1:
        return pts
    if n <= LF_MIN:
        return hs_prefix_scan(F, pts, add)
    if n % 2:
        raise ValueError(f"lf_scan needs a power-of-two width, got {n}")
    even = tmap(lambda x: x[..., 0::2], pts)
    odd = tmap(lambda x: x[..., 1::2], pts)
    r = lf_scan(F, add(F, even, odd), add, ident_like)
    y_even = add(F, _shift_in_identity(F, r, ident_like), even)
    return tmap2(interleave_last, y_even, r)


def prefix_scan(F, pts, add=W.add, ident_like=_ident_like):
    """Inclusive prefix scan along the last axis.  The JAX package picks
    Ladner-Fischer where its fused TPU kernels run the adds and
    Hillis-Steele elsewhere (to keep XLA graphs small); here no graph is
    compiled, so the work-efficient form is taken whenever the width is a
    power of two."""
    n = first_leaf(pts).shape[-1]
    if n & (n - 1):
        return hs_prefix_scan(F, pts, add)
    return lf_scan(F, pts, add, ident_like)


def segmented_prefix_scan(F, pts, starts, add=W.add):
    """Inclusive prefix sums along the last axis that restart wherever
    ``starts`` (bool, the points' batch shape) is set: ``prefix_scan`` over
    (point, flag) pairs with the segmented operator of the JAX ``Msm``'s
    'assoc' mode, (p, f) . (q, g) = (g ? q : p + q, f | g), whose identity
    is (the identity point, unset).  The flag rides as a fourth leaf of
    shape (1, *batch)."""
    def seg_add(F, left, right):
        merged = add(F, left[:3], right[:3])
        pt = W.select(F, right[3][0] != 0, right[:3], merged)
        return (*pt, left[3] | right[3])

    def seg_ident(F, pairs, width):
        flag = pairs[3]
        unset = torch.zeros((1, *flag.shape[1:-1], width), dtype=flag.dtype,
                            device=flag.device)
        return (*_ident_like(F, pairs[:3], width), unset)

    flags = starts.unsqueeze(0).to(torch.int32)
    return prefix_scan(F, (*pts, flags), seg_add, seg_ident)[:3]


def exclusive_scan_last(F, pts, add=W.add):
    """Exclusive prefix scan along the last axis: the inclusive
    Hillis-Steele scan shifted right by one identity."""
    return _shift_in_identity(F, hs_prefix_scan(F, pts, add))


def _pad_pow2(F, pts, n: int):
    pad = 1 << max(0, (n - 1).bit_length())
    if pad != n:
        ident = _ident_like(F, pts, pad - n)
        pts = tmap2(lambda x, i: torch.cat([x, i], dim=-1), pts, ident)
    return pts, pad


def scan_reduce_last(F, pts, n: int, add=W.add):
    """Group sum over the last axis (n entries) by circular recursive
    doubling: pad to a power of two with identities, then log2(width)
    levels of x + roll(x, s); every lane ends holding the total, lane 0 is
    returned."""
    pts, pad = _pad_pow2(F, pts, n)
    s = 1
    while s < pad:
        pts = add(F, pts, tmap(lambda a: torch.roll(a, s, dims=-1), pts))
        s *= 2
    return tmap(lambda x: x[..., 0], pts)


def tree_sum_last(F, pts, n: int, add=W.add):
    """Pairwise tree reduction over the last axis (n entries), padded to a
    power of two with identities."""
    pts, n = _pad_pow2(F, pts, n)
    while n > 1:
        half = n // 2
        pts = add(F, tmap(lambda x: x[..., :half], pts),
                  tmap(lambda x: x[..., half:n], pts))
        n = half
    return tmap(lambda x: x[..., 0], pts)
