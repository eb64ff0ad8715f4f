"""Suffix-sum Pippenger MSM: sort + one bucket-sum kernel per chunk.

The suffix-sum identity

    sum_i d_i * P_i  =  sum_{t=1}^{2^c - 1}  sum_{i : d_i >= t} P_i

turns every inner sum into a PREFIX of the points sorted by digit
(descending), so one prefix scan plus a pick of 2^c prefixes replaces bucket
scatter and bucket fold.  The sort is a library call (``torch.sort``); the
scan, the picks and their sum are one kernel (``cuda_scan.window_totals``).

``tail="split"`` (env ``ZEROCHAIN_MSM_TOTALS=0``, as in the JAX package)
runs the same sum as the JAX package's split fallback instead, in two
kernel launches a chunk: ``cuda_scan.split_lanes`` takes the sorted row as
1024 lanes, each scanned down its depths with mixed adds as far as the row's
non-zero digits reach (P4's depth scan); ``cuda_scan.split_tail`` scans the
lane totals into lane offsets, picks each bucket's prefix as its lane's
offset plus its in-lane prefix, and sums the buckets as a tree.  Chunks that
are not a power-of-two multiple of 1024 points take a plain prefix scan, a
gather and a reduction over the buckets, composed of point-add launches.

Per-window totals are returned separately so a chunk loop accumulates
partials per window and the Horner window combine (c doublings per window,
reference semantics = bellman's multiexp recombination, SURVEY.md §2.3) runs
ONCE per MSM instead of once per chunk.
"""

from __future__ import annotations

import os

import torch

from ..ec import cuda_ec
from ..ec import weierstrass as W
from . import cuda_scan
from .pippenger import WINDOW_C, tmap
from .scans import prefix_scan, scan_reduce_last

WORD_BITS = 32


def digits_from_limbs(words: torch.Tensor, c: int, n_windows: int):
    """(n_words, ...) canonical int32 word scalars -> (nw, ...) int32 c-bit
    digits.  Words are widened to int64 and masked, so the shifts are
    unsigned; a window straddles at most two words (c <= 32)."""
    assert c <= WORD_BITS
    w = words.to(torch.int64) & 0xFFFFFFFF
    n = w.shape[0]
    mask = (1 << c) - 1
    outs = []
    for k in range(n_windows):
        l0, s0 = divmod(c * k, WORD_BITS)
        if l0 >= n:
            outs.append(torch.zeros_like(w[0]))
            continue
        d = w[l0] >> s0
        if WORD_BITS - s0 < c and l0 + 1 < n:
            d = d | (w[l0 + 1] << (WORD_BITS - s0))
        outs.append(d & mask)
    return torch.stack(outs, dim=0).to(torch.int32)


def signed_digits_from_limbs(words: torch.Tensor, c: int, n_windows: int):
    """Canonical word scalars -> SIGNED c-bit digits in [-(2^(c-1)-1),
    2^(c-1)] via the standard borrow chain (digit > 2^(c-1) -> subtract
    2^c, carry 1 into the next window).

    Halves the bucket count of the suffix MSM (|digit| <= 2^(c-1); the point
    sign is applied by negating Y, free on a Weierstrass curve).  Requires
    c*n_windows > n_bits of the scalars so the top window cannot carry out
    (255-bit Fr scalars at c=8, nw=32: top raw digit <= 127, +carry <= 128 =
    2^(c-1))."""
    raw = digits_from_limbs(words, c, n_windows)
    half = 1 << (c - 1)
    outs = []
    carry = torch.zeros_like(raw[0])
    for k in range(n_windows):
        v = raw[k] + carry
        wrap = v > half
        outs.append(torch.where(wrap, v - (1 << c), v))
        carry = wrap.to(raw.dtype)
    return torch.stack(outs, dim=0)


class SuffixMsm:
    """Variable-base MSM over one Weierstrass group via suffix sums.

    ``window_partials(points, digits)`` -> per-window totals (nw, *batch);
    ``combine(totals)`` -> final points (*batch).  Split so a chunked caller
    adds partials across chunks and combines once.

    ``signed=True`` (the prover's mode) uses signed c-bit digits
    (|d| <= 2^(c-1), sign applied by negating Y), halving the bucket count.
    Digits must then come from ``self.digits()``.  The sort can be hoisted
    out via ``prep(digits)`` and passed to ``window_partials(points,
    prep=...)`` so MSMs over the SAME scalars (the prover's B1 G1 / B2 G2
    pair) sort once.

    Points handed to ``window_partials`` must be affine-or-infinity
    (Z in {0, one}).  Tensors decide the device; the class holds none.

    ``tail`` picks how a chunk's bucket sums are formed: "totals" (one
    ``window_totals`` launch) or "split" (``split_lanes`` + ``split_tail``); None
    reads ``ZEROCHAIN_MSM_TOTALS`` ("1", the default: totals; "0": split).
    Both give the same points."""

    def __init__(self, field, c: int | None = None, n_bits: int = 255,
                 signed: bool = False, tail: str | None = None):
        if tail is None:
            tail = ("totals" if int(os.environ.get("ZEROCHAIN_MSM_TOTALS", "1"))
                    else "split")
        if tail not in ("totals", "split"):
            raise ValueError(f"unknown suffix-MSM tail {tail!r}")
        self.tail = tail
        self.F = field
        self.c = WINDOW_C if c is None else c
        self.n_bits = n_bits
        self.signed = signed
        nw = -(-n_bits // self.c)
        if signed and self.c * nw <= n_bits:
            nw += 1  # top window must absorb the final borrow carry
        self.n_windows = nw
        self.nb = ((1 << (self.c - 1)) + 1) if signed else (1 << self.c)

    def digits(self, words):
        """Canonical word scalars (n_words, ...) -> digit tensor (nw, ...)
        in this MSM's digit encoding."""
        if self.signed:
            return signed_digits_from_limbs(words, self.c, self.n_windows)
        return digits_from_limbs(words, self.c, self.n_windows)

    def prep(self, digits):
        """digits (nw, N, *batch) -> (sorted_digits, order), both
        (nw, *batch, N) int32, ordered by |digit| DESCENDING.  Separate from
        the scan so callers sharing scalars across MSMs (B1/B2) pay the sort
        once."""
        digits_m = digits.movedim(1, -1).contiguous()  # (nw, *batch, N)
        N = digits_m.shape[-1]
        mag = digits_m.abs() if self.signed else digits_m
        nbits_idx = max(1, (N - 1).bit_length())
        # pack (|digit|, index) into ONE key so a single-tensor sort does the
        # work; |digit| <= 2^c and index < N must fit 31 bits
        if self.c + 1 + nbits_idx > 31:
            raise ValueError(
                f"packed sort key overflows int32 (c={self.c}, N={N})")
        iota = torch.arange(N, dtype=torch.int32, device=digits.device)
        packed = (mag.to(torch.int32) << nbits_idx) | iota
        packed_desc, _ = torch.sort(packed, dim=-1, descending=True)
        order = packed_desc & ((1 << nbits_idx) - 1)
        sorted_digits = torch.gather(digits_m, -1, order.to(torch.int64))
        return sorted_digits.to(torch.int32), order

    def window_partials(self, points, digits=None, prep=None):
        """points: leaves (12, N); digits (nw, N, *batch) or a prep ->
        per-window totals, leaves (12, nw, *batch): one kernel launch for
        all windows of all proofs."""
        sorted_digits, order = prep if prep is not None else self.prep(digits)
        if order.shape[0] != self.n_windows:
            raise ValueError(
                f"prep holds {order.shape[0]} windows, not {self.n_windows}")
        if self.tail == "split":
            return self._split_partials(points, sorted_digits, order)
        return cuda_scan.window_totals(self.F, points, sorted_digits, order,
                                       self.nb)

    def column_split(self, n: int) -> bool:
        """Whether the split tail takes a chunk of n points in 1024 lanes
        (``split_lanes`` + ``split_tail``): n a power-of-two multiple of
        1024."""
        VL = cuda_scan.VL
        return n % VL == 0 and n & (n - 1) == 0 and self.nb - 1 <= VL

    def column_layout(self, points, sorted_digits, order):
        """The chunk's points sorted per program and laid out column-major
        (``cuda_scan.logical_to_phys``), Y negated where the digit is
        negative: leaves (12, *lead, N), the input of ``column_scan``."""
        N = order.shape[-1]
        lead = tuple(order.shape[:-1])
        perm = cuda_scan.phys_perm(N, order.device)
        phys_order = order.index_select(-1, perm).to(torch.int64)
        pts_cm = tmap(lambda a: a.index_select(1, phys_order.reshape(-1))
                      .reshape(12, *lead, N), points)
        if self.signed:
            pts_cm = cuda_scan._neg_y_where(
                self.F, pts_cm, (sorted_digits < 0).index_select(-1, perm))
        return pts_cm

    def _split_partials(self, points, sorted_digits, order):
        """The split tail: points leaves (12, N); sorted_digits, order
        (*lead, N), |digit| descending -> totals (12, *lead)."""
        F = self.F
        N = order.shape[-1]
        if self.column_split(N):
            lanes, slots = cuda_scan.split_lanes(F, points, sorted_digits,
                                                 order, self.nb)
            return cuda_scan.split_tail(F, lanes, slots, sorted_digits, self.nb)
        lead = tuple(order.shape[:-1])
        cnt = cuda_scan.bucket_counts(sorted_digits, self.nb)
        idx = (cnt - 1).clamp(min=0).to(torch.int64)
        pts_s = tmap(lambda a: a.index_select(
            1, order.reshape(-1).to(torch.int64)).reshape(12, *lead, N),
            points)
        if self.signed:
            pts_s = cuda_scan._neg_y_where(F, pts_s, sorted_digits < 0)
        pre = prefix_scan(F, pts_s)
        picked = tmap(lambda a: torch.gather(a, -1, idx.expand(12, *idx.shape)),
                      pre)
        ident = W.identity(F, tuple(cnt.shape), cnt.device)
        picked = W.select(F, cnt == 0, ident, picked)
        return scan_reduce_last(F, picked, self.nb - 1)

    def combine(self, totals):
        """Per-window totals (window axis in front of the batch) -> final
        point: Horner MSB-first, c doublings + 1 add per window, in one
        launch of the Horner kernel (``cuda_ec.horner``)."""
        return cuda_ec.horner(self.F, totals, self.c)

    def __call__(self, points, digits):
        """points: leaves (12, N); digits (nw, N, *batch) -> Jacobian point
        leaves (12, *batch)."""
        return self.combine(self.window_partials(points, digits))
