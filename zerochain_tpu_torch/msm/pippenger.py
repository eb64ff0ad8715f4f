"""Shared MSM helpers, the bucket MSM and the fixed-base MSM.

`Msm` is the bucket MSM of ``zerochain_tpu/msm/pippenger.py``: per window
it sorts the points by digit, sums the runs of equal digits into 2^c buckets
(``bucket_sums``, ec/cuda_ec.py: the kernel that takes the place of the
JAX ``Msm``'s Hillis-Steele levels and scatter) and folds them with the
running-sum trick (``bucket_fold``, ec/cuda_ec.py); the windows combine MSB
first.  ``msm_g1`` and ``msm_g2`` are its host-level entry points (mirror
affine points and int scalars in, an affine point out), which the Groth16
backend (prover/backend.py) hands to ``groth16.core``.

`FixedBaseMsm` covers the CRS-generation pattern (one base, many scalars)
with a precomputed (n_windows, 2^c) table + gather + log-depth tree add.
"""

from __future__ import annotations

import os

import torch

from .. import _device
from ..ec import cuda_ec
from ..ec import weierstrass as W
from ..native.codec import scalars_to_bits_np

# default window width in bits; ZEROCHAIN_MSM_C sets it, as in the JAX package
WINDOW_C = int(os.environ.get("ZEROCHAIN_MSM_C", "8"))
SCAN_MODES = ("hs", "assoc")
# sorted points x coordinate components that one pass of the 'assoc' scan
# holds (its temporaries are a few times that)
_ASSOC_SLAB = 1 << 22


def tmap(fn, pt):
    """Map fn over the leaf tensors of a Jacobian/affine point tuple."""
    return tuple(
        tuple(fn(cc) for cc in comp) if isinstance(comp, tuple) else fn(comp)
        for comp in pt
    )


def tmap2(fn, pa, pb):
    """Map a two-argument fn over the matching leaves of two points."""
    return tuple(
        tuple(fn(x, y) for x, y in zip(ca, cb)) if isinstance(ca, tuple)
        else fn(ca, cb)
        for ca, cb in zip(pa, pb)
    )


def tcat(parts, dim):
    """Concatenate a list of points leaf by leaf along ``dim``."""
    out = parts[0]
    for p in parts[1:]:
        out = tmap2(lambda x, y: torch.cat([x, y], dim=dim), out, p)
    return out


def first_leaf(pt):
    leaf = pt[0]
    return leaf[0] if isinstance(leaf, tuple) else leaf


def scalars_to_bits(scalars, n_bits: int = 255, device=None) -> torch.Tensor:
    """Host ints -> (n_bits, N) LE bit tensor (the native codec's planes)."""
    return torch.from_numpy(scalars_to_bits_np(list(scalars), n_bits)).to(device)


def limbs_to_bits(words: torch.Tensor, n_bits: int = 255) -> torch.Tensor:
    """(n_words, ...) canonical int32 word scalars -> (n_bits, ...) LE bit
    tensor (int32)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    shifts = shifts.reshape(1, 32, *([1] * (words.dim() - 1)))
    # an arithmetic shift of the int32 bit pattern leaves bit k at the bottom
    bits = (words[:, None] >> shifts) & 1
    return bits.reshape(words.shape[0] * 32, *words.shape[1:])[:n_bits]


def digits_from_bits(bits: torch.Tensor, c: int, n_windows: int) -> torch.Tensor:
    """(n_bits, N) bits -> (n_windows, N) c-bit digits (LE windows)."""
    n_bits = n_windows * c
    pad = n_bits - bits.shape[0]
    if pad > 0:
        bits = torch.cat(
            [bits, torch.zeros((pad, *bits.shape[1:]), dtype=bits.dtype,
                               device=bits.device)], dim=0)
    w = bits[:n_bits].reshape(n_windows, c, *bits.shape[1:])
    weights = (1 << torch.arange(c, dtype=bits.dtype, device=bits.device)
               ).reshape(1, c, *([1] * (bits.dim() - 1)))
    return (w * weights).sum(dim=1)


class FixedBaseMsm:
    """Same-base MSM g^{e_i}: windowed table + gather + tree reduction."""

    def __init__(self, field, base_affine, c: int | None = None,
                 n_bits: int = 255, device=None):
        self.F = field
        self.device = _device.resolve(device)
        self.c = WINDOW_C if c is None else c
        self.n_bits = n_bits
        self.n_windows = -(-n_bits // self.c)
        self.table = self._build_table(base_affine)  # leaves (12, nw * 2^c)

    def _build_table(self, base_affine):
        """Host-side windowed table (mirror Jacobian arithmetic):
        table[w][k] = k * 2^{cw} * base, affine (Z = one) or infinity."""
        from ..mirror import curves as cv

        nw, nb = self.n_windows, 1 << self.c
        g1 = self.F.ncomp == 1
        if g1:
            jac, to_aff = cv._G1_JAC, cv._jac_to_affine_g1
        else:
            jac, to_aff = cv._G2_JAC, cv._jac_to_affine_g2

        flat = []
        cur = base_affine
        for _ in range(nw):
            acc = None
            flat.append(None)
            for _ in range(nb - 1):
                acc = jac.add_mixed(acc, cur)
                flat.append(to_aff(acc))
            j = (cur[0], cur[1], jac.one)
            for _ in range(self.c):
                j = jac.double(j)
            cur = to_aff(j)

        zero, one = (0, 1) if g1 else ((0, 0), (1, 0))
        xs = [zero if p is None else p[0] for p in flat]
        ys = [zero if p is None else p[1] for p in flat]
        zs = [zero if p is None else one for p in flat]
        return tuple(self.F.from_ints(v, None, self.device) for v in (xs, ys, zs))

    def __call__(self, bits):
        """bits: (n_bits, N) -> Jacobian leaves (12, N)."""
        F = self.F
        digits = digits_from_bits(bits, self.c, self.n_windows)  # (nw, N)
        nb = 1 << self.c
        base = torch.arange(self.n_windows, device=digits.device) * nb
        flat_idx = (digits.to(torch.int64) + base[:, None]).reshape(-1)
        n = digits.shape[1]
        pts = tmap(
            lambda t: t.index_select(1, flat_idx).reshape(12, self.n_windows, n),
            self.table)

        # tree-reduce over the window axis (1)
        k = self.n_windows
        while k > 1:
            half = k // 2
            s = W.add(F, tmap(lambda x: x[:, :half], pts),
                      tmap(lambda x: x[:, half:2 * half], pts))
            if k % 2:
                last = tmap(lambda x: x[:, k - 1:k], pts)
                s = tmap2(lambda x, y: torch.cat([x, y], dim=1), s, last)
            pts = s
            k = (k + 1) // 2
        return tmap(lambda x: x[:, 0], pts)


# ---------------------------------------------------------------------
# the bucket MSM
# ---------------------------------------------------------------------
class Msm:
    """Variable-base bucket MSM over one Weierstrass group (G1 or G2).

    Digits are unsigned c-bit windows: 2^c buckets, bucket 0 ignored.  A
    row is one window of one proof.  All rows are sorted in one
    ``torch.sort``.  ``mode`` picks how a row's buckets are formed and
    folded; None reads ``ZEROCHAIN_MSM_SCAN`` ("hs" where it is unset), as
    the JAX package does.  Both modes give the same points.

    - ``"hs"``: one ``bucket_sums`` and one ``bucket_fold`` call for all
      rows: on the card one launch each, with no slabs (at 1,024 rows of
      16,384 points the digits, the sorted keys and the order take a few
      hundred MB by their shapes); on the CPU the plain versions,
      ``bucket_sums_plain`` in slabs of rows.
    - ``"assoc"``: the JAX package's work-efficient variant, with no kernel
      of its own: a segmented prefix scan of each sorted row
      (``scans.segmented_prefix_scan``, about 2N adds), the scatter of each
      run's last prefix into its bucket, a suffix scan of the buckets and a
      tree sum of the suffixes, every add a K2 launch (``W.add``); in slabs
      of rows, as the JAX package takes a window group at a time.

    Rows are independent, so on the CPU the 'hs' words are the JAX
    ``Msm``'s, whatever its window group; 'assoc' adds in another order than
    JAX's ``associative_scan``: compare its points after ``normalize``.
    Tensors decide the device."""

    def __init__(self, field, c: int | None = None, n_bits: int = 255,
                 mode: str | None = None):
        self.F = field
        self.c = WINDOW_C if c is None else c
        if not 1 <= self.c <= 30:
            raise ValueError(f"Msm takes windows of 1 to 30 bits, got c={self.c}")
        self.n_bits = n_bits
        self.n_windows = -(-n_bits // self.c)
        if mode is None:
            mode = os.environ.get("ZEROCHAIN_MSM_SCAN", "") or "hs"
        if mode not in SCAN_MODES:
            raise ValueError(f"unknown MSM scan mode {mode!r}; one of {SCAN_MODES}")
        self.mode = mode

    def rows(self, bits):
        """bits (n_bits, N, *B) -> every (window, proof) row of the MSM as
        the kernels take it: (digits ascending, point order), int32
        (n_windows * prod(B), N)."""
        digits = digits_from_bits(bits, self.c, self.n_windows)  # (nw, N, *B)
        keys = digits.movedim(1, -1).reshape(-1, digits.shape[1])
        keys_s, order = torch.sort(keys.to(torch.int32), dim=-1, stable=True)
        return keys_s, order.to(torch.int32)

    def _window_total(self, points, keys_s, order):
        """points: leaves (12, N); keys_s, order: (K, N) sorted rows -> the
        K sums sum_i keys[k, i] * P_i, leaves (12, K)."""
        if self.mode == "assoc":
            return self._window_total_assoc(points, keys_s, order)
        buckets = cuda_ec.bucket_sums(self.F, points, keys_s, order,
                                      1 << self.c)
        return cuda_ec.bucket_fold(self.F, buckets)

    def _window_total_assoc(self, points, keys_s, order):
        """``_window_total`` in the 'assoc' mode (JAX
        ``Msm._window_total``): sorted points, a segmented prefix scan, each
        run's last prefix scattered into its bucket, then sum_v v * B_v =
        sum_{v>=1} S_v with S_v = sum_{u>=v} B_u, the suffixes by a prefix
        scan of the reversed buckets and summed as a tree."""
        from .scans import prefix_scan, segmented_prefix_scan, tree_sum_last

        F = self.F
        K, N = order.shape
        slab = max(1, _ASSOC_SLAB // (N * F.ncomp))
        if K > slab:  # bound the temporaries: slabs of rows
            return tcat([self._window_total_assoc(points, keys_s[k: k + slab],
                                                  order[k: k + slab])
                         for k in range(0, K, slab)], 1)
        nb = 1 << self.c
        dev = order.device
        idx = order.reshape(-1).to(torch.int64)
        pts = tmap(lambda a: a.index_select(1, idx).reshape(12, K, N), points)
        edge = keys_s[:, 1:] != keys_s[:, :-1]
        head = torch.ones((K, 1), dtype=torch.bool, device=dev)
        prefix = segmented_prefix_scan(F, pts, torch.cat([head, edge], -1))
        # each run's last prefix into its bucket; other positions -> a dummy
        # slot that is cut off
        slot = torch.where(torch.cat([edge, head], -1), keys_s, nb)
        slot = slot.to(torch.int64).expand(12, K, N)
        buckets = tmap2(lambda d, src: d.scatter(-1, slot, src)[..., :nb],
                        W.identity(F, (K, nb + 1), dev), prefix)
        # S_{nb-1} .. S_1 (S_0 also holds bucket 0, which is left out)
        suffix = prefix_scan(F, tmap(lambda a: a.flip(-1), buckets))
        return tree_sum_last(F, tmap(lambda a: a[..., : nb - 1], suffix), nb - 1)

    def __call__(self, points_jac, bits):
        """points_jac: Jacobian leaves (12, N); bits: (n_bits, N, *B) ->
        Jacobian leaves (12, *B)."""
        lead = tuple(bits.shape[2:])
        tot = self._window_total(points_jac, *self.rows(bits))
        totals = tmap(lambda a: a.reshape(12, self.n_windows, *lead), tot)
        # combine windows MSB-first: res = 2^c * res + T_w
        return cuda_ec.horner(self.F, totals, self.c)


def naive_msm(field, points_jac, bits):
    """Per-point scalar mul + tree sum, for small N; points_jac: leaves
    (12, N) (their Z is not read: affine or padding), bits (n_bits, N)."""
    from .scans import tree_sum_last

    p = W.scalar_mul_bits(field, (points_jac[0], points_jac[1]), bits)
    return tree_sum_last(field, p, bits.shape[-1])


# ---------------------------------------------------------------------
# host API
# ---------------------------------------------------------------------
def _pad_size(n: int) -> int:
    """Round up to a power of two, at least 64."""
    size = 64
    while size < n:
        size *= 2
    return size


def _msm_host(grp, field, points, scalars, device=None):
    """Host-level MSM: mirror affine points + int scalars -> affine point
    (None for infinity).  Pairs with an infinite point or a zero scalar are
    dropped; the rest is padded (identity points, zero scalars) to
    ``_pad_size``: up to 64 points by double-and-add, else by ``Msm``."""
    dev = _device.resolve(device)
    pairs = [(p, s) for p, s in zip(points, scalars) if p is not None and s]
    if not pairs:
        return None
    pts, scs = zip(*pairs)
    n = len(pts)
    padded = _pad_size(n)
    pts = list(pts) + [None] * (padded - n)
    scs = list(scs) + [0] * (padded - n)
    jac = grp.from_affine_host(pts, device=dev)
    bits = scalars_to_bits(scs, 255, dev)
    if padded <= 64:
        res = naive_msm(field, jac, bits)
    else:
        res = Msm(field)(jac, bits)
    return grp.to_affine_host(tmap(lambda a: a[..., None], res))[0]


def msm_g1(points, scalars, device=None):
    from ..ec import g1 as grp
    from ..ec.fields import FqOps

    return _msm_host(grp, FqOps, points, scalars, device)


def msm_g2(points, scalars, device=None):
    from ..ec import g2 as grp
    from ..ec.fields import Fq2Ops

    return _msm_host(grp, Fq2Ops, points, scalars, device)
