"""Shared MSM helpers and the fixed-base MSM.

`FixedBaseMsm` covers the CRS-generation pattern (one base, many scalars)
with a precomputed (n_windows, 2^c) table + gather + log-depth tree add.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..ec import weierstrass as W

WINDOW_C = 8  # default window width in bits


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


def scalars_to_bits_np(scalars, n_bits: int = 255) -> np.ndarray:
    """ints (< 2^256) -> (n_bits, N) int32 LE bit planes (numpy)."""
    n = len(scalars)
    raw = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    sb = np.frombuffer(raw, dtype=np.uint8).reshape(n, 32)
    bits = np.unpackbits(sb, axis=1, bitorder="little")  # (N, 256)
    out = np.zeros((n_bits, n), dtype=np.int32)
    take = min(n_bits, 256)
    out[:take] = bits[:, :take].T
    return out


def scalars_to_bits(scalars, n_bits: int = 255, device=None) -> torch.Tensor:
    """Host ints -> (n_bits, N) LE bit tensor."""
    return torch.from_numpy(scalars_to_bits_np(list(scalars), n_bits)).to(device)


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
