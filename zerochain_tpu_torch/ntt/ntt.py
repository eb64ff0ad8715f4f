"""Batched radix-2 NTT over Fr word tensors.

Replaces the bellman fork's multicore radix-2 FFT (SURVEY.md §2.3):
elements are (8, ..., N) word tensors, transformed along the last axis.
Fr's 2-adicity S = 32 (fr.rs:47) allows sizes up to 2^32; plans are cached
per (size, device).  Oracle: groth16/domain.py.

On a CUDA tensor every transform is ceil(lg d / 11) launches of the pass
kernel of ``csrc/ntt_kernel.cu`` (the counterpart of the JAX package's
stage loop over the Pallas field kernel), with the coset, n^-1 and 1/Z
scalings folded into the first pass's loads and the last pass's stores, and
the quotient's pointwise step one launch of its second kernel.  On a CPU
tensor the plan runs the plain version: the stage loop, each butterfly
stage one batched Montgomery multiply + add + sub over the whole
(batch, N/2) plane with the plain field ops (``*_plain`` below).  Both
return the same canonical words (tolerance 0); any other device raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import _build
from .. import _device
from ..ff import cuda_ff
from ..ff import limbs as L
from ..groth16 import domain as dom
from ..mirror.field import R, FR_GENERATOR, fr_inv

FR = L.FR

TILE_LG = 11  # log2 of the elements of one pass's shared-memory tile

# launches of each kernel (bumped where the kernel is launched, nowhere
# else): the pass kernel by direction, and the pointwise kernel
launches = {"pass_fwd": 0, "pass_inv": 0, "pointwise": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _powers(base: int, count: int) -> list[int]:
    out, cur = [], 1
    for _ in range(count):
        out.append(cur)
        cur = cur * base % R
    return out


def schedule(lg: int, tile_lg: int = TILE_LG) -> list[tuple[int, int]]:
    """The passes of a transform of 2^lg elements as (first stage, stages):
    ceil(lg / tile_lg) passes (one at lg = 0), the larger ones first."""
    n = max(1, math.ceil(lg / tile_lg))
    out, s0 = [], 0
    for i in range(n):
        k = lg // n + (i < lg % n)
        out.append((s0, k))
        s0 += k
    return out


def _pmul(a, b):
    return cuda_ff.mont_mul_plain(FR, *torch.broadcast_tensors(a, b))


def _padd(a, b):
    return cuda_ff.add_plain(FR, a, b)


def _psub(a, b):
    return cuda_ff.sub_plain(FR, a, b)


def _flat(a):
    """(8, *batch, d) -> the (8, M, d) contiguous words (one copy where a is
    a view that is not contiguous)."""
    return a.contiguous().reshape(FR.n, -1, a.shape[-1])


class _Card:
    """Launches the kernels of ``csrc/ntt_kernel.cu`` on the tensors' card."""

    tile_lg = TILE_LG

    @staticmethod
    def _fn(name, argtypes):
        fn = getattr(_build.lib("ntt_kernel"), name)
        if not getattr(fn, "_typed", False):
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fn._typed = True
        return fn

    def ntt_pass(self, src, dst, lg, s0, k, tw, pre, post, post_const, inverse):
        vp = ctypes.c_void_p
        fn = self._fn("zc_ntt_pass", [vp, vp, ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, vp, vp, vp,
                                      ctypes.c_int, vp])
        with torch.cuda.device(src.device):
            rc = fn(src.data_ptr(), dst.data_ptr(), src.shape[1], lg, s0, k,
                    tw.data_ptr(), None if pre is None else pre.data_ptr(),
                    None if post is None else post.data_ptr(), int(post_const),
                    torch.cuda.current_stream().cuda_stream)
        launches["pass_inv" if inverse else "pass_fwd"] += 1
        if rc != 0:
            raise RuntimeError(f"ntt pass kernel: CUDA error {rc}")

    def pointwise(self, a, b, c, z, out):
        vp = ctypes.c_void_p
        fn = self._fn("zc_ntt_pointwise", [vp, vp, vp, vp, vp,
                                           ctypes.c_longlong, vp])
        with torch.cuda.device(a.device):
            rc = fn(a.data_ptr(), None if b is None else b.data_ptr(),
                    None if c is None else c.data_ptr(), z.data_ptr(),
                    out.data_ptr(), a.numel() // FR.n,
                    torch.cuda.current_stream().cuda_stream)
        launches["pointwise"] += 1
        if rc != 0:
            raise RuntimeError(f"ntt pointwise kernel: CUDA error {rc}")


CARD = _Card()


class NttPlan:
    """Precomputed tables for one power-of-two size d on one device."""

    def __init__(self, d: int, device=None):
        assert d & (d - 1) == 0
        self.device = _device.resolve(device)
        self.d = d
        self.lg = d.bit_length() - 1
        omega = dom.omega_for(d)
        omega_inv = fr_inv(omega)

        def mont(vals):
            return FR.array(vals, self.device, mont=True)

        # bit-reversal permutation
        idx = np.arange(d)
        rev = np.zeros(d, dtype=np.int64)
        for b in range(self.lg):
            rev |= ((idx >> b) & 1) << (self.lg - 1 - b)
        self.bitrev = torch.from_numpy(rev).to(self.device)

        # per-stage twiddles: stage s has half-size m = 2^s, twiddles
        # w_m^l = omega^(d/(2m) * l) for l in 0..m-1
        def stage_twiddles(w):
            return [mont(_powers(pow(w, d // (2 << s), R), 1 << s))
                    for s in range(self.lg)]

        self.twiddles = stage_twiddles(omega)
        self.twiddles_inv = stage_twiddles(omega_inv)
        self.n_inv = mont([fr_inv(d)])[:, 0]

        # coset scaling vectors (Montgomery): g^i and g^{-i}
        self.coset = mont(_powers(FR_GENERATOR, d))
        self.coset_inv = mont(_powers(fr_inv(FR_GENERATOR), d))
        # 1 / z(coset) = 1 / (g^d - 1), Montgomery
        self.zinv = mont([fr_inv((pow(FR_GENERATOR, d, R) - 1) % R)])[:, 0]
        self._tables = None

    # -- the kernels' tables, element-major (entries, 8) -----------------
    def tables(self) -> dict:
        """Built at the first kernel call: both directions' twiddles of all
        stages in one (d - 1, 8) tensor (stage s from 2^s - 1); the coset
        powers g^i; n^-1 g^i and n^-1 g^-i, (d, 8); n^-1 and 1/Z, (1, 8)."""
        if self._tables is None:
            def rows(t):
                return t.t().contiguous()

            def cat(tw):
                if not tw:
                    return torch.zeros((1, FR.n), dtype=torch.int32, device=self.device)
                return rows(torch.cat(tw, dim=1))

            n_inv = fr_inv(self.d)
            g, gi = FR_GENERATOR, fr_inv(FR_GENERATOR)
            self._tables = dict(
                tw=cat(self.twiddles), tw_inv=cat(self.twiddles_inv),
                coset=rows(self.coset),
                coset_n=rows(FR.array([n_inv * x % R for x in _powers(g, self.d)],
                                      self.device, mont=True)),
                coset_inv_n=rows(FR.array([n_inv * x % R for x in _powers(gi, self.d)],
                                          self.device, mont=True)),
                n_inv=rows(self.n_inv[:, None]), zinv=rows(self.zinv[:, None]))
        return self._tables

    # -- the kernel path -------------------------------------------------
    def _passes(self, x, launcher, inverse, pre=None, post=None):
        """x: (8, M, d) contiguous -> its transform (a new tensor), the
        first pass times pre[i] at source i, the last times post (a (d, 8)
        vector or a (1, 8) constant)."""
        t = self.tables()
        out = torch.empty_like(x)
        if x.shape[1] == 0:
            return out
        passes = schedule(self.lg, launcher.tile_lg)
        for i, (s0, k) in enumerate(passes):
            last = i == len(passes) - 1
            launcher.ntt_pass(x if i == 0 else out, out, self.lg, s0, k,
                              t["tw_inv" if inverse else "tw"],
                              pre if i == 0 else None, post if last else None,
                              last and post is not None and post.shape[0] == 1,
                              inverse)
        return out

    def _pointwise(self, launcher, a, b=None, c=None):
        out = torch.empty_like(a)
        if a.numel():
            launcher.pointwise(a, b, c, self.tables()["zinv"], out)
        return out

    def kernel(self, name: str, *xs, launcher=CARD):
        """``name`` (ntt, intt, coset_ntt, icoset_ntt, divide_by_z_on_coset,
        quotient) through the kernels, launched by ``launcher`` (the card's,
        or a stand-in that steps the same passes)."""
        flat = [_flat(x) for x in xs]
        t = self.tables()
        if name == "ntt":
            out = self._passes(flat[0], launcher, False)
        elif name == "intt":
            out = self._passes(flat[0], launcher, True, post=t["n_inv"])
        elif name == "coset_ntt":
            out = self._passes(flat[0], launcher, False, pre=t["coset"])
        elif name == "icoset_ntt":
            out = self._passes(flat[0], launcher, True, post=t["coset_inv_n"])
        elif name == "divide_by_z_on_coset":
            out = self._pointwise(launcher, flat[0])
        elif name == "quotient":
            # intt -> coset_ntt as one intt whose stores scale by n^-1 g^i
            # and one plain forward transform; then (a b - c) / Z and the
            # icoset intt, its stores scaled by n^-1 g^-i
            a_c, b_c, c_c = (self._passes(self._passes(e, launcher, True,
                                                       post=t["coset_n"]),
                                          launcher, False) for e in flat)
            q = self._pointwise(launcher, a_c, b_c, c_c)
            out = self._passes(q, launcher, True, post=t["coset_inv_n"])
        else:
            raise ValueError(f"no NTT entry point {name!r}")
        return out.reshape(xs[0].shape)

    def _call(self, name, *xs):
        for x in xs:
            if x.dtype != torch.int32 or x.dim() < 2 or x.shape[0] != FR.n \
                    or x.shape[-1] != self.d:
                raise ValueError(f"expected (8, ..., {self.d}) int32 words, got "
                                 f"{tuple(x.shape)} {x.dtype}")
            if x.shape != xs[0].shape or x.device != xs[0].device:
                raise ValueError("the operands differ in shape or device")
        dev = xs[0].device
        if dev.type == "cpu":
            return getattr(self, name + "_plain")(*xs)
        if dev.type != "cuda" or dev != self.tables()["tw"].device:
            raise ValueError(f"operands on {dev}, the plan's tables on {self.device}")
        return self.kernel(name, *xs)

    # -- public transforms (operate on last axis; word axis 0) ----------
    def ntt(self, a):
        return self._call("ntt", a)

    def intt(self, a):
        return self._call("intt", a)

    def coset_ntt(self, coeffs):
        return self._call("coset_ntt", coeffs)

    def icoset_ntt(self, evals):
        return self._call("icoset_ntt", evals)

    def divide_by_z_on_coset(self, evals):
        return self._call("divide_by_z_on_coset", evals)

    def quotient(self, a_ev, b_ev, c_ev):
        return self._call("quotient", a_ev, b_ev, c_ev)

    # -- plain versions: the stage loop over the plain field ops --------
    def _fft_plain(self, a, twiddles):
        d = self.d
        a = a.index_select(-1, self.bitrev)
        batch = a.shape[1:-1]
        for s in range(self.lg):
            m = 1 << s
            nb = d // (2 * m)
            a = a.reshape(FR.n, *batch, nb, 2, m)
            even = a[..., 0, :]
            odd = a[..., 1, :]
            tw = twiddles[s].reshape(
                (FR.n,) + (1,) * (len(batch) + 1) + (m,))
            t = _pmul(odd, tw)
            a = torch.stack([_padd(even, t), _psub(even, t)], dim=-2)
        return a.reshape(FR.n, *batch, d)

    def _bcast(self, v, like):
        return v.reshape((FR.n,) + (1,) * (like.dim() - 1))

    def _scale(self, a, vec):
        v = vec.reshape((FR.n,) + (1,) * (a.dim() - 2) + (self.d,))
        return _pmul(a, v)

    def ntt_plain(self, a):
        return self._fft_plain(a, self.twiddles)

    def intt_plain(self, a):
        out = self._fft_plain(a, self.twiddles_inv)
        return _pmul(out, self._bcast(self.n_inv, out))

    def coset_ntt_plain(self, coeffs):
        return self.ntt_plain(self._scale(coeffs, self.coset))

    def icoset_ntt_plain(self, evals):
        return self._scale(self.intt_plain(evals), self.coset_inv)

    def divide_by_z_on_coset_plain(self, evals):
        return _pmul(evals, self._bcast(self.zinv, evals))

    def quotient_plain(self, a_ev, b_ev, c_ev):
        a_c, b_c, c_c = (self.coset_ntt_plain(self.intt_plain(e))
                         for e in (a_ev, b_ev, c_ev))
        q = _psub(_pmul(a_c, b_c), c_c)
        return self.icoset_ntt_plain(self.divide_by_z_on_coset_plain(q))


def quotient(plan, a_ev, b_ev, c_ev):
    """Padded constraint evaluations (8, *batch, d) -> the Groth16
    quotient's coefficients h = (A * B - C) / Z: intt -> coset_ntt ->
    pointwise -> divide by Z on the coset -> icoset_ntt, through ``plan``
    (an ``NttPlan``: its kernels, 15 launches at d = 32,768; or a
    ``dist.DistNtt``, which has these transforms)."""
    if isinstance(plan, NttPlan):
        return plan.quotient(a_ev, b_ev, c_ev)
    a_c, b_c, c_c = (plan.coset_ntt(plan.intt(e)) for e in (a_ev, b_ev, c_ev))
    q = L.sub(FR, L.mont_mul(FR, a_c, b_c), c_c)
    return plan.icoset_ntt(plan.divide_by_z_on_coset(q))


_PLANS: dict = {}


def plan_for(d: int, device=None) -> NttPlan:
    dev = _device.resolve(device)
    key = (d, str(dev))
    if key not in _PLANS:
        _PLANS[key] = NttPlan(d, dev)
    return _PLANS[key]
