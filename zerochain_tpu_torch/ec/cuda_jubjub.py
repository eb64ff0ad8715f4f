"""The witness stage's Jubjub chains, each in one kernel launch.

``var_chain`` and ``fixed_chain`` wrap the two kernels of
``csrc/jubjub_kernels.cu``: the variable-base double-and-add of
``prover/witness.py: compute_var_mul_chains`` and the fixed-base window sums
of ``compute_fixed_base_chains``, one thread a chain.  The JAX package runs
both as ``lax.scan`` loops over its field kernels
(``zerochain_tpu/prover_tpu/witness.py``); ``var_chain_plain`` and
``fixed_chain_plain`` are those loops over the plain field ops
(``ec/jubjub.py`` with ``PLAIN_OPS``), and the kernels return their words
exactly.  A wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.

Both return the projective X, Y, Z of every recorded point, stacked as
``(3, 8, n_steps, *lanes)`` int32 words (Montgomery form), for one batched
inversion to normalise.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ff import limbs as L
from . import jubjub as ej

FR = L.FR

launches = {"var_chain": 0, "fixed_chain": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------
def stack_xyz(points):
    """k extended points (8, *lanes) -> (3, 8, k, *lanes)."""
    return torch.stack([torch.stack([p[c] for p in points], dim=1)
                        for c in range(3)])


def var_chain_plain(bases, bits, ops=ej.PLAIN_OPS):
    """bases: affine (x, y), each (8, *lanes); bits (n, *lanes), 0 or 1.
    Per step: sel = bit ? cur : identity; res = res + sel; record cur and
    res; cur = 2 cur (not after the last step).  -> (cur, res), each
    (3, 8, n, *lanes).  ``ops``: the Fr ops the loop is composed of."""
    lanes = bits.shape[1:]
    cur = ej.ext_from_affine(*bases, ops)
    res = ej.identity(lanes, bits.device)
    ident = ej.identity(lanes, bits.device)
    curs, results = [], []
    n = bits.shape[0]
    for i in range(n):
        sel = ej.select(bits[i].to(torch.bool), cur, ident)
        res = ej.add(res, sel, ops)  # identity + sel == sel projectively
        curs.append(cur)
        results.append(res)
        if i + 1 < n:
            cur = ej.double(cur, ops)
    return stack_xyz(curs), stack_xyz(results)


def fixed_chain_plain(lx, ly, ops=ej.PLAIN_OPS):
    """lx, ly: affine window points (8, n_win, *lanes).  From window 0's
    point, add each next window's and record the sum: -> (3, 8, n_win - 1,
    *lanes)."""
    cur = ej.ext_from_affine(lx[:, 0], ly[:, 0], ops)
    results = []
    for w in range(1, lx.shape[1]):
        cur = ej.add(cur, ej.ext_from_affine(lx[:, w], ly[:, w], ops), ops)
        results.append(cur)
    return stack_xyz(results)


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------
def _fn(name):
    fn = getattr(_build.lib("jubjub_kernels"), name)
    if not getattr(fn, "_typed", False):
        if name == "zc_jj_var_chain":
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def _words(name, t, lead):
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: Fr words are int32, got {t.dtype}")
    if tuple(t.shape[:len(lead)]) != lead:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {lead} in front")


def _device(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("chain inputs on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def var_chain(bases, bits):
    """The variable-base chains of ``var_chain_plain`` in one launch:
    bases (x, y) each (8, *lanes), bits (n, *lanes) of any integer type."""
    x, y = bases
    lanes = tuple(bits.shape[1:])
    _words("var_chain bases", x, (FR.n, *lanes))
    _words("var_chain bases", y, (FR.n, *lanes))
    if x.shape != y.shape or x.dim() != bits.dim():
        raise ValueError(f"var_chain: bases {tuple(x.shape)} / {tuple(y.shape)} "
                         f"do not match bits {tuple(bits.shape)}")
    dev = _device(x, y, bits)
    n = bits.shape[0]
    if n < 1:
        raise ValueError("var_chain needs at least one bit")
    if dev.type == "cpu":
        return var_chain_plain(bases, bits)
    count = bits[0].numel()
    cur = torch.empty((3, FR.n, n, *lanes), dtype=torch.int32, device=dev)
    res = torch.empty_like(cur)
    if count == 0:
        return cur, res
    x, y = x.contiguous(), y.contiguous()
    b8 = (bits != 0).to(torch.uint8).contiguous()
    with torch.cuda.device(dev):
        rc = _fn("zc_jj_var_chain")(
            x.data_ptr(), y.data_ptr(), b8.data_ptr(), cur.data_ptr(),
            res.data_ptr(), n, count, torch.cuda.current_stream().cuda_stream)
    launches["var_chain"] += 1
    if rc != 0:
        raise RuntimeError(f"jubjub var_chain: CUDA error {rc}")
    return cur, res


def fixed_chain(lx, ly):
    """The fixed-base window sums of ``fixed_chain_plain`` in one launch:
    lx, ly (8, n_win, *lanes)."""
    _words("fixed_chain lx", lx, (FR.n,))
    if lx.shape != ly.shape or lx.dim() < 2:
        raise ValueError(f"fixed_chain: lx {tuple(lx.shape)} and ly "
                         f"{tuple(ly.shape)} must be (8, n_win, *lanes)")
    _words("fixed_chain ly", ly, (FR.n,))
    dev = _device(lx, ly)
    n_win = lx.shape[1]
    if n_win < 2:
        raise ValueError("fixed_chain needs at least two windows")
    if dev.type == "cpu":
        return fixed_chain_plain(lx, ly)
    lanes = tuple(lx.shape[2:])
    count = lx[0, 0].numel()
    out = torch.empty((3, FR.n, n_win - 1, *lanes), dtype=torch.int32, device=dev)
    if count == 0:
        return out
    lx, ly = lx.contiguous(), ly.contiguous()
    with torch.cuda.device(dev):
        rc = _fn("zc_jj_fixed_chain")(
            lx.data_ptr(), ly.data_ptr(), out.data_ptr(), n_win, count,
            torch.cuda.current_stream().cuda_stream)
    launches["fixed_chain"] += 1
    if rc != 0:
        raise RuntimeError(f"jubjub fixed_chain: CUDA error {rc}")
    return out
