"""Montgomery field kernels for Hopper: ``mont_mul``, ``mont_sqr``, ``add``, ``sub``, ``inv``.

Each public function here is a wrapper around one CUDA kernel of
``csrc/ff_kernels.cu`` (the counterpart of the Pallas field kernels of
``zerochain_tpu/ff/pallas_ff.py``) and has its plain PyTorch version beside
it.  A wrapper takes the plain version only when its tensors lie on the CPU;
for a CUDA tensor it launches the kernel or raises.

``inv`` inverts every element in one launch (a Fermat power a thread); its
plain version ``inv_plain`` is the Montgomery trick the JAX package composes
of the four base ops (``zerochain_tpu/ff/limbs.py: batch_inv_mont``).  Zero
maps to zero.

Format: an element batch is an ``int32`` tensor ``(n_words, *batch)`` holding
the bit patterns of 32-bit words, least significant word first, canonical in
``[0, p)``.  Everything is exact integer arithmetic (tolerance 0): the kernel
and the plain version return identical words.

The plain versions widen to ``int64`` and treat words as unsigned (mask after
widening).  A product of two 32-bit words does not fit ``int64`` once summed,
so the plain multiply works on 16-bit limb positions (32-bit words of one
operand times 16-bit halves of the other: column sums < n * 2^48 < 2^52).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

M16 = 0xFFFF
M32 = 0xFFFFFFFF

# launches of each kernel (bumped where the kernel is launched, nowhere else)
launches = {f"{op}.{f}": 0 for f in ("Fq", "Fr", "Fs")
            for op in ("mont_mul", "mont_sqr", "add", "sub", "inv")}

_FIELD_ID = {"Fq": 0, "Fr": 1, "Fs": 2}
_OP_ID = {"mont_mul": 0, "mont_sqr": 1, "add": 2, "sub": 3}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------
_CONSTS: dict = {}


def _consts(spec, device):
    """Per (field, device) constant tensors of the plain versions."""
    key = (spec.name, str(device))
    got = _CONSTS.get(key)
    if got is not None:
        return got
    n = spec.n
    L = 2 * n
    p16 = [(spec.p >> (16 * i)) & M16 for i in range(L)]
    rr = 1 << (32 * n)
    pp = (-pow(spec.p, -1, rr)) % rr
    pp16 = [(pp >> (16 * i)) & M16 for i in range(L)]
    # Toeplitz matrices: (x * const) as limb columns = mat @ x_limbs
    low = np.zeros((L, L), np.float64)       # product mod 2^(16L)
    full = np.zeros((2 * L, L), np.float64)  # full 2L-limb product
    for i in range(L):
        for j in range(L):
            if i + j < L:
                low[i + j, i] = pp16[j]
            full[i + j, i] = p16[j]
    got = dict(
        p_words=torch.tensor(
            [(spec.p >> (32 * i)) & M32 for i in range(n)],
            dtype=torch.int64, device=device),
        pprime_low=torch.tensor(low, device=device),
        p_full=torch.tensor(full, device=device),
    )
    _CONSTS[key] = got
    return got


def _widen(a):
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return a.to(torch.int64) & M32


def _narrow(w):
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return ((w << 32) >> 32).to(torch.int32)


def _ripple(t):
    """Exact carry/borrow resolution over the word axis.

    t: (n, *batch) int64 signed word sums.  -> (words in [0, 2^32),
    carry out), the carry negative where the value was negative."""
    # parallel passes: every word keeps its low 32 bits and hands the rest
    # up; a pass moves a carry one word, so chains end within n passes and
    # random words settle in two or three
    carry = torch.zeros_like(t[0])
    while True:
        hi = t >> 32
        if not bool(hi.any()):
            return t, carry
        t = t & M32
        t[1:] += hi[:-1]
        carry = carry + hi[-1]


def _col(v, like):
    return v.reshape((v.shape[0],) + (1,) * (like.dim() - 1))


def _reduce_once(spec, t, signed: bool):
    """Word sums t (int64) of a value v in [0, 2p), or in (-p, p) when
    ``signed``: -> v mod p as int32 words.  The two candidates (v and v - p,
    or v + p and v) ride one carry chain."""
    p = _col(_consts(spec, t.device)["p_words"], t)
    if signed:
        both = torch.stack([t + p, t], dim=1)
    else:
        both = torch.stack([t, t - p], dim=1)
    words, carry = _ripple(both)
    neg = (carry[1] < 0)[None]  # the smaller candidate went negative
    return _narrow(torch.where(neg, words[:, 0], words[:, 1]))


def add_plain(spec, a, b):
    return _reduce_once(spec, _widen(a) + _widen(b), signed=False)


def sub_plain(spec, a, b):
    return _reduce_once(spec, _widen(a) - _widen(b), signed=True)


def _split16(a):
    w = _widen(a)
    return torch.stack([w & M16, w >> 16], dim=1).reshape(
        2 * a.shape[0], *a.shape[1:])


def _weak(t, passes):
    """Nonnegative limb sums -> the same value on smaller limbs: each pass
    maps a bound 2^k to 2^16 + 2^(k-16).  The carry out of the top limb is
    dropped: callers know it is zero, or want the value mod 2^(16 len)."""
    for _ in range(passes):
        hi = t >> 16
        t = t & M16
        t[1:] += hi[:-1]
    return t


def _const_mul(mat, x):
    """Limb columns of x * const: exact in float64 (column sums < 2^53)."""
    flat = x.reshape(x.shape[0], -1).to(torch.float64)
    out = (mat @ flat).to(torch.int64)
    return out.reshape(mat.shape[0], *x.shape[1:])


_OUTER_MAX = 2048  # batch size up to which a*b is one outer product


def _full_product(a, b, n):
    """Columns (16-bit positions, 4n of them) of a * b from 32-bit words of
    a and 16-bit limbs of b: column k = sum_{2i+j=k} a_i * b_j < n * 2^48."""
    L = 2 * n
    batch = a.shape[1:]
    a32 = _widen(a)
    b16 = _split16(b)
    if a32[0].numel() <= _OUTER_MAX:
        outer = a32[:, None] * b16[None, :]                    # (n, L, *b)
        q = torch.cat([outer, torch.zeros_like(outer)], dim=1)  # (n, 2L, *b)
        # row i shifted right by 2i: rows of length 2L-2 over the flat view
        skew = q.reshape(n * 2 * L, *batch)[: n * (2 * L - 2)].reshape(
            n, 2 * L - 2, *batch)
        t = skew.sum(dim=0)
        return torch.cat([t, torch.zeros_like(t[:2])], dim=0)
    t = torch.zeros((2 * L, *batch), dtype=torch.int64, device=a.device)
    for i in range(n):
        t[2 * i: 2 * i + L] += a32[i] * b16
    return t


def mont_mul_plain(spec, a, b):
    """a * b / R mod p by a whole-operand REDC on 16-bit limbs:
    T = a*b; m = (T mod R) * (-1/p) mod R; result = (T + m*p) / R.

    Limb bounds: T columns < 2^52 -> two passes -> < 2^21; m columns
    < 2n * 2^21 * 2^16 < 2^42 -> two passes -> < 2^17, so m < R (1 + 2^-6)
    and the result stays below 2p; T + m*p columns < 2^39 -> three passes
    -> limbs in [0, 2^16]."""
    n = spec.n
    L = 2 * n
    k = _consts(spec, a.device)
    t = _weak(_full_product(a, b, n), 2)
    m = _weak(_const_mul(k["pprime_low"], t[:L]), 2)
    u = _weak(t + _const_mul(k["p_full"], m), 3)
    # the low half of u is a multiple of R below 2R: 0, or R where any
    # (weakly normalised) limb is left
    carry = (u[:L] != 0).any(dim=0).to(torch.int64)
    hi = u[L:].reshape(n, 2, *a.shape[1:])
    words = hi[:, 0] + (hi[:, 1] << 16)
    words[0] += carry
    return _reduce_once(spec, words, signed=False)


def mont_sqr_plain(spec, a):
    return mont_mul_plain(spec, a, a)


def _word_col(spec, v, device):
    """The words of the integer v as an (n, 1) int32 column."""
    words = [(v >> (32 * i)) & M32 for i in range(spec.n)]
    return _narrow(torch.tensor(words, dtype=torch.int64, device=device))[:, None]


def _scan_mul_plain(spec, a, reverse=False):
    """Inclusive prefix (or suffix) products along axis 1 at log depth."""
    k = a.shape[1]
    if reverse:
        a = a.flip(1)
    s = 1
    while s < k:
        a = torch.cat([a[:, :s], mont_mul_plain(spec, a[:, s:], a[:, :k - s])], dim=1)
        s *= 2
    return a.flip(1) if reverse else a


def inv_plain(spec, a):
    """Elementwise inverse in the Montgomery domain, zero -> zero, by the
    Montgomery trick over the flattened batch: one Fermat power plus
    O(k log k) multiplies, a_i^-1 = prefix_{i-1} * suffix_{i+1} / total."""
    flat = a.reshape(spec.n, -1)
    k = flat.shape[1]
    if k == 0:
        return a.clone()
    one = _word_col(spec, spec.r_mod_p, a.device)
    zmask = (flat == 0).all(dim=0)[None]
    safe = torch.where(zmask, one, flat)
    prefix = _scan_mul_plain(spec, safe)
    suffix = _scan_mul_plain(spec, safe, reverse=True)
    total_inv = prefix[:, k - 1:]
    for bit in bin(spec.p - 2)[3:]:  # MSB first, the leading 1 is total
        total_inv = mont_sqr_plain(spec, total_inv)
        if bit == "1":
            total_inv = mont_mul_plain(spec, total_inv, prefix[:, k - 1:])
    before = torch.cat([one, prefix[:, :k - 1]], dim=1)
    after = torch.cat([suffix[:, 1:], one], dim=1)
    invs = mont_mul_plain(spec, mont_mul_plain(spec, before, after),
                          total_inv.expand(spec.n, k))
    return torch.where(zmask, torch.zeros_like(flat), invs).reshape(a.shape)


_PLAIN = {
    "mont_mul": mont_mul_plain,
    "mont_sqr": lambda spec, a, b: mont_sqr_plain(spec, a),
    "add": add_plain,
    "sub": sub_plain,
}


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------
def _fn():
    lib = _build.lib("ff_kernels")
    fn = lib.zc_ff_op
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def _inv_fn():
    fn = _build.lib("ff_kernels").zc_ff_inv
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def _check(spec, x):
    if x.dtype != torch.int32:
        raise TypeError(f"field elements are int32 words, got {x.dtype}")
    if x.dim() < 1 or x.shape[0] != spec.n:
        raise ValueError(
            f"{spec.name} elements have {spec.n} leading words, got "
            f"shape {tuple(x.shape)}")


def _binary(op: str, spec, a, b):
    _check(spec, a)
    _check(spec, b)
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return _PLAIN[op](spec, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty_like(a)
    count = a.numel() // spec.n
    if count == 0:
        return out
    with torch.cuda.device(a.device):
        rc = _fn()(_FIELD_ID[spec.name], _OP_ID[op], a.data_ptr(),
                   b.data_ptr(), out.data_ptr(), count,
                   torch.cuda.current_stream().cuda_stream)
    launches[f"{op}.{spec.name}"] += 1
    if rc != 0:
        raise RuntimeError(f"ff kernel {op}/{spec.name}: CUDA error {rc}")
    return out


def mont_mul(spec, a, b):
    return _binary("mont_mul", spec, a, b)


def mont_sqr(spec, a):
    return _binary("mont_sqr", spec, a, a)


def add(spec, a, b):
    return _binary("add", spec, a, b)


def sub(spec, a, b):
    return _binary("sub", spec, a, b)


def inv(spec, a):
    """a^-1 of every element (zero -> zero), Montgomery in and out."""
    _check(spec, a)
    if a.device.type == "cpu":
        return inv_plain(spec, a)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    a = a.contiguous()
    out = torch.empty_like(a)
    count = a.numel() // spec.n
    if count == 0:
        return out
    with torch.cuda.device(a.device):
        rc = _inv_fn()(_FIELD_ID[spec.name], a.data_ptr(), out.data_ptr(),
                       count, torch.cuda.current_stream().cuda_stream)
    launches[f"inv.{spec.name}"] += 1
    if rc != 0:
        raise RuntimeError(f"ff kernel inv/{spec.name}: CUDA error {rc}")
    return out
