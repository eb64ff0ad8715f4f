"""Exact prime-field arithmetic on 32-bit words.

Layout: words lead.  An element batch is an ``int32`` tensor
``(n_words, *batch)`` of word bit patterns, least significant first; the
kernels read it limb-major, so neighbouring threads touch neighbouring
addresses.  All public ops keep canonical form (value in [0, p)) and work in
the Montgomery domain unless named otherwise.

Fq has 12 words (R = 2^384), Fr and Fs 8 (R = 2^256).  The four base ops
(``mont_mul``, ``mont_sqr``, ``add``, ``sub``) and the inverse are the
kernels of ``cuda_ff.py``; everything else here is composed of them.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from ..mirror import field as mf
from . import cuda_ff

WORD_BITS = 32


def _int_to_words(v: int, n: int) -> np.ndarray:
    """int -> (n,) int32 word bit patterns."""
    assert 0 <= v < 1 << (WORD_BITS * n), "value does not fit in words"
    raw = v.to_bytes(4 * n, "little")
    return np.frombuffer(raw, dtype="<u4").astype(np.uint32).view(np.int32).copy()


def ints_to_words_np(values, n: int) -> np.ndarray:
    """ints -> (n, len(values)) int32 word planes (numpy, host)."""
    raw = b"".join(int(v).to_bytes(4 * n, "little") for v in values)
    arr = np.frombuffer(raw, dtype="<u4").reshape(len(values), n)
    return arr.T.copy().view(np.int32)


def words_to_ints_np(arr: np.ndarray) -> list[int]:
    """(n, N) int32 word planes -> ints."""
    a = np.ascontiguousarray(np.asarray(arr).view(np.uint32).T).astype("<u4")
    n = a.shape[1]
    raw = a.tobytes()
    return [int.from_bytes(raw[4 * n * j: 4 * n * (j + 1)], "little")
            for j in range(a.shape[0])]


@dataclass(frozen=True)
class FieldSpec:
    """Prime field on 32-bit words with its Montgomery constants."""

    name: str
    p: int
    n: int  # words; R = 2^(32n) > 2p required
    r_mod_p: int = dfield(init=False, repr=False, compare=False)
    r2_mod_p: int = dfield(init=False, repr=False, compare=False)

    def __post_init__(self):
        # R > 2p so that add() never carries out of the top word
        assert (1 << (WORD_BITS * self.n)) > 2 * self.p
        r = pow(2, WORD_BITS * self.n, self.p)
        object.__setattr__(self, "r_mod_p", r)
        object.__setattr__(self, "r2_mod_p", r * r % self.p)

    # ---- host-side conversions -------------------------------------
    def array(self, values, device, mont: bool = False) -> torch.Tensor:
        """ints -> (n, len(values)) tensor; optionally Montgomery form."""
        vals = [v % self.p for v in values]
        if mont:
            vals = [v * self.r_mod_p % self.p for v in vals]
        return torch.from_numpy(ints_to_words_np(vals, self.n)).to(device)

    def to_ints(self, arr, mont: bool = False) -> list[int]:
        a = arr.detach().cpu().numpy().reshape(self.n, -1)
        vals = words_to_ints_np(a)
        if mont:
            rinv = pow(self.r_mod_p, -1, self.p)
            vals = [v * rinv % self.p for v in vals]
        return vals

    def const(self, v: int, like: torch.Tensor) -> torch.Tensor:
        """Raw word value v as a tensor broadcastable against ``like``."""
        key = (v, str(like.device))
        cache = _CONST_CACHE.setdefault(self.name, {})
        t = cache.get(key)
        if t is None:
            t = torch.from_numpy(_int_to_words(v, self.n)).to(like.device)
            cache[key] = t
        return t.reshape((self.n,) + (1,) * (like.dim() - 1))


_CONST_CACHE: dict = {}

FQ = FieldSpec("Fq", mf.Q, 12)  # R = 2^384
FR = FieldSpec("Fr", mf.R, 8)   # R = 2^256
FS = FieldSpec("Fs", mf.S, 8)   # R = 2^256


# ---------------------------------------------------------------------
# basic modular ops (canonical words in, canonical words out)
# ---------------------------------------------------------------------
def zeros(spec: FieldSpec, batch=(), device=None):
    return torch.zeros((spec.n, *batch), dtype=torch.int32, device=device)


def ones_mont(spec: FieldSpec, batch=(), device=None):
    """Montgomery one (= R mod p), broadcast over batch."""
    z = zeros(spec, batch, device)
    return z + spec.const(spec.r_mod_p, z)


def add(spec: FieldSpec, a, b):
    return cuda_ff.add(spec, a, b)


def sub(spec: FieldSpec, a, b):
    return cuda_ff.sub(spec, a, b)


def neg(spec: FieldSpec, a):
    return cuda_ff.sub(spec, torch.zeros_like(a), a)


def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product aR * bR -> abR."""
    return cuda_ff.mont_mul(spec, a, b)


def mont_sqr(spec: FieldSpec, a):
    return cuda_ff.mont_sqr(spec, a)


def is_zero(a):
    return (a == 0).all(dim=0)


def eq(a, b):
    return (a == b).all(dim=0)


def select(cond, a, b):
    """cond broadcast over batch dims: where(cond, a, b)."""
    return torch.where(cond[None, ...], a, b)


def to_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, spec.const(spec.r2_mod_p, a))


def from_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, spec.const(1, a))


def pow_fixed(spec: FieldSpec, a, e: int):
    """a^e for a static exponent e >= 1 (a in Montgomery form). Batched."""
    assert e >= 1
    acc = a
    for bit in bin(e)[3:]:  # MSB first, the leading 1 starts from a
        acc = mont_sqr(spec, acc)
        if bit == "1":
            acc = mont_mul(spec, acc, a)
    return acc


def inv_mont(spec: FieldSpec, a):
    """Inverse in the Montgomery domain, elementwise (zero -> zero): one
    ``cuda_ff.inv`` launch."""
    return cuda_ff.inv(spec, a)


def batch_inv_mont(spec: FieldSpec, a, axis=-1):
    """Batched inverse (the JAX package's Montgomery trick along ``axis``).
    Every element's inverse is independent of the others, so the axis only
    names the batch: one ``cuda_ff.inv`` launch inverts the whole tensor.
    Zero entries yield zero."""
    if axis < 0:
        axis = a.dim() + axis
    assert axis != 0, "axis 0 is the word axis"
    return cuda_ff.inv(spec, a)
