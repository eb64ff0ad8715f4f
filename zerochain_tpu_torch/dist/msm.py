"""Points-sharded MSMs over a process group (the counterpart of
``zerochain_tpu/dist/msm.py``).

Rank r of n takes the points r * N / n .. (r + 1) * N / n of the chunk and
their scalars, computes its partial sum on its own device, and the partial
points (one leaf tensor of all coordinates) are all-gathered and added in
rank order with ``W.add``, as the JAX package's ``lax.scan`` over the
gathered partials does, so every rank ends with the same words.  Proof-batch
axes ride through: bits (n_bits, N, *B), digits (nw, N, *B).  G1 (``FqOps``)
and G2 (``Fq2Ops``).
"""

from __future__ import annotations

import torch

from ..ec import weierstrass as W
from ..ec.fields import FqOps
from ..msm import pippenger as pip
from . import comm


def _local(n: int, group):
    """-> the slice of n points this rank takes; n must divide by the world
    size."""
    rank, size = comm.world(group)
    if n % size:
        raise ValueError(f"{n} points do not divide over {size} ranks")
    step = n // size
    return slice(rank * step, (rank + 1) * step), step


def _gather_reduce(F, part, group):
    """Each rank's partial point (leaves (12, *lead)) -> their sum in rank
    order, the same words on every rank: one all-gather, n - 1 adds."""
    leaves = [t for coord in part for t in F.leaves(coord)]
    gathered = comm.all_gather(torch.stack(leaves), group)  # (n, k, 12, ...)

    def point(g):
        if F.ncomp == 1:
            return (g[0], g[1], g[2])
        return tuple((g[2 * i], g[2 * i + 1]) for i in range(3))

    acc = point(gathered[0])
    for g in gathered[1:]:
        acc = W.add(F, acc, point(g))
    return acc


def sharded_msm(field, points_jac, bits, group=None,
                use_pippenger: bool | None = None, msm=None):
    """points_jac: Jacobian leaves (12, N); bits (n_bits, N, *B) -> one
    Jacobian point a batch element, leaves (12, *B), on every rank.

    Each rank runs the bucket MSM over its slice (``msm``, or ``pip.Msm``
    of the field with its defaults), or where ``use_pippenger`` is false
    (None: false below 64 local points, as in the JAX package) the naive
    double-and-add and a tree sum (bits (n_bits, N) only)."""
    sl, n_local = _local(bits.shape[1], group)
    pts = pip.tmap(lambda a: a[:, sl], points_jac)
    local_bits = bits[:, sl]
    if use_pippenger is None:
        use_pippenger = n_local >= 64
    if use_pippenger:
        part = (msm or pip.Msm(field))(pts, local_bits)
    else:
        part = pip.naive_msm(field, pts, local_bits)
    return _gather_reduce(field, part, group)


def sharded_msm_g1(points_jac, bits, group=None,
                   use_pippenger: bool | None = None):
    """``sharded_msm`` over G1."""
    return sharded_msm(FqOps, points_jac, bits, group, use_pippenger)


def sharded_suffix(msm, points_jac, digits, group=None):
    """The suffix MSM (``msm/suffix.SuffixMsm``) sharded over the chunk's
    point axis: points leaves (12, N); digits (nw, N, *B) raw, in msm's
    encoding.  Each rank sorts and scans its LOCAL slice (``msm.prep``, then
    ``window_partials``): the sort must stay local, since a global order
    would make every rank gather points from the others.  The per-window
    partial points (leaves (12, nw, *B)) are all-gathered and added in rank
    order, so this returns what ``msm.window_partials`` returns and the
    prover's chunk loop and single Horner combine are unchanged."""
    sl, _ = _local(digits.shape[1], group)
    pts = pip.tmap(lambda a: a[:, sl], points_jac)
    part = msm.window_partials(pts, prep=msm.prep(digits[:, sl]))
    return _gather_reduce(msm.F, part, group)
