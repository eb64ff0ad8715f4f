"""Jacobian point add and double kernels for G1 and G2.

``add`` and ``double`` are wrappers around the kernels of
``csrc/ec_kernels.cu`` (the counterpart of the fused group-law kernels of
``zerochain_tpu/ec/pallas_ec.py``); ``add_plain`` and ``double_plain`` are
the plain PyTorch versions of the same functions, composed of field ops.  A
wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.

Both sides evaluate the same formulas (dbl-2009-l; add-2007-bl with the
cases P = inf, Q = inf, P = Q, P = -Q) on canonical field elements, so the
kernel and the plain version return identical words (tolerance 0).

``ladder`` and ``horner`` wrap the two chain kernels of the same file: the
little-endian double-and-add over bit planes (``scalar_mul_bits_jac``) and
the MSB-first window combine ``res = 2^c * res + T_w`` of the MSMs, each in
one launch, one group of lanes per point (``csrc/group_program.cuh``).  The
JAX package runs both as one compiled loop over its group-law kernels;
``ladder_plain`` and ``horner_plain`` are those loops over ``add_plain`` and
``double_plain``, and the kernels return their words exactly.

``bucket_fold`` wraps the third chain kernel of that file, the bucket MSM's
running-sum fold (``Msm._window_total`` of the JAX package: for v = nb - 1
.. 1, ``running += B[v]; total += running``), one group of lanes a row;
``bucket_fold_plain`` is that loop over ``add_plain`` and the kernel returns
its words exactly.

``hs_add_select`` wraps ``csrc/hs_kernel.cu`` (the counterpart of the fused
Hillis-Steele level ``hs_add_select`` of the same JAX module): one level of
a segmented prefix scan, ``out = (f | keep) ? x : add(xl, x)``;
``hs_add_select_plain`` is its plain version.  ``bucket_sums`` wraps the
other entry of that file, ``zc_hs_bucket_sums``, the bucket sums of the
bucket MSM (``msm.pippenger.Msm``): for every row m (one window of one proof)
of sorted digits ``keys_s[m]`` with their point indices ``order[m]``,
``bucket[m, v]`` = the sum of the points whose digit is v, for v = 1 .. nb -
1, bucket 0 and empty buckets the identity.  It takes the place of the JAX
``Msm``'s sorted copy, Hillis-Steele levels and scatter;
``bucket_sums_plain`` is that composition over ``hs_add_select_plain``, whose
words are the JAX ``Msm``'s.  The kernel adds each run in another order (one
add a point along its slice, the slices' pieces after), so the two agree as
group elements: compare after ``normalize``.  The points may have any Z.

Points: (X, Y, Z), each coordinate a field element of ``F`` (``FqOps``: one
``(12, *batch)`` int32 tensor; ``Fq2Ops``: a pair of them); infinity <=>
Z == 0.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = {"g1_add": 0, "g1_double": 0, "g2_add": 0, "g2_double": 0,
            "g1_ladder": 0, "g2_ladder": 0, "g1_horner": 0, "g2_horner": 0,
            "g1_bucket_fold": 0, "g2_bucket_fold": 0,
            "g1_hs_add_select": 0, "g2_hs_add_select": 0,
            "g1_bucket_sums": 0, "g2_bucket_sums": 0}

# Lanes per point of the chain kernels: 32 spreads a step's independent
# multiplies over a warp; 1 runs the same program on one lane per point.
CHAIN_LANES = 32


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------
def _batched(F, op, pairs):
    """[op(a, b) for a, b in pairs] in ONE field call: the operands ride a
    new batch axis.  Field results are canonical, so the words are those of
    the separate calls; on small batches this saves most of the per-call
    cost of the plain field ops."""
    k = len(pairs)
    stack = lambda *ts: torch.stack(torch.broadcast_tensors(*ts), dim=1)  # noqa: E731
    a = F.map(stack, *[x for x, _ in pairs])
    b = F.map(stack, *[y for _, y in pairs])
    r = op(a, b)
    return [F.map(lambda t, i=i: t[:, i], r) for i in range(k)]


def double_plain(F, p):
    """dbl-2009-l; infinity propagates (Z3 = 2YZ = 0)."""
    F = F.plain
    X, Y, Z = p
    a, b, yz = _batched(F, F.mul, [(X, X), (Y, Y), (Y, Z)])
    e, xb, z3 = _batched(F, F.add, [(a, a), (X, b), (yz, yz)])
    e = F.add(e, a)
    c, t, f = _batched(F, F.mul, [(b, b), (xb, xb), (e, e)])
    d1 = F.sub(F.sub(t, a), c)
    d, c2 = _batched(F, F.add, [(d1, d1), (c, c)])
    d2, c4 = _batched(F, F.add, [(d, d), (c2, c2)])
    x3 = F.sub(f, d2)
    c8 = F.add(c4, c4)
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    return (x3, y3, z3)


def add_plain(F, p, q):
    """Complete-by-masking Jacobian addition (add-2007-bl + cases)."""
    F = F.plain
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    zs = F.add(Z1, Z2)
    z1z1, z2z2, y1z2, y2z1, zz = _batched(
        F, F.mul, [(Z1, Z1), (Z2, Z2), (Y1, Z2), (Y2, Z1), (zs, zs)])
    u1, u2, s1, s2 = _batched(
        F, F.mul, [(X1, z2z2), (X2, z1z1), (y1z2, z2z2), (y2z1, z1z1)])
    h, r = _batched(F, F.sub, [(u2, u1), (s2, s1)])
    h2, r2, zsq = _batched(F, F.add, [(h, h), (r, r), (z1z1, z2z2)])
    i, rr2, zh = _batched(F, F.mul, [(h2, h2), (r2, r2), (F.sub(zz, zsq), h)])
    j, v = _batched(F, F.mul, [(h, i), (u1, i)])
    x3 = F.sub(F.sub(rr2, j), F.add(v, v))
    s1j, t = _batched(F, F.mul, [(s1, j), (r2, F.sub(v, x3))])
    y3 = F.sub(t, F.add(s1j, s1j))
    z3 = zh

    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    x_eq = F.is_zero(h)
    y_eq = F.is_zero(r)

    batch = F.batch_shape(X1)
    dev = F.device(X1)
    inf = (F.ones(batch, dev), F.ones(batch, dev), F.zeros(batch, dev))

    res = (x3, y3, z3)
    # same point -> double (the doubling is computed only if some lane asks)
    same = x_eq & y_eq
    if bool(same.any()):
        dbl = double_plain(F, p)
        res = tuple(F.select(same, d, r_) for d, r_ in zip(dbl, res))
    # same x, different y (neither infinite) -> infinity
    to_inf = x_eq & ~y_eq & ~(p_inf | q_inf)
    res = tuple(F.select(to_inf, i_, r_) for i_, r_ in zip(inf, res))
    res = tuple(F.select(q_inf, a, r_) for a, r_ in zip(p, res))
    res = tuple(F.select(p_inf, b, r_) for b, r_ in zip(q, res))
    return res


def _select(F, cond, p, q):
    return tuple(F.select(cond, a, b) for a, b in zip(p, q))


def ladder_plain(F, base_jac, bits):
    """Little-endian double-and-add: acc = identity, cur = base; per bit
    acc = bit ? acc + cur : acc, cur = 2 * cur (not after the last bit)."""
    F = F.plain
    batch = F.batch_shape(base_jac[0])
    dev = F.device(base_jac[0])
    acc = (F.ones(batch, dev), F.ones(batch, dev), F.zeros(batch, dev))
    cur = base_jac
    n_bits = bits.shape[0]
    for k in range(n_bits):
        cand = add_plain(F, acc, cur)
        acc = _select(F, bits[k].to(torch.bool), cand, acc)
        if k + 1 < n_bits:
            cur = double_plain(F, cur)
    return acc


def horner_plain(F, totals, c: int):
    """Per-window totals, window axis in front of the batch (leaves (12, nw,
    *batch)) -> res = T[nw-1]; res = 2^c * res + T[w] for w = nw-2 .. 0."""
    F = F.plain
    nw = F.leaves(totals[0])[0].shape[1]
    res = tuple(F.map(lambda a: a[:, nw - 1], t) for t in totals)
    for w in range(nw - 2, -1, -1):
        for _ in range(c):
            res = double_plain(F, res)
        res = add_plain(F, res, tuple(F.map(lambda a, w=w: a[:, w], t)
                                      for t in totals))
    return res


def bucket_fold_plain(F, buckets):
    """Bucket sums (leaves (12, *batch, nb)) -> sum_v v * B[v]: running =
    total = identity; for v = nb-1 .. 1: running += B[v], total += running.
    Bucket 0 is not read."""
    F = F.plain
    leaf = F.leaves(buckets[0])[0]
    nb = leaf.shape[-1]
    batch = tuple(leaf.shape[1:-1])
    dev = leaf.device
    running = (F.ones(batch, dev), F.ones(batch, dev), F.zeros(batch, dev))
    total = running
    for v in range(nb - 1, 0, -1):
        running = add_plain(F, running, tuple(
            F.map(lambda a, v=v: a[..., v], t) for t in buckets))
        total = add_plain(F, total, running)
    return total


def hs_add_select_plain(F, xl, x, f, keep):
    """One Hillis-Steele level: x where f | keep, else add(xl, x)."""
    pass_ = torch.broadcast_to(f | keep, F.batch_shape(x[0]))
    merged = add_plain(F, xl, x)
    return tuple(F.select(pass_, a, b) for a, b in zip(x, merged))


def _pmap(F, fn, *pts):
    """fn over the matching word tensors of points."""
    return tuple(F.map(fn, *coords) for coords in zip(*pts))


def _segmented_hs(F, pts, starts):
    """Segmented inclusive prefix sums along the last axis, Hillis-Steele:
    log2(N) levels of ``hs_add_select_plain``; starts marks segment heads."""
    n = starts.shape[-1]
    pos = torch.arange(n, device=starts.device)
    f = starts
    for d in range(max(1, (n - 1).bit_length())):
        s = 1 << d
        xl = _pmap(F, lambda a: torch.roll(a, s, dims=-1), pts)
        keep = pos < s  # no left neighbour at distance s
        pts = hs_add_select_plain(F, xl, pts, f, keep)
        f = torch.where(keep, f, f | torch.roll(f, s, dims=-1))
    return pts


_PLAIN_SLAB = 1 << 21  # coordinate elements (points x ncomp) per pass


def bucket_sums_plain(F, points, keys_s, order, nb: int):
    """points: leaves (12, N); keys_s, order: (*lead, N), keys ascending in
    [0, nb) -> leaves (12, *lead, nb): the sorted copy, the segmented
    Hillis-Steele scan and the scatter of each run's last prefix into its
    bucket; bucket 0 is the identity."""
    N = order.shape[-1]
    lead = tuple(order.shape[:-1])
    M = order.numel() // N
    slab = max(1, _PLAIN_SLAB // (N * F.ncomp))
    if M > slab:  # bound the temporaries: slabs of rows
        k2, o2 = keys_s.reshape(M, N), order.reshape(M, N)
        parts = [bucket_sums_plain(F, points, k2[m: m + slab],
                                   o2[m: m + slab], nb)
                 for m in range(0, M, slab)]
        return _pmap(F, lambda *a: torch.cat(a, 1).reshape(12, *lead, nb),
                     *parts)
    dev = order.device
    idx = order.reshape(-1).to(torch.int64)
    pts = _pmap(F, lambda a: a.index_select(1, idx).reshape(12, M, N), points)
    keys = keys_s.reshape(M, N)
    edge = keys[:, 1:] != keys[:, :-1]
    first = torch.ones((M, 1), dtype=torch.bool, device=dev)
    prefix = _segmented_hs(F, pts, torch.cat([first, edge], dim=-1))
    # each run's last prefix into its bucket; other positions -> a dummy
    # slot that is cut off
    ends = torch.cat([edge, first], dim=-1)
    slot = torch.where(ends, keys, nb).to(torch.int64).expand(12, M, N)
    ident = (F.ones((M, nb + 1), dev), F.ones((M, nb + 1), dev),
             F.zeros((M, nb + 1), dev))
    buckets = _pmap(F, lambda d, s: d.scatter(-1, slot, s)[..., :nb], ident,
                    prefix)
    buckets = _pmap(F, lambda b, i: torch.cat([i[..., :1], b[..., 1:]], -1),
                    buckets, ident)
    return _pmap(F, lambda a: a.reshape(12, *lead, nb), buckets)


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------
def _fn():
    lib = _build.lib("ec_kernels")
    fn = lib.zc_ec_op
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def _hs_fn():
    lib = _build.lib("hs_kernel")
    fn = lib.zc_hs_add_select
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def _bs_fn():
    lib = _build.lib("hs_kernel")
    fn = lib.zc_hs_bucket_sums
    if not getattr(fn, "_typed", False):
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


_programs: dict = {}


def _chain_fn(name):
    lib = _build.lib("ec_kernels")
    fn = getattr(lib, name)
    if not getattr(fn, "_typed", False):
        head = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p)]
        if name == "zc_ec_ladder":
            fn.argtypes = head + [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p]
        elif name == "zc_ec_fold":
            fn.argtypes = head + [ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_void_p]
        else:
            fn.argtypes = head + [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn._typed = True
    return fn


def program_bytes(g2: bool) -> bytes:
    """The chain kernels' program set for G1 or G2 (``ZpSet`` of
    csrc/group_program.cuh), built by the library on the host."""
    fn = _build.lib("ec_kernels").zc_ec_programs
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = ctypes.create_string_buffer(1 << 16)
    size = fn(int(g2), buf, len(buf))
    if size <= 0:
        raise RuntimeError("zc_ec_programs failed")
    return buf.raw[:size]


def _program(F, device):
    """-> (device uint8 tensor of the program set, its slot count)."""
    key = (F.ncomp, device)
    got = _programs.get(key)
    if got is None:
        raw = program_bytes(F.ncomp == 2)
        n_slots = int.from_bytes(raw[:4], "little")
        t = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)
        got = _programs[key] = (t, n_slots)
    return got


def _chain_out(F, outs):
    if F.ncomp == 1:
        return tuple(outs)
    return tuple((outs[2 * k], outs[2 * k + 1]) for k in range(3))


def ladder(F, base_jac, bits, lanes=None):
    """Little-endian double-and-add of Jacobian base points over bit planes
    (n_bits, *batch) (any integer type, 0 or 1), in one launch."""
    kind = _device_type(F, base_jac)
    if kind == "cpu":
        return ladder_plain(F, base_jac, bits)
    if kind != "cuda":
        raise ValueError(f"unsupported device {F.device(base_jac[0])}")
    planes = _prepare(_planes(F, base_jac))
    ref = planes[0]
    batch = tuple(ref.shape[1:])
    n_bits = bits.shape[0]
    if tuple(bits.shape[1:]) != batch:
        raise ValueError(f"bits {tuple(bits.shape)} do not match the batch {batch}")
    if bits.device != ref.device:
        raise ValueError("bits and points on different devices")
    count = ref.numel() // 12
    if n_bits == 0 or count == 0:  # nothing to launch: the identity
        dev = ref.device
        return (F.ones(batch, dev), F.ones(batch, dev), F.zeros(batch, dev))
    b8 = (bits != 0).to(torch.uint8).contiguous()
    outs = [torch.empty_like(ref) for _ in planes]
    prog, n_slots = _program(F, ref.device)
    ptrs = (ctypes.c_void_p * (2 * len(planes)))(
        *[t.data_ptr() for t in planes], *[t.data_ptr() for t in outs])
    with torch.cuda.device(ref.device):
        rc = _chain_fn("zc_ec_ladder")(
            int(F.ncomp == 2), prog.data_ptr(), n_slots, ptrs, b8.data_ptr(),
            n_bits, count, lanes or CHAIN_LANES,
            torch.cuda.current_stream().cuda_stream)
    launches[("g1_" if F.ncomp == 1 else "g2_") + "ladder"] += 1
    if rc != 0:
        raise RuntimeError(f"ec ladder/{F.name}: CUDA error {rc}")
    return _chain_out(F, outs)


def horner(F, totals, c: int, lanes=None):
    """Window totals (leaves (12, nw, *batch)) -> res = 2^c * res + T[w],
    MSB first, in one launch."""
    if c < 0:
        raise ValueError(f"horner takes a window width c >= 0, got {c}")
    kind = _device_type(F, totals)
    if kind == "cpu":
        return horner_plain(F, totals, c)
    if kind != "cuda":
        raise ValueError(f"unsupported device {F.device(totals[0])}")
    planes = _prepare(_planes(F, totals))
    ref = planes[0]
    if ref.dim() < 2:
        raise ValueError("totals need a window axis after the 12 words")
    nw = ref.shape[1]
    batch = tuple(ref.shape[2:])
    count = ref[0, 0].numel()
    if nw == 1 or count == 0:  # nothing to launch: the top window
        return tuple(F.map(lambda a: a[:, nw - 1], t) for t in totals)
    outs = [torch.empty((12, *batch), dtype=torch.int32, device=ref.device)
            for _ in planes]
    prog, n_slots = _program(F, ref.device)
    ptrs = (ctypes.c_void_p * (2 * len(planes)))(
        *[t.data_ptr() for t in planes], *[t.data_ptr() for t in outs])
    with torch.cuda.device(ref.device):
        rc = _chain_fn("zc_ec_horner")(
            int(F.ncomp == 2), prog.data_ptr(), n_slots, ptrs, nw, c, count,
            lanes or CHAIN_LANES, torch.cuda.current_stream().cuda_stream)
    launches[("g1_" if F.ncomp == 1 else "g2_") + "horner"] += 1
    if rc != 0:
        raise RuntimeError(f"ec horner/{F.name}: CUDA error {rc}")
    return _chain_out(F, outs)


def bucket_fold(F, buckets, lanes=None):
    """Bucket sums (leaves (12, *batch, nb)) -> sum_v v * B[v] (leaves (12,
    *batch)), the running-sum fold, in one launch."""
    kind = _device_type(F, buckets)
    if kind == "cpu":
        return bucket_fold_plain(F, buckets)
    if kind != "cuda":
        raise ValueError(f"unsupported device {F.device(buckets[0])}")
    planes = _prepare(_planes(F, buckets))
    ref = planes[0]
    if ref.dim() < 2:
        raise ValueError("buckets need a bucket axis after the 12 words")
    nb = ref.shape[-1]
    batch = tuple(ref.shape[1:-1])
    count = ref[0].numel() // nb if nb else 0
    if nb < 2 or count == 0:  # nothing to launch: the identity
        dev = ref.device
        return (F.ones(batch, dev), F.ones(batch, dev), F.zeros(batch, dev))
    outs = [torch.empty((12, *batch), dtype=torch.int32, device=ref.device)
            for _ in planes]
    prog, n_slots = _program(F, ref.device)
    ptrs = (ctypes.c_void_p * (2 * len(planes)))(
        *[t.data_ptr() for t in planes], *[t.data_ptr() for t in outs])
    with torch.cuda.device(ref.device):
        rc = _chain_fn("zc_ec_fold")(
            int(F.ncomp == 2), prog.data_ptr(), n_slots, ptrs, nb, count,
            lanes or CHAIN_LANES, torch.cuda.current_stream().cuda_stream)
    launches[("g1_" if F.ncomp == 1 else "g2_") + "bucket_fold"] += 1
    if rc != 0:
        raise RuntimeError(f"ec bucket_fold/{F.name}: CUDA error {rc}")
    return _chain_out(F, outs)


def _planes(F, pt):
    """The coordinate word tensors of a point, in kernel order."""
    out = []
    for coord in pt:
        out.extend(F.leaves(coord))
    return out


def _prepare(planes):
    ref = planes[0]
    for t in planes:
        if t.dtype != torch.int32:
            raise TypeError(f"point coordinates are int32 words, got {t.dtype}")
        if t.dim() < 1 or t.shape[0] != 12:
            raise ValueError(f"coordinate shape {tuple(t.shape)}: expected 12 leading words")
        if t.device != ref.device:
            raise ValueError("point coordinates on different devices")
    if any(t.shape != ref.shape for t in planes):
        planes = list(torch.broadcast_tensors(*planes))
    return [t.contiguous() for t in planes]


def _launch(F, op: str, p, q=None):
    np_ = 3 * F.ncomp
    planes = _planes(F, p) + (_planes(F, q) if q is not None else [])
    planes = _prepare(planes)
    ref = planes[0]
    outs = [torch.empty_like(ref) for _ in range(np_)]
    count = ref.numel() // 12
    if count:
        ins = planes if q is not None else planes + planes
        ptrs = (ctypes.c_void_p * (3 * np_))(
            *[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs])
        with torch.cuda.device(ref.device):
            rc = _fn()(int(F.ncomp == 2), 0 if op == "add" else 1, ptrs, count,
                       torch.cuda.current_stream().cuda_stream)
        launches[("g1_" if F.ncomp == 1 else "g2_") + op] += 1
        if rc != 0:
            raise RuntimeError(f"ec kernel {op}/{F.name}: CUDA error {rc}")
    if F.ncomp == 1:
        return tuple(outs)
    return tuple((outs[2 * k], outs[2 * k + 1]) for k in range(3))


def _device_type(F, p):
    return F.device(p[0]).type


def add(F, p, q):
    """p + q on Jacobian point batches."""
    kind = _device_type(F, p)
    if kind == "cpu":
        return add_plain(F, p, q)
    if kind != "cuda":
        raise ValueError(f"unsupported device {F.device(p[0])}")
    return _launch(F, "add", p, q)


def double(F, p):
    """2p on a Jacobian point batch."""
    kind = _device_type(F, p)
    if kind == "cpu":
        return double_plain(F, p)
    if kind != "cuda":
        raise ValueError(f"unsupported device {F.device(p[0])}")
    return _launch(F, "double", p)


def hs_add_select(F, xl, x, f, keep):
    """One Hillis-Steele level: ``(f | keep) ? x : add(xl, x)``.

    xl, x: point batches of one shape; f, keep: bool tensors broadcastable
    to their batch shape."""
    kind = _device_type(F, x)
    if kind == "cpu":
        return hs_add_select_plain(F, xl, x, f, keep)
    if kind != "cuda":
        raise ValueError(f"unsupported device {F.device(x[0])}")
    np_ = 3 * F.ncomp
    planes = _prepare(_planes(F, xl) + _planes(F, x))
    ref = planes[0]
    batch = tuple(ref.shape[1:])
    masks = []
    for m in (f, keep):
        if m.dtype != torch.bool:
            raise TypeError(f"hs_add_select masks are bool, got {m.dtype}")
        if m.device != ref.device:
            raise ValueError("masks and points on different devices")
        masks.append(torch.broadcast_to(m, batch).contiguous().view(torch.uint8))
    outs = [torch.empty_like(ref) for _ in range(np_)]
    count = ref.numel() // 12
    if count:
        ptrs = (ctypes.c_void_p * (3 * np_))(
            *[t.data_ptr() for t in planes], *[t.data_ptr() for t in outs])
        with torch.cuda.device(ref.device):
            rc = _hs_fn()(int(F.ncomp == 2), ptrs, masks[0].data_ptr(),
                          masks[1].data_ptr(), count,
                          torch.cuda.current_stream().cuda_stream)
        launches[("g1_" if F.ncomp == 1 else "g2_") + "hs_add_select"] += 1
        if rc != 0:
            raise RuntimeError(f"hs_add_select/{F.name}: CUDA error {rc}")
    if F.ncomp == 1:
        return tuple(outs)
    return tuple((outs[2 * k], outs[2 * k + 1]) for k in range(3))


BUCKET_THREADS = 128  # threads a row (csrc/hs_kernel.cu: one CTA a row)


def bucket_sums(F, points, keys_s, order, nb: int):
    """See the module docstring.  points: leaves (12, N), any Z; keys_s,
    order: (*lead, N) int32, keys ascending in [0, nb) along each row.
    -> Jacobian leaves (12, *lead, nb)."""
    if not 1 <= nb <= 1 << 30:
        raise ValueError(f"bucket_sums takes 1 <= nb <= 2^30 buckets (keys of "
                         f"at most 30 bits), got nb={nb}")
    planes = _planes(F, points)
    dev = planes[0].device
    N = order.shape[-1]
    lead = tuple(order.shape[:-1])
    if keys_s.shape != order.shape:
        raise ValueError("keys_s and order differ in shape")
    for t in planes:
        if t.dtype != torch.int32 or tuple(t.shape) != (12, N):
            raise ValueError(
                f"point planes must be int32 (12, {N}), got {t.dtype} "
                f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("point planes on different devices")
    for t in (keys_s, order):
        if t.dtype != torch.int32:
            raise TypeError("keys_s and order must be int32")
        if t.device != dev:
            raise ValueError("keys/order and points on different devices")
    if dev.type == "cpu":
        return bucket_sums_plain(F, points, keys_s, order, nb)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    planes = [t.contiguous() for t in planes]
    ks = keys_s.contiguous()
    od = order.contiguous()
    M = od.numel() // N if N else 0
    outs = [torch.empty((12, M, nb), dtype=torch.int32, device=dev)
            for _ in planes]
    if M:
        in_ptrs = (ctypes.c_void_p * len(planes))(*[t.data_ptr() for t in planes])
        out_ptrs = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
        # per row and thread: the head and tail pieces of its slice's runs
        carry = torch.empty(M * BUCKET_THREADS * 2 * 3 * 12 * F.ncomp,
                            dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = _bs_fn()(int(F.ncomp == 2), in_ptrs, ks.data_ptr(),
                          od.data_ptr(), out_ptrs, carry.data_ptr(), N, M, nb,
                          BUCKET_THREADS, torch.cuda.current_stream().cuda_stream)
        launches[("g1" if F.ncomp == 1 else "g2") + "_bucket_sums"] += 1
        if rc != 0:
            raise RuntimeError(f"bucket_sums/{F.name}: CUDA error {rc}")
    return _chain_out(F, [t.reshape(12, *lead, nb) for t in outs])
