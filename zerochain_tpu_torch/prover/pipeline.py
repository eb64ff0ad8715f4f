"""End-to-end Groth16 prover for ConfidentialTransfer (and AnonymousTransfer,
MiniCommit) on one device.

prove = witness synthesis -> constraint matvec -> NTT quotient -> five
suffix-sum MSMs -> on-device final assembly (A/B/C from alpha/beta/delta and
r, s).  ``msm_impl="hs"`` swaps the suffix MSMs for the bucket MSM of
msm/pippenger.py (bucket sums of the sorted digits, then a bucket fold);
``msm_tail="split"`` keeps the suffix MSMs with their split tail
(msm/suffix.py).  All three give the
same proofs.  Everything stays on the device; the only host transfer is one
batch of normalized proof points.  Mirrors bellman's create_random_proof pipeline
(SURVEY.md §3.2).  ``ZEROCHAIN_DIST=1`` spreads the quotient's transforms and
every MSM chunk's points over the ranks of a torch.distributed process group
(dist/), each rank proving the same batch on its own device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import _device
from ..ec import g1 as jg1
from ..ec import g2 as jg2
from ..ec import weierstrass as W
from ..ec.fields import FqOps, Fq2Ops
from ..ff import limbs as L
from ..groth16 import domain as dom
from ..groth16.core import Parameters, Proof, _pad_input_constraints
from ..mirror.field import R
from ..models.anonymous import AnonymousTransfer
from ..models.confidential import ConfidentialTransfer
from ..models.mini import MiniCommit
from ..msm import pippenger as pip
from ..msm import suffix as smsm
from ..ntt import plan_for, quotient
from ..r1cs.system import ConstraintSystem
from ..utils.profiling import StageRecorder, device_trace, trace_dir_from_env
from . import witness as wit
from . import witness_anon as wanon
from . import witness_mini as wmini
from .matvec import ConstraintMatrices

FR = L.FR
FQ = L.FQ

QUERY_NAMES = ("h", "l", "a", "b1", "b2")


class ConfidentialProver:
    """Holds the device-resident CRS for batched proving.

    Subclasses rebind CIRCUIT/_witness_fns to prove other fixed circuits
    (MiniProver below): the pipeline itself is circuit-agnostic.

    ``device=None`` means the CUDA device and raises where there is none;
    only ``device="cpu"`` selects the CPU.

    ``msm_impl``: "suffix" (default) or "hs", None reads
    ``ZEROCHAIN_MSM_IMPL``; ``msm_tail``: the suffix MSMs' tail, "totals" or
    "split", None reads ``ZEROCHAIN_MSM_TOTALS`` (see ``SuffixMsm``).  As in
    the JAX package, ``ZEROCHAIN_MSM_SUFFIX_C`` sets the suffix MSMs' window
    width (default 8), ``ZEROCHAIN_MSM_SCAN_G1`` / ``_G2`` the bucket MSMs'
    scan mode ("hs" or "assoc"; unset: ``ZEROCHAIN_MSM_SCAN``), and
    ``ZEROCHAIN_MSM_CHUNK_G2`` caps the chunk that B1 and B2 share (default
    16,384; ``ZEROCHAIN_MSM_CHUNK`` caps every chunk).

    ``ZEROCHAIN_DIST=1``: the prover runs on the default torch.distributed
    process group, every rank calling ``prove`` on the same batch with the
    whole CRS on its own device (``device`` picks it: ``None`` is the
    current CUDA device).  Each MSM chunk's points are split over the ranks
    (``dist.sharded_suffix``, on the hs path ``dist.sharded_msm``) and the
    quotient runs as four-step transforms (``dist.DistNtt.quotient``)
    where d >= 2 n^2 for n ranks; every rank gets the same proofs.  It
    engages at any world size, where the JAX package needs more than one
    device: the card's machine has one H100, and a world of one runs the
    path there.  Without an initialised process group it raises: it never
    proves on one device instead.  Each chunk must divide by the world
    size."""

    CIRCUIT = ConfidentialTransfer

    @staticmethod
    def _witness_fns():
        """-> (witness_inputs_host, witness) for this circuit."""
        return wit.witness_inputs_host, wit.confidential_witness

    @staticmethod
    def circuit_for(a: dict) -> ConfidentialTransfer:
        """The circuit object (for groth16.core.create_proof) of one
        assignment dict of ``prove``."""
        return ConfidentialTransfer(
            amount=a["amount"], remaining_balance=a["remaining_balance"],
            randomness=a["randomness"], alpha=a["alpha"],
            proof_generation_key=a["pgk"], dec_key_sender=a["dec_key"],
            enc_key_recipient=a["enc_key_recipient"],
            encrypted_balance=(a["enc_balance_left"], a["enc_balance_right"]),
            fee=a["fee"], g_epoch=a["g_epoch"])

    def __init__(self, params: Parameters | None, _device_queries=None,
                 _vk=None, device=None, msm_impl: str | None = None,
                 msm_tail: str | None = None):
        self.device = dev = _device.resolve(device)
        self.msm_impl = msm_impl or os.environ.get("ZEROCHAIN_MSM_IMPL", "suffix")
        if self.msm_impl not in ("suffix", "hs"):
            raise ValueError(f"unknown MSM implementation {self.msm_impl!r}")
        cs = ConstraintSystem(track_names=False)
        self.CIRCUIT().synthesize(cs)
        _pad_input_constraints(cs)
        self.matrices = ConstraintMatrices(cs, cs.num_inputs, device=dev)
        self.num_inputs = cs.num_inputs
        self.num_aux = len(cs.aux)
        self.m = cs.num_constraints
        self.d = dom.domain_size(self.m)
        self.plan = plan_for(self.d, dev)
        self.sync_stages = False  # True: synchronize at the end of each stage
        self.last_timings: dict = {}
        self.dist = bool(int(os.environ.get("ZEROCHAIN_DIST", "0")))
        if self.dist:
            from ..dist import comm

            _, self.world_size = comm.world()  # raises without a group

        if _device_queries is not None:
            self.params = None
            self.vk = vk = _vk
            raw = _queries_to(_device_queries, dev)
        else:
            self.params = params
            self.vk = vk = params.vk
            # device-resident CRS queries (None -> infinity, Z=0)
            raw = (
                jg1.from_affine_host(params.h, device=dev),
                jg1.from_affine_host(params.l, device=dev),
                jg1.from_affine_host(params.a, device=dev),
                jg1.from_affine_host(params.b_g1, device=dev),
                jg2.from_affine_host(params.b_g2, device=dev),
            )
        self._raw_queries = raw  # pre-gather, for save_queries

        self.alpha_g1 = jg1.from_affine_host([vk.alpha_g1], device=dev)
        self.beta_g1 = jg1.from_affine_host([vk.beta_g1], device=dev)
        self.delta_g1 = jg1.from_affine_host([vk.delta_g1], device=dev)
        self.beta_g2 = jg2.from_affine_host([vk.beta_g2], device=dev)
        self.delta_g2 = jg2.from_affine_host([vk.delta_g2], device=dev)

        # Density prefiltering (bellman's density-tracker equivalent): a
        # CRS query point is infinity exactly when the variable never
        # appears in that matrix's LCs, so those columns are dropped
        # statically and each MSM runs at its true dense size.
        self.a_cols = np.unique(self.matrices.mats[0][1])
        self.b_cols = np.unique(self.matrices.mats[1][1])
        self._a_cols_dev = torch.from_numpy(self.a_cols).to(dev)
        self._b_cols_dev = torch.from_numpy(self.b_cols).to(dev)

        # MSM chunk sizes: capped by the domain size so tiny fixture
        # circuits (MiniProver) don't pad their MSMs out to 16k points.
        req_chunk = int(os.environ.get("ZEROCHAIN_MSM_CHUNK", "16384"))
        g2_cap = int(os.environ.get("ZEROCHAIN_MSM_CHUNK_G2", "16384"))
        d_pow2 = 1 << max(0, (self.d - 1).bit_length())
        self.msm_chunk_g1 = min(req_chunk, max(1024, d_pow2))

        # Per-MSM chunks: padding a query out to a bigger chunk than its
        # pow2-ceil size makes the scan run DEAD points, so each query gets
        # min(cap, req, pow2ceil(n)).  B1 (G1) and B2 (G2) must MATCH to
        # share their digit sort, so both take the G2 cap.
        def chunk_for(n_pts, cap):
            p = 1 << max(0, (max(1, n_pts) - 1).bit_length())
            return max(min(1024, self.msm_chunk_g1),
                       min(cap, self.msm_chunk_g1, p))

        self.msm_chunk_b = chunk_for(len(self.b_cols), g2_cap)
        self.msm_chunk_a = chunk_for(len(self.a_cols), req_chunk)
        self.msm_chunk_l = chunk_for(self.num_aux, req_chunk)
        self.msm_chunk_h = chunk_for(self.d, req_chunk)
        if self.dist:
            for chunk in (self.msm_chunk_a, self.msm_chunk_b,
                          self.msm_chunk_l, self.msm_chunk_h):
                if chunk % self.world_size:
                    raise ValueError(f"MSM chunk {chunk} does not divide over "
                                     f"{self.world_size} ranks")

        def chunked(pts, cols, n, chunk):
            """-> (the query's points as contiguous chunks, padded size)."""
            pts, size = self._prep(pts, cols, n, chunk)
            return [
                pip.tmap(lambda a: a[:, off: off + chunk].contiguous(), pts)
                for off in range(0, size, chunk)
            ], size

        h_raw, l_raw, a_raw, b1_raw, b2_raw = raw
        self.h_chunks, self.size_h = chunked(h_raw, None, self.d,
                                             self.msm_chunk_h)
        self.l_chunks, self.size_l = chunked(l_raw, None, self.num_aux,
                                             self.msm_chunk_l)
        self.a_chunks, self.size_a = chunked(a_raw, self._a_cols_dev, None,
                                             self.msm_chunk_a)
        self.b1_chunks, self.size_b1 = chunked(b1_raw, self._b_cols_dev, None,
                                               self.msm_chunk_b)
        self.b2_chunks, _ = chunked(b2_raw, self._b_cols_dev, None,
                                    self.msm_chunk_b)

        if self.msm_impl == "suffix":
            # signed digits; at c = 8: 32 windows, |digit| <= 128
            suffix_c = int(os.environ.get("ZEROCHAIN_MSM_SUFFIX_C", "8"))
            self.msm_g1 = smsm.SuffixMsm(FqOps, c=suffix_c, signed=True,
                                         tail=msm_tail)
            self.msm_g2 = smsm.SuffixMsm(Fq2Ops, c=suffix_c, signed=True,
                                         tail=msm_tail)
        else:
            # unsigned digits of pippenger.WINDOW_C bits (c = 8: 32 windows,
            # 256 buckets)
            self.msm_g1 = pip.Msm(
                FqOps, mode=os.environ.get("ZEROCHAIN_MSM_SCAN_G1") or None)
            self.msm_g2 = pip.Msm(
                Fq2Ops, mode=os.environ.get("ZEROCHAIN_MSM_SCAN_G2") or None)

    def _prep(self, pts, cols, n, chunk):
        """Gather dense columns, pad to a chunk multiple, and NORMALIZE
        to affine (Z in {0, one}); -> (pts, size).

        The normalization is load-bearing: the MSM kernel's run scan uses
        the mixed add (Z2 in {0, 1}) on the incoming CRS point, but
        from_toxic_waste/from_cache queries arrive as arbitrary-Z Jacobians
        from the fixed-base exponentiation.  One batched inversion per
        query array at init makes every chunk eligible (and the points
        canonical for caching)."""
        if cols is not None:
            pts = pip.tmap(lambda a: a.index_select(1, cols), pts)
            n = len(cols)
        size = -(-n // chunk) * chunk

        def pad(a):
            cur = a.shape[-1]
            if cur >= size:
                return a[:, :size]
            z = torch.zeros((a.shape[0], size - cur), dtype=a.dtype,
                            device=a.device)
            return torch.cat([a, z], dim=-1)

        pts = pip.tmap(pad, pts)
        field = Fq2Ops if isinstance(pts[0], tuple) else FqOps
        x, y, inf = W.normalize(field, pts)
        batch = field.batch_shape(x)
        z = field.select(inf, field.zeros(batch, self.device),
                         field.ones(batch, self.device))
        return (x, y, z), size

    @staticmethod
    def _pad_points_axis(d, n):
        """Pad the point axis (axis 1) of (nw, N, B) digits or (n_bits, N,
        B) bits to n."""
        cur = d.shape[1]
        if cur >= n:
            return d[:, :n]
        z = torch.zeros((d.shape[0], n - cur) + tuple(d.shape[2:]),
                        dtype=d.dtype, device=d.device)
        return torch.cat([d, z], dim=1)

    def _msm_chunked(self, field, pts_chunks, bits):
        """Bucket-MSM chunk loop: each chunk is a whole MSM over its slice
        of the bits (n_bits, size, B), window combine included, and the
        per-proof partial points (leaf batch (B,)) are added.  In dist mode
        each chunk's points are split over the ranks (``sharded_msm``,
        always the bucket MSM: the naive form takes no proof-batch axis)."""
        msm = self.msm_g1 if field is FqOps else self.msm_g2
        acc, off = None, 0
        for cpts in pts_chunks:
            n = pip.first_leaf(cpts).shape[-1]
            if self.dist:
                from ..dist.msm import sharded_msm

                part = sharded_msm(field, cpts, bits[:, off: off + n],
                                   use_pippenger=True, msm=msm)
            else:
                part = msm(cpts, bits[:, off: off + n])
            acc = part if acc is None else W.add(field, acc, part)
            off += n
        return acc

    def _msm_chunked_suffix(self, field, pts_chunks, prep_chunks):
        """Suffix-MSM chunk loop over pre-sliced point chunks and digit
        preps: per chunk one window_totals (or, on the split tail, one
        split_tail) launch + one accumulate, and the Horner window combine
        runs ONCE per MSM.  In dist mode prep_chunks are the raw digit
        chunks and each chunk's points are split over the ranks
        (``sharded_suffix``: a local sort and scan, one all-gather of the
        (nw, B) partial points a chunk)."""
        msm = self.msm_g1 if field is FqOps else self.msm_g2
        acc = None
        for cpts, cprep in zip(pts_chunks, prep_chunks):
            if self.dist:
                from ..dist.msm import sharded_suffix

                part = sharded_suffix(msm, cpts, cprep)
            else:
                part = msm.window_partials(cpts, prep=cprep)
            acc = part if acc is None else W.add(field, acc, part)
        return msm.combine(acc)

    @classmethod
    def from_toxic_waste(cls, tau, alpha, beta, gamma, delta,
                         chunk: int = 4096, chunk_g2: int = 1024,
                         device=None):
        """Generate the CRS directly on the device.  Query points stay as
        device Jacobian tensors; only the small vk/ic goes through host
        bigints."""
        from ..groth16.core import crs_exponents, vk_from_exponents
        from ..mirror import curves as cv

        dev = _device.resolve(device)
        exps = crs_exponents(cls.CIRCUIT(), tau, alpha, beta, gamma, delta)
        vk = vk_from_exponents(exps)

        fb1 = pip.FixedBaseMsm(FqOps, cv.G1_GEN, device=dev)
        fb2 = pip.FixedBaseMsm(Fq2Ops, cv.G2_GEN, device=dev)

        def dev_points(fb, exp_list, ch):
            """Chunked fixed-base exponentiation; the window-gather temp is
            (n_windows * chunk) wide, so the chunk bounds temp memory."""
            return pip.tcat([
                fb(pip.scalars_to_bits(exp_list[off: off + ch], 255, dev))
                for off in range(0, len(exp_list), ch)
            ], -1)

        queries = (
            dev_points(fb1, exps["h"], chunk),
            dev_points(fb1, exps["l"], chunk),
            dev_points(fb1, exps["u"], chunk),
            dev_points(fb1, exps["v"], chunk),
            dev_points(fb2, exps["v"], chunk_g2),
        )
        return cls(None, _device_queries=queries, _vk=vk, device=dev)

    # ------------------------------------------------------------------
    def save_queries(self, path: str) -> None:
        """Persist the device CRS queries + vk to an .npz so later runs
        skip the on-device CRS generation (bellman's analogue is
        Parameters::write, core/proofs/src/confidential.rs:73-103; here
        the cache holds raw word planes instead of affine bytes)."""
        from ..groth16.serialization import vk_to_bytes

        arrs = {}
        for prefix, pts in zip(QUERY_NAMES, self._raw_queries):
            for name, comp in zip(("x", "y", "z"), pts):
                if isinstance(comp, tuple):
                    arrs[f"{prefix}_{name}0"] = comp[0].cpu().numpy()
                    arrs[f"{prefix}_{name}1"] = comp[1].cpu().numpy()
                else:
                    arrs[f"{prefix}_{name}"] = comp.cpu().numpy()
        arrs["vk"] = np.frombuffer(vk_to_bytes(self.vk), dtype=np.uint8)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
        os.replace(tmp, path)

    @classmethod
    def from_cache(cls, path: str, device=None) -> "ConfidentialProver":
        """Load a CRS previously written by save_queries."""
        from ..groth16.serialization import vk_from_bytes

        with np.load(path) as z:
            queries = queries_from_arrays(z)
            vk = vk_from_bytes(z["vk"].tobytes())
        return cls(None, _device_queries=queries, _vk=vk, device=device)

    # ------------------------------------------------------------------
    def _quotient(self, aux, public):
        """Witness concat + quotient NTTs."""
        witness_mont = torch.cat([public, aux], dim=1)
        return witness_mont, self._h_scalars(witness_mont)

    def _digits(self, witness_mont, h_scalars):
        """All five MSMs' per-chunk digit preps.

        Returns per-MSM lists of (sorted_digits, order) ready for
        window_partials(prep=...).  The B1 (G1) and B2 (G2) MSMs run over
        IDENTICAL scalars with the same chunk size, so they share the same
        preps: one digit sort instead of two.

        In dist mode the raw digit chunks (nw, chunk, B) are returned
        instead: each rank must sort only its LOCAL point slice (a global
        order would make every rank gather points from the others), so B1
        and B2 share their digits and sort them separately."""
        wit_canon = L.from_mont(FR, witness_mont)
        h_canon = L.from_mont(FR, h_scalars)

        def preps(words, msm, size, chunk):
            d = self._pad_points_axis(msm.digits(words), size)
            if self.dist:
                return [d[:, off: off + chunk] for off in range(0, size, chunk)]
            return [msm.prep(d[:, off: off + chunk])
                    for off in range(0, size, chunk)]

        g1 = self.msm_g1
        a_p = preps(wit_canon.index_select(1, self._a_cols_dev), g1,
                    self.size_a, self.msm_chunk_a)
        b1_p = preps(wit_canon.index_select(1, self._b_cols_dev), g1,
                     self.size_b1, self.msm_chunk_b)
        l_p = preps(wit_canon[:, self.num_inputs:], g1, self.size_l,
                    self.msm_chunk_l)
        h_p = preps(h_canon, g1, self.size_h, self.msm_chunk_h)
        # B2 runs over the same scalars, chunk size and digit encoding as B1
        return (a_p, b1_p, b1_p, l_p, h_p)

    def _bits(self, witness_mont, h_scalars):
        """The bucket MSMs' scalars: canonical LE bits (255, size, B) per
        MSM, padded with zeros to the query's chunked size (B1 and B2 share
        theirs)."""
        wit_bits = pip.limbs_to_bits(L.from_mont(FR, witness_mont), 255)
        h_bits = pip.limbs_to_bits(L.from_mont(FR, h_scalars), 255)
        pad = self._pad_points_axis
        bb = pad(wit_bits.index_select(1, self._b_cols_dev), self.size_b1)
        return (pad(wit_bits.index_select(1, self._a_cols_dev), self.size_a),
                bb, bb,
                pad(wit_bits[:, self.num_inputs:], self.size_l),
                pad(h_bits, self.size_h))

    def _h_scalars(self, witness_mont):
        """witness (8, n_vars, B) -> quotient coeffs (8, d-1, B) mont.  In
        dist mode, where d >= 2 n^2 for n ranks, the intt -> coset_ntt ->
        pointwise -> divide-by-z -> icoset_ntt chain runs as four-step
        distributed transforms (``dist.DistNtt.quotient``)."""
        a_v, b_v, c_v = self.matrices.eval(witness_mont)
        B = witness_mont.shape[-1]
        pad = self.d - self.m

        def pad_to_d(x):
            z = torch.zeros((FR.n, pad, B), dtype=torch.int32,
                            device=x.device)
            return torch.cat([x, z], dim=1).movedim(1, -1)  # (8, B, d)

        plan = self.plan
        if self.dist and self.d >= 2 * self.world_size ** 2:
            from ..dist.ntt import dist_plan_for

            plan = dist_plan_for(self.d, device=self.device)
        h = quotient(plan, pad_to_d(a_v), pad_to_d(b_v),
                     pad_to_d(c_v))  # (8, B, d)
        return h.movedim(-1, 1)[:, : self.d - 1]  # (8, d-1, B)

    # ------------------------------------------------------------------
    def _assemble(self, a_acc, b1_acc, b2_acc, l_acc, h_acc,
                  r_bits, s_bits, rs_bits):
        """Per-proof accumulators (leaf batch (B,)) + r/s/(r*s) bits
        (255, B) -> normalized affine proof coordinates (8, 12, B).

        Six double-and-add chains batched into THREE 255-step loops:
        {r,s,r*s}*delta1 ride one G1 chain (r*s is computed host-side so
        the chains stay independent), {s*A, r*B1} a second, s*delta2 the
        G2 one."""
        B = r_bits.shape[1]

        def bcast(p, *shape):
            return pip.tmap(lambda a: a.reshape(12, *([1] * len(shape)))
                            .expand(12, *shape), p)

        # chain 1: {r, s, rs} * delta1 in one (3, B)-wide G1 chain
        rss_bits = torch.stack([r_bits, s_bits, rs_bits], dim=1)  # (255,3,B)
        deltas = W.scalar_mul_bits_jac(FqOps, bcast(self.delta_g1, 3, B),
                                       rss_bits)
        r_delta1 = pip.tmap(lambda a: a[:, 0], deltas)
        s_delta1 = pip.tmap(lambda a: a[:, 1], deltas)
        rs_delta = pip.tmap(lambda a: a[:, 2], deltas)
        s_delta2 = W.scalar_mul_bits_jac(Fq2Ops, bcast(self.delta_g2, B),
                                         s_bits)

        # A = alpha + sum_a + r*delta
        g_a = W.add(FqOps, bcast(self.alpha_g1, B), a_acc)
        g_a = W.add(FqOps, g_a, r_delta1)
        # B = beta + sum_b2 + s*delta (G2)
        g_b = W.add(Fq2Ops, bcast(self.beta_g2, B), b2_acc)
        g_b = W.add(Fq2Ops, g_b, s_delta2)
        # B1 = beta1 + sum_b1 + s*delta1
        b1_full = W.add(FqOps, bcast(self.beta_g1, B), b1_acc)
        b1_full = W.add(FqOps, b1_full, s_delta1)
        # chain 2: C = s*A + r*B1 - rs*delta + l + h
        ab1 = pip.tmap2(lambda x, y: torch.stack([x, y], dim=1), g_a, b1_full)
        sr_bits = torch.stack([s_bits, r_bits], dim=1)  # (255, 2, B)
        muls = W.scalar_mul_bits_jac(FqOps, ab1, sr_bits)
        sA = pip.tmap(lambda a: a[:, 0], muls)
        rB1 = pip.tmap(lambda a: a[:, 1], muls)
        g_c = W.add(FqOps, sA, rB1)
        g_c = W.add(FqOps, g_c, W.neg(FqOps, rs_delta))
        g_c = W.add(FqOps, g_c, l_acc)
        g_c = W.add(FqOps, g_c, h_acc)

        ax, ay, _ = W.normalize(FqOps, g_a)
        cx, cy, _ = W.normalize(FqOps, g_c)
        (bx0, bx1), (by0, by1), _ = W.normalize(Fq2Ops, g_b)
        return torch.stack([ax, ay, cx, cy, bx0, bx1, by0, by1], dim=0)

    # ------------------------------------------------------------------
    def prove(self, assignments: list[dict], rs=None) -> list[Proof]:
        """assignments: per-proof witness dicts (witness_inputs_host).
        rs: per-proof (r, s) blinding scalars; drawn from os.urandom when
        None.  Stage wall-times land in ``self.last_timings`` (they bound
        device work only when ``self.sync_stages`` is set).  Set
        ZEROCHAIN_TRACE=<dir> for a torch.profiler trace of the call."""
        with device_trace(trace_dir_from_env()):
            return self._prove_impl(assignments, rs)

    def _prove_impl(self, assignments: list[dict], rs=None) -> list[Proof]:
        def sync():
            torch.cuda.synchronize(self.device)

        rec = StageRecorder(
            sync if self.sync_stages and self.device.type == "cuda" else None)
        self.last_timings = rec.timings

        B = len(assignments)
        with rec.stage("witness"):
            inputs_host, witness_fn = self._witness_fns()
            aux, public = witness_fn(**inputs_host(assignments, self.device))

        # all five MSMs carry the whole proof batch B in one kernel pass
        # (the reference's bellman loops per proof; SURVEY.md §3.2) and
        # run at their dense (density-gathered) sizes
        with rec.stage("quotient"):
            witness_mont, h_scalars = self._quotient(aux, public)
        with rec.stage("digits"):
            if self.msm_impl == "suffix":
                ap, b1p, b2p, lp, hp = self._digits(witness_mont, h_scalars)
                run = self._msm_chunked_suffix
            else:
                ap, b1p, b2p, lp, hp = self._bits(witness_mont, h_scalars)
                run = self._msm_chunked
        with rec.stage("msm_a"):
            a_acc = run(FqOps, self.a_chunks, ap)
        with rec.stage("msm_b1"):
            b1_acc = run(FqOps, self.b1_chunks, b1p)
        with rec.stage("msm_b2"):
            b2_acc = run(Fq2Ops, self.b2_chunks, b2p)
        with rec.stage("msm_l"):
            l_acc = run(FqOps, self.l_chunks, lp)
        with rec.stage("msm_h"):
            h_acc = run(FqOps, self.h_chunks, hp)

        with rec.stage("assemble"):
            if rs is None:
                rs = [
                    (
                        int.from_bytes(os.urandom(32), "little") % R,
                        int.from_bytes(os.urandom(32), "little") % R,
                    )
                    for _ in range(B)
                ]
            dev = self.device
            r_bits = pip.scalars_to_bits([r for r, _ in rs], 255, dev)
            s_bits = pip.scalars_to_bits([s for _, s in rs], 255, dev)
            rs_bits = pip.scalars_to_bits([r * s % R for r, s in rs], 255, dev)

            coords = self._assemble(
                a_acc, b1_acc, b2_acc, l_acc, h_acc, r_bits, s_bits, rs_bits
            )
            vals = FQ.to_ints(coords.movedim(0, 1), mont=True)  # 8 * B ints

        proofs = []
        for b in range(B):
            ax, ay, cx, cy, bx0, bx1, by0, by1 = (
                vals[i * B + b] for i in range(8))
            proofs.append(
                Proof(a=(ax, ay), b=((bx0, bx1), (by0, by1)), c=(cx, cy)))
        return proofs

    def public_inputs(self, assignments: list[dict]) -> list[list[int]]:
        """The runtime public inputs per proof (without ONE): 22 for
        confidential, 104 for anonymous (modules/zk-system/src/lib.rs:22-23)."""
        inputs_host, witness_fn = self._witness_fns()
        _, public = witness_fn(**inputs_host(assignments, self.device))
        n_pub, B = public.shape[1], public.shape[2]
        vals = FR.to_ints(public, mont=True)  # index j * B + b
        return [[vals[j * B + b] for j in range(1, n_pub)] for b in range(B)]


class AnonymousProver(ConfidentialProver):
    """Groth16 prover for the AnonymousTransfer circuit (50,514 constraints,
    105 inputs; anonymous_transfer.rs:57): the same pipeline, another
    circuit and witness."""

    CIRCUIT = AnonymousTransfer

    @staticmethod
    def _witness_fns():
        return wanon.witness_inputs_host, wanon.anonymous_witness

    @staticmethod
    def circuit_for(a: dict) -> AnonymousTransfer:
        """The circuit object of one assignment dict of ``prove``, with the
        right ciphertext r * G the dict leaves out (the witness recomputes
        it)."""
        from ..protocol.elgamal import Ciphertext
        from ..protocol.keys import DecryptionKey, EncryptionKey

        ek_sender = EncryptionKey.from_decryption_key(DecryptionKey(a["dec_key"]))
        right = Ciphertext.encrypt(a["amount"], a["randomness"], ek_sender).right
        return AnonymousTransfer(
            amount=a["amount"], remaining_balance=a["remaining_balance"],
            s_index=a["s_index"], t_index=a["t_index"],
            randomness=a["randomness"], alpha=a["alpha"],
            proof_generation_key=a["pgk"], dec_key=a["dec_key"],
            enc_keys=a["enc_keys"], left_ciphertexts=a["left_ciphertexts"],
            right_ciphertext=right, enc_balances=a["enc_balances"],
            g_epoch=a["g_epoch"])


class MiniProver(ConfidentialProver):
    """Tiny fixture prover (models/mini.py): drives the full
    witness->NTT->MSM->assembly pipeline end-to-end at a test-friendly
    scale."""

    CIRCUIT = MiniCommit

    @staticmethod
    def _witness_fns():
        return wmini.witness_inputs_host, wmini.mini_witness

    @staticmethod
    def circuit_for(a: dict) -> MiniCommit:
        return MiniCommit(amount=a["amount"])


def _queries_to(queries, device):
    """Move a tuple of point tuples to ``device``."""
    return tuple(pip.tmap(lambda a: a.to(device), q) for q in queries)


def queries_from_arrays(z) -> tuple:
    """Mapping with keys h_x ... b2_z1 (int32 word planes (12, n)) -> the
    five query point tuples as CPU tensors."""
    def pt(prefix, g2=False):
        def leaf(key):
            return torch.from_numpy(np.ascontiguousarray(z[key]))
        if g2:
            return tuple((leaf(f"{prefix}_{n}0"), leaf(f"{prefix}_{n}1"))
                         for n in ("x", "y", "z"))
        return tuple(leaf(f"{prefix}_{n}") for n in ("x", "y", "z"))

    return (pt("h"), pt("l"), pt("a"), pt("b1"), pt("b2", g2=True))
