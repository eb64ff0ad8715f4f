"""Recording constraint system with bellman-compatible golden hash.

Variables are ``('I', i)`` (public input) or ``('A', i)`` (auxiliary)
tuples; linear combinations are lists of ``(variable, coeff)`` terms with
coefficients in Fr.  The BLAKE2s hash over (counts, per-constraint
deduplicated LCs) reproduces the reference's `TestConstraintSystem::hash`
(core/proofs/src/circuit/test.rs:228-251) bit-for-bit, which is the parity
oracle for circuit structure.
"""

from __future__ import annotations

import hashlib
from contextlib import contextmanager

from ..mirror.field import R

Variable = tuple  # ('I'|'A', index)
ONE: Variable = ("I", 0)

LinearCombination = list  # [(Variable, int coeff mod R)]


class SynthesisError(Exception):
    pass


def _proc_lc(terms):
    """Deduplicate terms, drop zero coefficients, sort Input-first-by-index.

    Mirrors proc_lc (test.rs:71-95)."""
    acc = {}
    for var, coeff in terms:
        acc[var] = (acc.get(var, 0) + coeff) % R
    out = [(v, c) for v, c in acc.items() if c != 0]
    out.sort(key=lambda t: (0 if t[0][0] == "I" else 1, t[0][1]))
    return out


class ConstraintSystem:
    """Records allocations and constraints; evaluates satisfiability.

    With ``track_names=True`` it also records full namespace paths so the
    reference's golden input-name assertions can be checked
    (confidential_transfer.rs:386-409)."""

    def __init__(self, track_names: bool = True):
        self.inputs: list = [1]  # values (int) or None; ONE is always 1
        self.aux: list = []
        self.constraints: list = []  # (a_terms, b_terms, c_terms)
        self.track_names = track_names
        self.input_names: list = ["ONE"]
        self.aux_names: list = []
        self.constraint_names: list = []
        self._ns: list = []

    # -- namespaces ----------------------------------------------------
    @contextmanager
    def namespace(self, name: str):
        self._ns.append(name)
        try:
            yield self
        finally:
            self._ns.pop()

    def _path(self, name: str) -> str:
        assert "/" not in name, "'/' is not allowed in names"
        return "/".join([*self._ns, name])

    # -- allocation ----------------------------------------------------
    def alloc(self, name: str, value) -> Variable:
        idx = len(self.aux)
        self.aux.append(None if value is None else value % R)
        if self.track_names:
            self.aux_names.append(self._path(name))
        return ("A", idx)

    def alloc_input(self, name: str, value) -> Variable:
        idx = len(self.inputs)
        self.inputs.append(None if value is None else value % R)
        if self.track_names:
            self.input_names.append(self._path(name))
        return ("I", idx)

    def enforce(self, name: str, a, b, c):
        self.constraints.append((list(a), list(b), list(c)))
        if self.track_names:
            self.constraint_names.append(self._path(name))

    # -- witness access -------------------------------------------------
    def value(self, var) -> int | None:
        kind, idx = var
        return self.inputs[idx] if kind == "I" else self.aux[idx]

    def eval_lc(self, terms) -> int:
        acc = 0
        for var, coeff in terms:
            v = self.value(var)
            if v is None:
                raise SynthesisError("missing assignment")
            acc += v * coeff
        return acc % R

    def which_is_unsatisfied(self):
        for i, (a, b, c) in enumerate(self.constraints):
            if self.eval_lc(a) * self.eval_lc(b) % R != self.eval_lc(c):
                return self.constraint_names[i] if self.track_names else i
        return None

    def is_satisfied(self) -> bool:
        return self.which_is_unsatisfied() is None

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    @property
    def num_inputs(self) -> int:
        return len(self.inputs)

    def get_input(self, index: int, path: str | None = None) -> int:
        if path is not None and self.track_names:
            assert self.input_names[index] == path, (
                f"{self.input_names[index]!r} != {path!r}"
            )
        return self.inputs[index]

    # -- golden hash (test.rs:228-251) -----------------------------------
    def hash(self) -> str:
        h = hashlib.blake2s(digest_size=32)
        h.update(len(self.inputs).to_bytes(8, "big"))
        h.update(len(self.aux).to_bytes(8, "big"))
        h.update(len(self.constraints).to_bytes(8, "big"))
        for a, b, c in self.constraints:
            for lc in (a, b, c):
                terms = _proc_lc(lc)
                h.update(len(terms).to_bytes(8, "big"))
                for (kind, idx), coeff in terms:
                    h.update(b"I" if kind == "I" else b"A")
                    h.update(idx.to_bytes(8, "big"))
                    h.update(coeff.to_bytes(32, "big"))
        return h.hexdigest()
