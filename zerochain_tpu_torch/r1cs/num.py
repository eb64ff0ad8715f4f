"""AllocatedNum gadget (Sapling `circuit::num` semantics)."""

from __future__ import annotations

from ..mirror.field import R, fr_inv
from .system import ConstraintSystem, ONE, SynthesisError


class AllocatedNum:
    def __init__(self, var, value):
        self.var = var
        self.value = value  # int mod R | None

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value) -> "AllocatedNum":
        var = cs.alloc("num", value)
        return cls(var, None if value is None else value % R)

    def square(self, cs) -> "AllocatedNum":
        val = None if self.value is None else self.value * self.value % R
        var = cs.alloc("squared num", val)
        cs.enforce(
            "squaring constraint", [(self.var, 1)], [(self.var, 1)], [(var, 1)]
        )
        return AllocatedNum(var, val)

    def mul(self, cs, other: "AllocatedNum") -> "AllocatedNum":
        val = (
            None
            if self.value is None or other.value is None
            else self.value * other.value % R
        )
        var = cs.alloc("product num", val)
        cs.enforce(
            "multiplication constraint",
            [(self.var, 1)],
            [(other.var, 1)],
            [(var, 1)],
        )
        return AllocatedNum(var, val)

    def assert_nonzero(self, cs):
        if self.value is not None:
            if self.value == 0:
                raise SynthesisError("division by zero")
            inv = fr_inv(self.value)
        else:
            inv = None
        inv_var = cs.alloc("ephemeral inverse", inv)
        cs.enforce(
            "nonzero assertion constraint",
            [(self.var, 1)],
            [(inv_var, 1)],
            [(ONE, 1)],
        )

    def inputize(self, cs):
        input_var = cs.alloc_input("input variable", self.value)
        cs.enforce(
            "enforce input is correct",
            [(input_var, 1)],
            [(ONE, 1)],
            [(self.var, 1)],
        )
