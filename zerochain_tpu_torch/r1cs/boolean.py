"""Boolean gadgets with Sapling-circuit semantics.

Semantics (constraint shapes, allocation order, bit counts) follow the
public Sapling gadget library that the reference consumes as the external
`scrypto::circuit::boolean` crate (see SURVEY.md §2.3); the in-repo strict
u32 decomposition mirrors core/proofs/src/circuit/range_check.rs:11-196.
Structure is validated by the golden constraint count/hash of the
ConfidentialTransfer circuit (confidential_transfer.rs:383-384).
"""

from __future__ import annotations

from ..mirror.field import R
from .system import ConstraintSystem, ONE, SynthesisError


class AllocatedBit:
    def __init__(self, var, value):
        self.var = var
        self.value = value  # bool | None

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value) -> "AllocatedBit":
        var = cs.alloc("boolean", None if value is None else int(bool(value)))
        # (1 - bit) * bit = 0
        cs.enforce(
            "boolean constraint",
            [(ONE, 1), (var, R - 1)],
            [(var, 1)],
            [],
        )
        return cls(var, value)

    @classmethod
    def alloc_conditionally(cls, cs, value, must_be_false: "AllocatedBit"):
        """(1 - must_be_false - bit) * bit = 0 (range_check.rs strictness)."""
        var = cs.alloc("boolean", None if value is None else int(bool(value)))
        cs.enforce(
            "boolean constraint",
            [(ONE, 1), (must_be_false.var, R - 1), (var, R - 1)],
            [(var, 1)],
            [],
        )
        return cls(var, value)

    @classmethod
    def and_(cls, cs, a: "AllocatedBit", b: "AllocatedBit"):
        val = None if a.value is None or b.value is None else (a.value and b.value)
        var = cs.alloc("and result", None if val is None else int(val))
        cs.enforce("and constraint", [(a.var, 1)], [(b.var, 1)], [(var, 1)])
        return cls(var, val)

    @classmethod
    def and_not(cls, cs, a: "AllocatedBit", b: "AllocatedBit"):
        val = None if a.value is None or b.value is None else (a.value and not b.value)
        var = cs.alloc("and not result", None if val is None else int(val))
        cs.enforce(
            "and not constraint",
            [(a.var, 1)],
            [(ONE, 1), (b.var, R - 1)],
            [(var, 1)],
        )
        return cls(var, val)

    @classmethod
    def nor(cls, cs, a: "AllocatedBit", b: "AllocatedBit"):
        val = None if a.value is None or b.value is None else (not a.value and not b.value)
        var = cs.alloc("nor result", None if val is None else int(val))
        cs.enforce(
            "nor constraint",
            [(ONE, 1), (a.var, R - 1)],
            [(ONE, 1), (b.var, R - 1)],
            [(var, 1)],
        )
        return cls(var, val)

    @classmethod
    def xor(cls, cs, a: "AllocatedBit", b: "AllocatedBit"):
        val = None if a.value is None or b.value is None else (a.value != b.value)
        var = cs.alloc("xor result", None if val is None else int(val))
        # (2a) * b = a + b - c
        cs.enforce(
            "xor constraint",
            [(a.var, 2)],
            [(b.var, 1)],
            [(a.var, 1), (b.var, 1), (var, R - 1)],
        )
        return cls(var, val)


class Boolean:
    """Is(bit) | Not(bit) | Constant(bool)."""

    def __init__(self, kind, bit=None, const=None):
        self.kind = kind  # 'is' | 'not' | 'const'
        self.bit = bit
        self.const = const

    @classmethod
    def from_bit(cls, bit: AllocatedBit):
        return cls("is", bit=bit)

    @classmethod
    def constant(cls, b: bool):
        return cls("const", const=b)

    def not_(self) -> "Boolean":
        if self.kind == "const":
            return Boolean.constant(not self.const)
        return Boolean("not" if self.kind == "is" else "is", bit=self.bit)

    def get_value(self):
        if self.kind == "const":
            return self.const
        if self.bit.value is None:
            return None
        return self.bit.value if self.kind == "is" else not self.bit.value

    def lc(self, coeff: int):
        """Terms of coeff * self."""
        coeff %= R
        if self.kind == "const":
            return [(ONE, coeff)] if self.const else []
        if self.kind == "is":
            return [(self.bit.var, coeff)]
        return [(ONE, coeff), (self.bit.var, (R - coeff) % R)]

    @staticmethod
    def and_(cs, a: "Boolean", b: "Boolean") -> "Boolean":
        if a.kind == "const":
            return b if a.const else Boolean.constant(False)
        if b.kind == "const":
            return a if b.const else Boolean.constant(False)
        if a.kind == "is" and b.kind == "is":
            return Boolean.from_bit(AllocatedBit.and_(cs, a.bit, b.bit))
        if a.kind == "is" and b.kind == "not":
            return Boolean.from_bit(AllocatedBit.and_not(cs, a.bit, b.bit))
        if a.kind == "not" and b.kind == "is":
            return Boolean.from_bit(AllocatedBit.and_not(cs, b.bit, a.bit))
        return Boolean.from_bit(AllocatedBit.nor(cs, a.bit, b.bit))

    @staticmethod
    def xor(cs, a: "Boolean", b: "Boolean") -> "Boolean":
        if a.kind == "const":
            return b if not a.const else b.not_()
        if b.kind == "const":
            return a if not b.const else a.not_()
        if a.kind == "is" and b.kind == "is":
            return Boolean.from_bit(AllocatedBit.xor(cs, a.bit, b.bit))
        if a.kind != b.kind:  # is/not or not/is
            base = Boolean.xor(
                cs,
                Boolean("is", bit=a.bit),
                Boolean("is", bit=b.bit),
            )
            return base.not_()
        # not/not == is xor is
        return Boolean.from_bit(AllocatedBit.xor(cs, a.bit, b.bit))


def field_into_allocated_bits_le(cs, value, num_bits: int = 252):
    """LE bit decomposition of an Fs scalar: NUM_BITS allocated booleans."""
    if value is None:
        bits = [None] * num_bits
    else:
        bits = [bool((value >> i) & 1) for i in range(num_bits)]
    out = []
    for i, b in enumerate(bits):
        with cs.namespace(f"bit {i}"):
            out.append(AllocatedBit.alloc(cs, b))
    return out


def field_into_boolean_vec_le(cs, value, num_bits: int = 252):
    return [Boolean.from_bit(b) for b in field_into_allocated_bits_le(cs, value, num_bits)]


def _kary_and(cs, bits):
    cur = bits[0]
    for i, b in enumerate(bits[1:], start=1):
        with cs.namespace(f"and {i}"):
            cur = AllocatedBit.and_(cs, cur, b)
    return cur


def u32_into_bit_vec_le(cs, amount):
    """Strict u32 range decomposition (range_check.rs:11-196).

    Upper bound is u32::MAX - 1 = 0xFFFFFFFE: values are constrained to
    [0, 2^32 - 2]; returns 32 LE Booleans."""
    with cs.namespace("allocated num to check range."):
        num_var = cs.alloc("num", None if amount is None else int(amount))
        value = None if amount is None else int(amount)

    with cs.namespace("range check within u32"):
        bound = 0xFFFFFFFE
        bound_bits = [(bound >> (31 - i)) & 1 for i in range(32)]  # BE
        a_bits = (
            None
            if value is None
            else [(value >> (31 - i)) & 1 for i in range(32)]
        )
        if value is not None and value >> 32:
            raise SynthesisError("value exceeds 32 bits")

        result = []  # big-endian AllocatedBits
        current_run = []
        last_run = None
        for i, b in enumerate(bound_bits):
            a_bit = None if a_bits is None else bool(a_bits[i])
            if b:
                with cs.namespace(f"bit {i}"):
                    bit = AllocatedBit.alloc(cs, a_bit)
                current_run.append(bit)
                result.append(bit)
            else:
                if current_run:
                    if last_run is not None:
                        current_run.append(last_run)
                    with cs.namespace(f"run ending at {i}"):
                        last_run = _kary_and(cs, current_run)
                    current_run = []
                with cs.namespace(f"bit {i}"):
                    bit = AllocatedBit.alloc_conditionally(cs, a_bit, last_run)
                result.append(bit)
        assert not current_run

        # unpacking constraint: 0 * 0 = (sum 2^k bit_k) - num
        lc = []
        coeff = 1
        for bit in reversed(result):
            lc.append((bit.var, coeff))
            coeff = coeff * 2 % R
        lc.append((num_var, R - 1))
        cs.enforce("unpacking constraint", [], [], lc)

    return [Boolean.from_bit(b) for b in reversed(result)]
