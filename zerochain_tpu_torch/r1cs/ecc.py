"""Jubjub Edwards-curve gadgets (Sapling `circuit::ecc` semantics).

Constraint shapes follow the public Sapling gadget library (the reference's
external `scrypto::circuit::ecc`, SURVEY.md §2.3): complete twisted-Edwards
add/double, window-3 fixed-base lookup multiplication over the 84-chunk
tables from JubjubParams (mirror.jubjub.fixed_base_circuit_generators), and
conditional-select variable-base double-and-add.  Validated by the golden
constraint count/hash (confidential_transfer.rs:383-384).
"""

from __future__ import annotations

from ..mirror import jubjub as jj
from ..mirror.field import R, fr_inv
from .system import ConstraintSystem, ONE, SynthesisError
from .boolean import Boolean, AllocatedBit
from .num import AllocatedNum

D = jj.EDWARDS_D


def synth(window_size: int, constants):
    """Multilinear lookup coefficients (Sapling `lookup::synth`).

    assignment[S] after processing = sum over subsets with Möbius signs so
    that  f(i) = Σ_{S ⊆ i} assignment[S]."""
    n = 1 << window_size
    assignment = [0] * n
    for i, constant in enumerate(constants):
        cur = (constant - assignment[i]) % R
        assignment[i] = cur
        for j in range(i + 1, n):
            if j & i == i:
                assignment[j] = (assignment[j] + cur) % R
    return assignment


def lookup3_xy(cs, bits, coords):
    """3-bit window lookup into 8 affine points; returns (x, y) nums."""
    assert len(bits) == 3 and len(coords) == 8
    vals = [b.get_value() for b in bits]
    if None in vals:
        idx = None
        res_x = res_y = None
    else:
        idx = int(vals[0]) | (int(vals[1]) << 1) | (int(vals[2]) << 2)
        res_x, res_y = coords[idx]

    with cs.namespace("x"):
        x = AllocatedNum.alloc(cs, res_x)
    with cs.namespace("y"):
        y = AllocatedNum.alloc(cs, res_y)

    x_coeffs = synth(3, [c[0] for c in coords])
    y_coeffs = synth(3, [c[1] for c in coords])

    with cs.namespace("precomp"):
        precomp = Boolean.and_(cs, bits[1], bits[2])

    def lookup_constraint(name, res_var, coeffs):
        a = (
            [(ONE, coeffs[0b001])]
            + bits[1].lc(coeffs[0b011])
            + bits[2].lc(coeffs[0b101])
            + precomp.lc(coeffs[0b111])
        )
        b = bits[0].lc(1)
        c = (
            [(res_var, 1), (ONE, (R - coeffs[0b000]) % R)]
            + bits[1].lc(R - coeffs[0b010])
            + bits[2].lc(R - coeffs[0b100])
            + precomp.lc(R - coeffs[0b110])
        )
        cs.enforce(name, a, b, c)

    lookup_constraint("x-coordinate lookup", x.var, x_coeffs)
    lookup_constraint("y-coordinate lookup", y.var, y_coeffs)
    return x, y


class EdwardsPoint:
    def __init__(self, x: AllocatedNum, y: AllocatedNum):
        self.x = x
        self.y = y

    def get_point(self):
        if self.x.value is None or self.y.value is None:
            return None
        return (self.x.value, self.y.value)

    # -- allocation -----------------------------------------------------
    @classmethod
    def witness(cls, cs, p, check_on_curve: bool = True):
        """Allocate an (x, y) witness and prove it is on the curve."""
        with cs.namespace("x"):
            x = AllocatedNum.alloc(cs, None if p is None else p[0])
        with cs.namespace("y"):
            y = AllocatedNum.alloc(cs, None if p is None else p[1])
        with cs.namespace("on curve check"):
            return cls.interpret(cs, x, y)

    @classmethod
    def interpret(cls, cs, x, y):
        """-x^2 + y^2 = 1 + d x^2 y^2"""
        with cs.namespace("x^2"):
            x2 = x.square(cs)
        with cs.namespace("y^2"):
            y2 = y.square(cs)
        with cs.namespace("x^2 y^2"):
            x2y2 = x2.mul(cs, y2)
        cs.enforce(
            "on curve check",
            [(x2.var, R - 1), (y2.var, 1)],
            [(ONE, 1)],
            [(ONE, 1), (x2y2.var, D)],
        )
        return cls(x, y)

    def inputize(self, cs):
        with cs.namespace("x"):
            self.x.inputize(cs)
        with cs.namespace("y"):
            self.y.inputize(cs)

    # -- group law -------------------------------------------------------
    def double(self, cs) -> "EdwardsPoint":
        xv, yv = self.x.value, self.y.value
        known = xv is not None and yv is not None
        if known:
            t_v = (xv + yv) * (xv + yv) % R
            a_v = xv * yv % R
            c_v = D * a_v % R * a_v % R
            x3_v = 2 * a_v % R * fr_inv((1 + c_v) % R) % R
            y3_v = (t_v - 2 * a_v) % R * fr_inv((1 - c_v) % R) % R
        else:
            t_v = a_v = c_v = x3_v = y3_v = None

        with cs.namespace("T"):
            t = AllocatedNum.alloc(cs, t_v)
        cs.enforce(
            "T computation",
            [(self.x.var, 1), (self.y.var, 1)],
            [(self.x.var, 1), (self.y.var, 1)],
            [(t.var, 1)],
        )
        with cs.namespace("A computation"):
            a = self.x.mul(cs, self.y)
        with cs.namespace("C"):
            c = AllocatedNum.alloc(cs, c_v)
        cs.enforce("C computation", [(a.var, D)], [(a.var, 1)], [(c.var, 1)])
        with cs.namespace("x3"):
            x3 = AllocatedNum.alloc(cs, x3_v)
        cs.enforce(
            "x3 computation",
            [(ONE, 1), (c.var, 1)],
            [(x3.var, 1)],
            [(a.var, 2)],
        )
        with cs.namespace("y3"):
            y3 = AllocatedNum.alloc(cs, y3_v)
        cs.enforce(
            "y3 computation",
            [(ONE, 1), (c.var, R - 1)],
            [(y3.var, 1)],
            [(t.var, 1), (a.var, R - 2)],
        )
        return EdwardsPoint(x3, y3)

    def add(self, cs, other: "EdwardsPoint") -> "EdwardsPoint":
        x1, y1 = self.x.value, self.y.value
        x2, y2 = other.x.value, other.y.value
        known = None not in (x1, y1, x2, y2)
        if known:
            u_v = (x1 + y1) * (x2 + y2) % R
            a_v = y2 * x1 % R
            b_v = x2 * y1 % R
            c_v = D * a_v % R * b_v % R
            x3_v = (a_v + b_v) * fr_inv((1 + c_v) % R) % R
            y3_v = (u_v - a_v - b_v) % R * fr_inv((1 - c_v) % R) % R
        else:
            u_v = a_v = b_v = c_v = x3_v = y3_v = None

        with cs.namespace("U"):
            u = AllocatedNum.alloc(cs, u_v)
        cs.enforce(
            "U computation",
            [(self.x.var, 1), (self.y.var, 1)],
            [(other.x.var, 1), (other.y.var, 1)],
            [(u.var, 1)],
        )
        with cs.namespace("A computation"):
            a = other.y.mul(cs, self.x)
        with cs.namespace("B computation"):
            b = other.x.mul(cs, self.y)
        with cs.namespace("C"):
            c = AllocatedNum.alloc(cs, c_v)
        cs.enforce("C computation", [(a.var, D)], [(b.var, 1)], [(c.var, 1)])
        with cs.namespace("x3"):
            x3 = AllocatedNum.alloc(cs, x3_v)
        cs.enforce(
            "x3 computation",
            [(ONE, 1), (c.var, 1)],
            [(x3.var, 1)],
            [(a.var, 1), (b.var, 1)],
        )
        with cs.namespace("y3"):
            y3 = AllocatedNum.alloc(cs, y3_v)
        cs.enforce(
            "y3 computation",
            [(ONE, 1), (c.var, R - 1)],
            [(y3.var, 1)],
            [(u.var, 1), (a.var, R - 1), (b.var, R - 1)],
        )
        return EdwardsPoint(x3, y3)

    def conditionally_select(self, cs, condition: Boolean) -> "EdwardsPoint":
        """condition ? self : (0, 1)."""
        cond_v = condition.get_value()
        if cond_v is None or self.x.value is None:
            xp_v = yp_v = None
        else:
            xp_v = self.x.value if cond_v else 0
            yp_v = self.y.value if cond_v else 1
        with cs.namespace("x'"):
            xp = AllocatedNum.alloc(cs, xp_v)
        cs.enforce(
            "x' computation",
            [(self.x.var, 1)],
            condition.lc(1),
            [(xp.var, 1)],
        )
        with cs.namespace("y'"):
            yp = AllocatedNum.alloc(cs, yp_v)
        # condition * y = y' - (1 - condition)
        not_lc = condition.not_().lc(1)
        c_terms = [(yp.var, 1)] + [(v, (R - co) % R) for v, co in not_lc]
        cs.enforce(
            "y' computation",
            [(self.y.var, 1)],
            condition.lc(1),
            c_terms,
        )
        return EdwardsPoint(xp, yp)

    def mul(self, cs, bits) -> "EdwardsPoint":
        """Variable-base scalar mul over LE bits (double-and-add)."""
        curbase = None
        result = None
        for i, bit in enumerate(bits):
            if curbase is None:
                curbase = self
            else:
                with cs.namespace(f"doubling {i}"):
                    curbase = curbase.double(cs)
            with cs.namespace(f"selection {i}"):
                thisbase = curbase.conditionally_select(cs, bit)
            if result is None:
                result = thisbase
            else:
                with cs.namespace(f"addition {i}"):
                    result = result.add(cs, thisbase)
        if result is None:
            raise SynthesisError("empty bit vector")
        return result

    def assert_not_small_order(self, cs):
        with cs.namespace("first doubling"):
            tmp = self.double(cs)
        with cs.namespace("second doubling"):
            tmp = tmp.double(cs)
        with cs.namespace("third doubling"):
            tmp = tmp.double(cs)
        with cs.namespace("check x != 0"):
            tmp.x.assert_nonzero(cs)


def fixed_base_multiplication(cs, generator_index: int, bits) -> EdwardsPoint:
    """3-bit windowed fixed-base mul using the precomputed chunk tables."""
    windows = jj.fixed_base_circuit_generators(generator_index)
    result = None
    false_c = Boolean.constant(False)
    for i in range(0, len(bits), 3):
        chunk = bits[i : i + 3]
        while len(chunk) < 3:
            chunk = chunk + [false_c]
        widx = i // 3
        assert widx < len(windows), "scalar too long for fixed-base table"
        with cs.namespace(f"window table lookup {widx}"):
            x, y = lookup3_xy(cs, chunk, windows[widx])
        p = EdwardsPoint(x, y)
        if result is None:
            result = p
        else:
            with cs.namespace(f"addition {widx}"):
                result = result.add(cs, p)
    return result
