"""Count the operations of the twisted cylinder chain, of the numeric
exteriors, of the complex-omega slab chain, of the real-omega slab chain,
the row class of the density/axial-flow cylinder chain and the complex-
omega cylinder (its chains and their row class apart, for the tabled
kernel's count) that chip_smoke.py's bounds use (its OPS entries
"cyl_tw_*", "slab_ext_*", "cyl_ext_*", "slab_cx_*", "slab_*chain",
"slab_*update", "cyl_*step", "cyl_cx_*", "cyl_tw_cx_*").

    python tools_torch/count_ops.py

prints the traced counts ("traced") and the entries of OPS ("ops").

The numeric exteriors (`exterior_ops`): one RK4 step of `ode._step` with
the plain right-hand sides of `physics/slab.py` and `physics/cylinder.py`
(the order csrc/common.cuh::slab_exterior, cyl_exterior follow), traced on
symbols: per candidate and step what depends on the state or on the
candidate and the abscissa, per candidate what depends on the candidate
alone (the cylinder's m^2), each exp one operation. The cylinder's
abscissae t and its step depend on k alone (t0 = ln(W 2 pi / k)), so its
exp(2 t) at each abscissa is needed once per distinct k
("cyl_ext_k_step"), as are the set-up ("cyl_ext_k_ends"). By hand, the
abscissa x0 + i h (the cylinder's; the slab's right-hand side reads none),
the renormalisation every 64th step and the set-up and end of each
(below).

The density/axial-flow cylinder chain (`cylinder_ops`): one evaluation of
`physics/cylinder.py::_plain_coefficients`' invF_g (the order csrc/
cylinder_disp.cu follows) traced on symbols omega, k, m and r, tallied by
what each operation depends on. k U, alpha^2, cusp^2 and (c^2 + vA^2)
(m^2/r^2 + k^2) depend on (k, m, r) and not on omega: per distinct (k,
m) row and abscissa ("cyl_row_step", "cyl_log_row_step", 3 evaluations a
step), once for every candidate of the row. The per-candidate counts
("cyl_step", "cyl_log_step") are the chain's hand counts (`CYL_STEP`)
less that class. For a kernel that keeps a step's first chain where its
abscissa is the step before's last (the fused bisection), the same counts
apart: the rest of one evaluation per candidate ("cyl_chain", 3 a step, or
2 where the chain is kept) and the update ("cyl_update", on the log tail
"cyl_log_update").

Traces `physics/cylinder.py::CylinderPhysics.twisted_chain` (the order of
operations that csrc/cylinder_disp.cu::twisted_chain follows) on symbols
instead of tensors and counts each operation the outputs need once:

- an operation repeated on the same operands is one (a dual square's two
  cross products, k B_z in the Alfven term and in f B), a constant being
  one operand however often the source writes it;
- a negation is free (an operand modifier on the card), and so is a
  product or a quotient by an exact 1 (the radius' unit tangent dr/dr,
  and r itself at r = 1) and a product by an exact -1 (d(1/r)/dr at
  r = 1);
- an exact 0 propagates: with B_phi = 0 the terms in B_phi vanish;
- by what each result depends on: the radius alone (once per abscissa and
  launch: the table's job), the candidate alone (once per candidate), both
  (per candidate and abscissa), neither (a constant of the launch, 0).

Per RK4 step, 3 evaluations of the chain with (1/F, g) (physics/cylinder.py
`twisted_chain`, `twisted_invF_g`), per evaluation the chain's values at
r = 1 and F(1), C1(1)/C3(1). The parts that the trace does not cover are
counted by hand from csrc/cylinder_twisted.cu and csrc/cylinder.cuh below.

The real-omega slab chain (`slab_ops`): one evaluation of
`physics/slab.py::make_flux_coef`'s and `make_shear_coef`'s coef (the
order csrc/slab_disp.cu::flux_coef, shear_coef follow; the flux form's
zero flow, the shear form's corrected D) traced on symbols omega, k
(the candidate, "c") and the profiles' values at x ("x"): what depends on
both is the chain a candidate needs at an abscissa ("slab_chain",
"slab_shear_chain"); what depends on x alone is the scan's table
("*_x_step"), on the candidate alone its ends ("*_ends"). The update
("slab_update", "slab_shear_update"): one step of `_rk4_linear` over
`_apply_flux` / `_apply_shear` from a state of symbols, with the chain's
values at the 3 abscissae as symbols, as for the complex chain. A step
needs the update once per candidate and the chain once per distinct
(omega, k) at each of its distinct abscissae: 2 a step and 1 more a shoot
where n_interior is a power of two (the step before's last abscissa is
the next step's first, bit for bit), else 3.

The complex-omega slab chain (`complex_ops`): `physics/slab.py::
complex_shear_coef` (the order csrc/slab_complex.cu::shear_coef follows),
its value pass and its dual pass in omega, traced on symbols with complex
numbers as pairs (`cplx.C`): per RK4 step 3 evaluations at the abscissae
(x-dependent and candidate-dependent: "slab_cx_step", "slab_cx_dual_step",
with the complex update of the state traced from `_rk4_linear` over
`_apply_shear`; one evaluation of the chain alone "slab_cx_chain",
"slab_cx_dual_chain"), per evaluation the interface (`complex_edge`,
`complex_det`, and for the value pass `complex_mismatch`: "slab_cx_ends",
"slab_cx_dual_ends", the candidate's products of k included), and per
Newton step `search.newton_step` ("slab_cx_newton"). A complex quotient is
counted as Smith's algorithm needs it, by its real divisions: the divisor's
rat = d/c and scl = 1/(c + d rat) (4 operations, shared by every quotient
by it), then ((a + b rat) scl, (b - a rat) scl) (6; a real numerator 3);
|z| as m sqrt(1 + (n/m)^2) (5), the principal root by the branch it takes
(sqrt((|a| + |z|)/2), b/(2t): 5 and |z|); a maximum or a comparison is one
operation, a select none. The x-only values (U, U', U'') are the shear
form's table, "slab_shear_x_step".

A bound counts what the function needs, not what one way of computing it
spends. The chain multiplies by reciprocals of its r-only divisors (1/r,
1/r^2, 1/sqrt(rho)) and by the cusp ratio c_i / sqrt(c^2 + vA^2), which
the trace counts where they are formed. Its quotient form, which divides
by those values where they occur, took fewer operations in some parts:
`QUOTIENT_FORM`, traced by this script from the chain of commit 6809e05.
Each count is the lower of the two.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# counted by hand from csrc/cylinder_twisted.cu and csrc/cylinder.cuh
RK4_UPDATE = 68      # rk4_step2: 4 x 4 slopes, 3 x 8 midpoints, 4 x 7 sums
FINISH = 35          # finish() without the K_m ratio and k k (the chain's)
# r_point_tw per abscissa, the launch constants aside: the profiles, P, c_i,
# B_phi, B_z, vA, c^2 + vA^2 and its root (84), the cusp ratio c_i / sqrt(c^2
# + vA^2) (4), 1/r (2), r r and its derivative (2), 1/r^2 (3)
R_POINT = 95
LAUNCH_CONSTANTS = 3  # sqrt(rho), 1/sqrt(rho), rho v_twist^2
J_TERM = 8           # J = B_phi(1)^2 - rho v_phi(1)^2
ABSCISSAE = 4        # x0 + i h, + h/2, + h
# the numeric exteriors, by hand from csrc/common.cuh: the cylinder's
# abscissa x0 + i h (2); the slab's rescaling every 64th step (max(|y0|,
# |y1|), its test, 2 divisions); set-up (the span W 2 pi / k, 1 + it or its
# log, the spacing h, h/2, h/6: slab 6, cylinder 7 with the start D = -1e-8
# r_far) and the end (vx'/vx or dP/P: 1)
EXT_ABSCISSA = 2
EXT_RENORM = 4
EXT_ENDS = {"slab_ext_ends": 6 + 1, "cyl_ext_ends": 1}
EXT_K_ENDS = 7       # the cylinder's set-up, which depends on k alone
# the density/axial-flow chain per candidate and RK4 step, by hand from
# csrc/cylinder_disp.cu: 3 evaluations of invF_g (29 each, the tests of the
# zero-valued terms included) and the update; on the log tail also (r iF,
# r g) (6)
CYL_EVAL = 29
CYL_LOG_EXTRA = 6
CYL_STEP = {"cyl_step": 3 * CYL_EVAL + RK4_UPDATE,
            "cyl_log_step": 3 * CYL_EVAL + RK4_UPDATE + CYL_LOG_EXTRA}
# the same counts, traced from the chain in its quotient form (commit
# 6809e05: dual quotients by r, r^2, sqrt(rho) and sqrt(c^2 + vA^2))
QUOTIENT_FORM = {"cyl_tw_step": 590, "cyl_tw_ends": 85,
                 "cyl_tw_r_step": 298, "cyl_tw_launch": 99,
                 "cyl_tw_b0_step": 425, "cyl_tw_b0_ends": 75}


class Sym:
    """A value of the trace: what it depends on ("r", "c"), the operation
    and operands that formed it, or a known constant."""

    nodes: dict = {}
    consts: dict = {}

    def __init__(self, deps=frozenset(), val=None, key=None, args=(),
                 free=False):
        self.deps, self.val, self.key, self.args, self.free = (
            frozenset(deps), val, key, args, free)

    @staticmethod
    def of(x) -> "Sym":
        """x, or the one constant Sym of its value: a constant that two
        calls form (2.0 in exp(2.0 t) at the same t) is the same operand,
        so what it forms is counted once."""
        if isinstance(x, Sym):
            return x
        return Sym.consts.setdefault(float(x), Sym(val=float(x)))

    def _op(self, op: str, other, swap: bool = False):
        from eigensolver_tpu_torch.cplx import C, Divisor
        from eigensolver_tpu_torch.dual import Dual
        if isinstance(other, (C, Divisor, Dual)):
            return NotImplemented
        a, b = (Sym.of(other), self) if swap else (self, Sym.of(other))
        if op == "*":
            if 0.0 in (a.val, b.val):
                return ZERO
            if a.val == 1.0:
                return b
            if b.val == 1.0:
                return a
            if a.val == -1.0:
                return -b
            if b.val == -1.0:
                return -a
        elif op == "/":
            if a.val == 0.0 or b.val == 1.0:
                return a
        elif op == "+":
            if a.val == 0.0:
                return b
            if b.val == 0.0:
                return a
        elif b.val == 0.0:                                  # "-"
            return a
        elif a.val == 0.0:
            return -b
        ids = (id(a), id(b))
        key = (op, *(sorted(ids) if op in "+*" else ids))
        if key not in Sym.nodes:
            Sym.nodes[key] = Sym(a.deps | b.deps, key=key, args=(a, b))
        return Sym.nodes[key]

    def __add__(self, o): return self._op("+", o)
    def __radd__(self, o): return self._op("+", o, swap=True)
    def __sub__(self, o): return self._op("-", o)
    def __rsub__(self, o): return self._op("-", o, swap=True)
    def __mul__(self, o): return self._op("*", o)
    def __rmul__(self, o): return self._op("*", o, swap=True)
    def __truediv__(self, o): return self._op("/", o)
    def __rtruediv__(self, o): return self._op("/", o, swap=True)

    def __pow__(self, p):
        if p != 2:
            return NotImplemented
        return self * self

    @staticmethod
    def _unary(op: str, a) -> "Sym":
        a = Sym.of(a)
        key = (op, id(a))
        if key not in Sym.nodes:
            Sym.nodes[key] = Sym(a.deps, key=key, args=(a,))
        return Sym.nodes[key]

    def __neg__(self):
        if self.val == 0.0:
            return self
        key = ("neg", id(self))
        if key not in Sym.nodes:
            Sym.nodes[key] = Sym(self.deps, key=key, args=(self,), free=True)
        return Sym.nodes[key]


ZERO = Sym(val=0.0)
ONE = Sym(val=1.0)


def _point(r, b_phi_zero: bool):
    """A TwistedPoint of symbols at radius r: rho and 1/sqrt(rho)
    constants; 1/r = 1, d(1/r)/dr = -1, 1/r^2 = 1 and d(1/r^2)/dr = -2 at
    r = 1; B_phi = 0 and B_z = B_0 exactly when b_phi_zero."""
    from eigensolver_tpu_torch.dual import Dual
    from eigensolver_tpu_torch.physics.cylinder import TwistedPoint

    def radial():
        return Dual(Sym({"r"}), Sym({"r"}))
    at_one = r is ONE
    return TwistedPoint(
        r=r, iR=Dual(ONE, Sym(val=-1.0)) if at_one else radial(), rho=Sym(),
        isr=Sym(), v=radial(),
        b=Dual(ZERO, ZERO) if b_phi_zero else radial(),
        Bz=Dual(Sym(), ZERO) if b_phi_zero else radial(),
        csum=radial(), cr=radial(), U=radial(), rdc=radial(),
        iRR=Dual(ONE, Sym(val=-2.0)) if at_one else radial())


def _tally(outs) -> dict:
    """Operations that outs need, by dependence: "cr" per candidate and
    abscissa, "r" per abscissa, "c" per candidate."""
    seen, stack, tally = set(), list(outs), {"cr": 0, "r": 0, "c": 0}
    while stack:
        n = stack.pop()
        if n.key is None or id(n) in seen:
            continue
        seen.add(id(n))
        stack.extend(n.args)
        if not n.free and n.deps:
            tally["".join(sorted(n.deps))] += 1
    return tally


def twisted_ops(b_phi_zero: bool) -> dict:
    """chip_smoke.py's OPS entries for the twisted chain, with B_phi = 0
    ("cyl_tw_b0_*") or every term live ("cyl_tw_*"): each the lower of the
    chain's traced count and its quotient form's."""
    return {key: min(n, QUOTIENT_FORM[key])
            for key, n in traced_ops(b_phi_zero).items()}


def traced_ops(b_phi_zero: bool) -> dict:
    """The twisted chain's counts as the trace of the plain chain gives
    them, keyed as twisted_ops."""
    import torch
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    chain = CylinderPhysics.twisted_chain
    Sym.nodes = {}
    om, k, m = Sym({"c"}), Sym({"c"}), Sym({"c"})
    ones_like, full_like = torch.ones_like, torch.full_like
    torch.ones_like = lambda x: ONE         # the unit tangent of R
    torch.full_like = lambda x, v: Sym.of(v)   # profiles.rdiv's numerator
    try:
        r = Sym({"r"})
        q = _point(r, b_phi_zero)
        iF, g = CylinderPhysics.twisted_invF_g(q, chain(q, om, k, m))
        step = _tally([iF, g])
        c1 = chain(_point(ONE, b_phi_zero), om, k, m)
        ends = _tally([ONE * c1.D.v / c1.C3.v, c1.C1.v * ONE / c1.C3.v])
        per_cand = _tally([iF, g, c1.D.v, c1.C1.v, c1.C3.v])["c"]
    finally:
        torch.ones_like, torch.full_like = ones_like, full_like
    f = "cyl_tw_b0_" if b_phi_zero else "cyl_tw_"
    out = {f + "step": 3 * step["cr"] + RK4_UPDATE,
           f + "ends": ends["cr"] + per_cand + FINISH}
    if not b_phi_zero:     # the r-only part: counted with every term live
        out["cyl_tw_r_step"] = 3 * (R_POINT + step["r"]) + ABSCISSAE
        out["cyl_tw_launch"] = (LAUNCH_CONSTANTS + R_POINT + ends["r"]
                                + J_TERM)
    return out


def exterior_ops() -> dict:
    """chip_smoke.py's OPS entries for the numeric exteriors: per candidate
    and RK4 step ("*_ext_step": the slab's without its rescaling,
    "slab_ext_renorm" every 64th step), per candidate ("*_ext_ends": the
    slab's set-up, the cylinder's m^2, the end); per distinct k, the
    cylinder's exps and abscissae a step ("cyl_ext_k_step") and its set-up
    ("cyl_ext_k_ends")."""
    import torch
    from eigensolver_tpu_torch import ode
    Sym.nodes = {}
    m_e, mm = Sym({"c"}), Sym({"c"})
    h, hh, h6, x = (Sym({"k"}) for _ in range(4))
    y = (Sym({"s"}), Sym({"s"}))
    slab = ode._step(lambda x, y: (y[1], m_e * y[0]), y, x, h, hh, h6)
    exp = torch.exp
    torch.exp = lambda a: Sym._unary("exp", a)
    try:
        cyl = ode._step(
            lambda t, y: (y[1], (mm * mm + m_e * torch.exp(2.0 * t)) * y[0]),
            y, x, h, hh, h6)
    finally:
        torch.exp = exp
    ts, tc = _tally_deps(slab), _tally_deps(cyl)

    def per_step(t):
        return sum(n for d, n in t.items() if "s" in d or d == "ck")
    return {"slab_ext_step": per_step(ts), "slab_ext_renorm": EXT_RENORM,
            "slab_ext_ends": EXT_ENDS["slab_ext_ends"] + ts.get("c", 0),
            "cyl_ext_step": per_step(tc),
            "cyl_ext_ends": EXT_ENDS["cyl_ext_ends"] + tc.get("c", 0),
            "cyl_ext_k_step": tc.get("k", 0) + EXT_ABSCISSA,
            "cyl_ext_k_ends": EXT_K_ENDS}


class _RadialEq:
    """An equilibrium whose profiles are values of the radius r, B_z a
    constant of the launch."""

    def __getattr__(self, name):
        if name == "B_i":
            return lambda r: Sym()
        return lambda r: Sym({"r"})


def chain_tally() -> dict:
    """One evaluation of the density/axial-flow chain's invF_g, traced on
    symbols omega ("w"), k, m and r: its operations by what they depend
    on (a zero-valued term, 0/x, counts nothing here)."""
    import types
    import torch
    from eigensolver_tpu_torch.physics import cylinder
    Sym.nodes = {}
    saved = torch.zeros_like, cylinder.sqrt
    torch.zeros_like = lambda x: ZERO
    cylinder.sqrt = lambda a: Sym._unary("sqrt", a)
    try:
        ph = types.SimpleNamespace(eq=_RadialEq())
        ph._plain_parts = (lambda *a:
                           cylinder.CylinderPhysics._plain_parts(ph, *a))
        fns = cylinder.CylinderPhysics._plain_coefficients(
            ph, Sym({"w"}), Sym({"k"}), Sym({"m"}))
        return _tally_deps(list(fns[4](Sym({"r"}))))
    finally:
        torch.zeros_like, cylinder.sqrt = saved


def cylinder_ops() -> dict:
    """chip_smoke.py's OPS entries for the density/axial-flow chain: per
    distinct (k, m) row and RK4 step, the (k, m, r) values of its 3
    evaluations ("cyl_row_step", on the log tail "cyl_log_row_step"); per
    candidate and step the hand counts less them; apart, per candidate
    the rest of one evaluation ("cyl_chain") and a step's update
    ("cyl_update", "cyl_log_update")."""
    t = chain_tally()
    row = 3 * sum(n for d, n in t.items()
                  if "r" in d and "w" not in d and set(d) & {"k", "m"})
    return {"cyl_row_step": row, "cyl_log_row_step": row,
            **{key: n - row for key, n in CYL_STEP.items()},
            "cyl_chain": CYL_EVAL - row // 3, "cyl_update": RK4_UPDATE,
            "cyl_log_update": RK4_UPDATE + CYL_LOG_EXTRA}


def _sym_divisor(z):
    """cplx.Divisor on symbols: the |c| >= |d| branch, (u, v) = (1, rat),
    which the quotients' products by u = 1 then skip."""
    from eigensolver_tpu_torch.cplx import Divisor
    rat = z.im / z.re
    return Divisor(ONE, rat, 1.0 / (z.re + z.im * rat))


def _sym_abs(z):
    """|z| = m sqrt(1 + (n/m)^2), m and n the larger and smaller |part|
    (selects, free)."""
    m, n = Sym._unary("max", z.re), Sym._unary("min", z.im)
    r = n / m
    return m * Sym._unary("sqrt", 1.0 + r * r)


def _sym_sqrt(z):
    """The principal root by the a >= 0 branch: t = sqrt((a + |z|)/2),
    (t, b / (2 t))."""
    from eigensolver_tpu_torch.cplx import C
    t = Sym._unary("sqrt", (z.re + _sym_abs(z)) * 0.5)
    return C(t, z.im / (2.0 * t))


def slab_ops() -> dict:
    """chip_smoke.py's OPS entries for the real-omega slab chain: per
    candidate and abscissa one evaluation of the chain ("slab_chain" in
    the flux form, "slab_shear_chain" in the shear form), per candidate
    and RK4 step the update ("slab_update", "slab_shear_update")."""
    import types
    import torch
    from eigensolver_tpu_torch.physics import slab
    saved = torch.full_like
    torch.full_like = lambda x, v: Sym.of(v)
    try:
        out = {}
        for f, apply in (("slab_", slab._apply_flux),
                         ("slab_shear_", slab._apply_shear)):
            Sym.nodes = {}
            if f == "slab_":
                ph = types.SimpleNamespace(eq=types.SimpleNamespace(
                    U_i=lambda x: ZERO, rho_i=lambda x: Sym({"x"}),
                    c_i=lambda x: Sym({"x"}), vA_i=lambda x: Sym({"x"})))
                coef = slab.SlabPhysics.make_flux_coef(ph, Sym({"c"}),
                                                       Sym({"c"}))
            else:
                ph = types.SimpleNamespace(
                    case=types.SimpleNamespace(shear_D_legacy=False),
                    eq=types.SimpleNamespace(
                        U_i=lambda x: Sym({"x"}),
                        regime=types.SimpleNamespace(c_i0=0.6, vA_i0=1.3)),
                    flow_derivative=lambda order: (lambda x: Sym({"x"})))
                coef = slab.SlabPhysics.make_shear_coef(ph, Sym({"c"}),
                                                        Sym({"c"}))
            out[f + "chain"] = _tally_deps(list(coef(Sym({"x"})))).get(
                "cx", 0)
            Sym.nodes = {}
            calls = iter([(Sym({"c", "x"}), Sym({"c", "x"}))
                          for _ in range(3)])
            h = Sym()
            y = slab._rk4_linear(apply, lambda x: next(calls),
                                 (Sym({"s"}), Sym({"s"})), Sym(), h, 1)
            out[f + "update"] = sum(n for d, n in _tally_deps(list(y)).items()
                                    if "s" in d)
    finally:
        torch.full_like = saved
    return out


class _SymEq:
    """An equilibrium whose values at x = 1 are constants of the launch."""

    def __getattr__(self, name):
        return lambda x: Sym()


class _ComplexPatches:
    """The complex-omega modules with symbols in place of tensors: Smith's
    division by its |c| >= |d| branch, |z| and the principal root by their
    formulas, selects free."""

    def __enter__(self):
        import torch
        from eigensolver_tpu_torch import cplx, dual, search
        from eigensolver_tpu_torch.physics import slab
        patches = [(cplx, "divisor", _sym_divisor),
                   (slab, "divisor", _sym_divisor),
                   (search, "divisor", _sym_divisor),
                   (slab, "cabs", _sym_abs), (search, "cabs", _sym_abs),
                   (slab, "csqrt", _sym_sqrt), (dual, "csqrt", _sym_sqrt),
                   (torch, "maximum", lambda a, b: a._op("max", b)),
                   (search, "where",
                    lambda m, a, b: b if a.re is ZERO else a),
                   (search, "is_zero", lambda z: None),
                   (torch, "zeros_like", lambda x: ZERO),
                   (torch, "full_like", lambda x, v: Sym.of(v))]
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in patches]
        for mod, name, val in patches:
            setattr(mod, name, val)
        Sym.__gt__ = lambda self, o: None
        # complex_edge forms its constants on the device and in the dtype
        # of k
        Sym.device, Sym.dtype = None, torch.float64
        return self

    def __exit__(self, *exc):
        for mod, name, val in self.saved:
            setattr(mod, name, val)
        del Sym.__gt__


def _edge_physics(flow: bool):
    """A SlabPhysics stand-in for complex_edge: the regime's constants, the
    interior's values at x = 1 constants of the launch."""
    import types
    return types.SimpleNamespace(
        eq=types.SimpleNamespace(
            regime=types.SimpleNamespace(
                U_e=0.0, vA_e=1e-12 if flow else 0.8, c_e=2.0 if flow else 1.3,
                cT_e=1e-12 if flow else 0.6, rho_e=5.0),
            U_i=_SymEq().U_i, c_i=_SymEq().c_i,
            vA_i=_SymEq().vA_i, rho_i=_SymEq().rho_i),
        flow_derivative=lambda order: (lambda x: Sym()))


def _cx_state(is_dual: bool, deps=frozenset({"s"})):
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.dual import Dual
    z = C(Sym(deps), Sym(deps))
    return Dual(z, C(Sym(deps), Sym(deps))) if is_dual else z


def _cx_parts(zs, is_dual: bool) -> list:
    """The real parts of complex values (or duals of them)."""
    return [p for z in zs for w in ((z.v, z.d) if is_dual else (z,))
            for p in (w.re, w.im)]


def _cx_update(apply, is_dual: bool) -> int:
    """One step of _rk4_linear over `apply` from a state of symbols, the
    chain's values at the 3 abscissae symbols: its operations."""
    from eigensolver_tpu_torch.physics import slab
    Sym.nodes = {}
    calls = iter([(_cx_state(is_dual, {"c", "x"}),
                   _cx_state(is_dual, {"c", "x"})) for _ in range(3)])
    y = slab._rk4_linear(apply, lambda x: next(calls),
                         (_cx_state(is_dual), _cx_state(is_dual)), Sym(),
                         Sym(), 1)
    return sum(n for d, n in _tally_deps(_cx_parts(y, is_dual)).items()
               if "s" in d)


def complex_flux_ops() -> dict:
    """chip_smoke.py's OPS entries for the complex-omega flux chain
    (physics/slab.py::complex_flux_coef, the order csrc/slab_complex.cu::
    flux_coef follows): per RK4 step and candidate "slab_cx_flux_step"
    (value pass) and "slab_cx_flux_dual_step" (dual pass), of which one of
    the step's 3 chain evaluations is "*_chain"; per evaluation the
    candidate's products (flux_cand), the start's F(0) (complex_flux_F at
    x = 0, whose x-only values are constants of the launch) and the
    interface (complex_edge of the flux form, complex_det, and for the
    value pass complex_mismatch): "slab_cx_flux_ends",
    "slab_cx_flux_dual_ends". The x-only values are the real flux form's
    table, "slab_x_step"."""
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.physics import slab
    out = {}
    with _ComplexPatches():
        for is_dual, f in ((False, "slab_cx_flux_"),
                           (True, "slab_cx_flux_dual_")):
            Sym.nodes = {}
            c = slab.FluxCand(k2=Sym({"c"}), Om2=C(Sym({"c"}), Sym({"c"})),
                              nd=C(Sym({"c"}), Sym({"c"})) if is_dual
                              else None)
            q = tuple(Sym({"x"}) for _ in range(5))
            co = slab.complex_flux_coef(c, q, is_dual)
            chain = _tally_deps(_cx_parts(co, is_dual)).get("cx", 0)
            out[f + "chain"] = chain
            out[f + "step"] = 3 * chain + _cx_update(slab._apply_flux,
                                                     is_dual)
            Sym.nodes = {}
            om, k, par = C(Sym({"c"}), Sym({"c"})), Sym({"c"}), Sym({"c"})
            fc = slab.flux_cand(om, k, is_dual)
            F0 = slab.complex_flux_F(fc, tuple(Sym() for _ in range(5)),
                                     is_dual)
            start = (1.0 - par) * F0
            e = slab.complex_edge(_edge_physics(False), om, k, True, is_dual,
                                  shear=False)
            det, xi_i, PT_e, PT_i = slab.complex_det(
                e, _cx_state(is_dual), _cx_state(is_dual))
            outs = _cx_parts([det, start], is_dual) + [
                fc.k2, fc.Om2.re, fc.Om2.im,
                *((fc.nd.re, fc.nd.im) if is_dual else ())]
            if not is_dual:
                outs.append(slab.complex_mismatch(e, xi_i, PT_e, PT_i))
            out[f + "ends"] = sum(_tally_deps(outs).values())
    return out


def complex_flux_kernel_ops() -> dict:
    """chip_smoke.py's OPS entries for the flux form's kernel of one
    thread a seed (csrc/slab_complex.cu::flux_kernel): the serial RK4
    update of a step, the step's count less its 3 chain evaluations
    ("slab_cx_flux_update", "slab_cx_flux_dual_update"), traced from one
    step of _rk4_linear over _apply_flux; a thread's step is the update
    and the chains it forms, 2 where it keeps the step before's last."""
    from eigensolver_tpu_torch.physics import slab
    with _ComplexPatches():
        return {f"slab_cx_flux_{d}update": _cx_update(slab._apply_flux,
                                                      is_dual)
                for is_dual, d in ((False, ""), (True, "dual_"))}


# the complex numeric exterior's rescaling every 64th step, by hand from
# csrc/slab_complex.cu::exterior_ratio: the two values' moduli (5 each),
# their maximum and its test, and each real part divided by the scale (4;
# on duals 8)
CX_EXT_RENORM = {False: 5 + 5 + 2 + 4, True: 5 + 5 + 2 + 8}


def complex_exterior_ops() -> dict:
    """chip_smoke.py's OPS entries for the numeric exterior at complex
    omega (physics/slab.py::complex_exterior over ode.rk4_final_renorm on
    complex pairs, or duals of them): per candidate and exterior step
    "slab_cx_ext_step" (value pass), "slab_cx_dual_ext_step" (dual pass),
    traced from one ode._step; every 64th step the rescaling
    ("slab_cx_ext_renorm", "slab_cx_dual_ext_renorm"); per candidate the
    set-up (the slab's real one) and the end, the quotient vx'/vx and its
    product with p_e ("slab_cx_ext_ends", "slab_cx_dual_ext_ends")."""
    from eigensolver_tpu_torch import ode
    out = {}
    with _ComplexPatches():
        for is_dual, f in ((False, "slab_cx_"), (True, "slab_cx_dual_")):
            Sym.nodes = {}
            m_e = _cx_state(is_dual, {"c"})
            h, hh, h6, x = (Sym({"k"}) for _ in range(4))
            y = ode._step(lambda x, y: (y[1], m_e * y[0]),
                          (_cx_state(is_dual), _cx_state(is_dual)), x, h, hh,
                          h6)
            out[f + "ext_step"] = sum(
                n for d, n in _tally_deps(_cx_parts(y, is_dual)).items()
                if "s" in d)
            out[f + "ext_renorm"] = CX_EXT_RENORM[is_dual]
            Sym.nodes = {}
            ratio = _cx_state(is_dual) / _cx_state(is_dual)
            PT_e = _cx_state(is_dual, {"c"}) * ratio
            out[f + "ext_ends"] = (EXT_ENDS["slab_ext_ends"] - 1 + sum(
                _tally_deps(_cx_parts([PT_e], is_dual)).values()))
    return out


def complex_ops() -> dict:
    """chip_smoke.py's OPS entries for the complex-omega slab chain (the
    corrected D of slab_flow_complex_coronal, the shear-pressure term on):
    per RK4 step and candidate, "slab_cx_step" (value pass) and
    "slab_cx_dual_step" (dual pass), of which one of the step's 3 chain
    evaluations is "slab_cx_chain", "slab_cx_dual_chain"; per evaluation
    "slab_cx_ends", "slab_cx_dual_ends"; per Newton step
    "slab_cx_newton"."""
    import types
    import torch
    from eigensolver_tpu_torch import search
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.physics import slab
    from eigensolver_tpu_torch.dual import Dual
    with _ComplexPatches():
        out = {}
        for is_dual, f in ((False, "slab_cx_"), (True, "slab_cx_dual_")):
            Sym.nodes = {}
            c = slab.ShearCand(omega=C(Sym({"c"}), Sym({"c"})), k=Sym({"c"}),
                               twok=Sym({"c"}), k2c2=Sym({"c"}),
                               k2a2=Sym({"c"}), k2cT2=Sym({"c"}),
                               k4cT2c2=Sym({"c"}), ca=2.69)
            co = slab.complex_shear_coef(c, Sym({"x"}), Sym({"x"}),
                                         Sym({"x"}), legacy=False,
                                         dual=is_dual)
            parts = ([co[0].v, co[0].d, co[1].v, co[1].d] if is_dual
                     else list(co))
            chain = _tally_deps([p for z in parts for p in (z.re, z.im)])
            # the update: one step of _rk4_linear from a state of symbols
            # with the chain's values at the 3 abscissae as symbols
            def state():
                z = C(Sym({"s"}), Sym({"s"}))
                return Dual(z, C(Sym({"s"}), Sym({"s"}))) if is_dual else z

            def coefs():
                z = C(Sym({"c", "x"}), Sym({"c", "x"}))
                return Dual(z, C(Sym({"c", "x"}), Sym({"c", "x"}))) \
                    if is_dual else z
            calls = iter([(coefs(), coefs()) for _ in range(3)])
            h = Sym()
            y = slab._rk4_linear(slab._apply_shear, lambda x: next(calls),
                                 (state(), state()), Sym(), h, 1)
            flat = [p for z in y for w in ((z.v, z.d) if is_dual else (z,))
                    for p in (w.re, w.im)]
            upd = sum(n for d, n in _tally_deps(flat).items() if "s" in d)
            out[f + "chain"] = chain.get("cx", 0)
            out[f + "step"] = 3 * chain.get("cx", 0) + upd
            # the interface: per candidate, the values at x = 1 constants
            ph = types.SimpleNamespace(
                eq=types.SimpleNamespace(
                    regime=types.SimpleNamespace(
                        U_e=0.0, vA_e=1e-12, c_e=2.0, cT_e=1e-12, rho_e=5.0),
                    U_i=_SymEq().U_i, c_i=_SymEq().c_i,
                    vA_i=_SymEq().vA_i, rho_i=_SymEq().rho_i),
                flow_derivative=lambda order: (lambda x: Sym()))
            Sym.nodes = {}
            Sym.device, Sym.dtype = None, torch.float64
            om = C(Sym({"c"}), Sym({"c"}))
            e = slab.complex_edge(ph, om, Sym({"c"}), True, is_dual)
            vx, dvx = state(), state()
            det, xi_i, PT_e, PT_i = slab.complex_det(e, vx, dvx)
            outs = [det.v, det.d] if is_dual else [det]
            if not is_dual:
                outs.append(C(slab.complex_mismatch(e, xi_i, PT_e, PT_i),
                              ZERO))
            t = _tally_deps([p for z in outs for p in (z.re, z.im)])
            out[f + "ends"] = sum(t.values()) + chain.get("c", 0)
        Sym.nodes = {}
        om = C(Sym({"c"}), Sym({"c"}))
        new = search.newton_step(om, C(Sym({"c"}), Sym({"c"})),
                                 C(Sym({"c"}), Sym({"c"})), 1.0)
        out["slab_cx_newton"] = sum(_tally_deps([new.re, new.im]).values())
    return out


# The complex-omega cylinder ("cyl_cx_*", "cyl_tw_cx_*"): counted, not
# traced, from the plain versions run on a few candidates at small depths
# under a torch function mode (`_OpCount`): each arithmetic operation, root,
# exp, log, atan2, comparison, maximum or minimum on a tensor of the
# candidates is one operation a candidate (negation and |.| free, a select
# none), what depends on the radius alone (0-d tensors) none. Fits over the
# depths give the per-step counts of the interior ("step"), of the log
# tail ("log_step") and of the numeric exterior ("ext_step"), and the
# shoot's ends; the K_m ratio at complex z apart: its series
# ("kve_series"), its CF2 ("kve_cf2") and the rest of it ("kve_ends"),
# since the plain version forms both branches where the kernel forms the
# one its argument takes. "*_ends" are the shoot's ends with the exact
# exterior less the K_m ratio; "*num_ends" the ends with the numeric
# exterior (its set-up and quotient included).
_COUNTED = {
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
    "__truediv__", "__rtruediv__", "add", "sub", "mul", "div", "sqrt", "exp",
    "log", "atan2", "maximum", "minimum", "__lt__", "__le__", "__gt__",
    "__ge__", "__eq__", "__ne__", "lt", "le", "gt", "ge", "eq", "ne",
    "isnan", "copysign", "__and__", "__or__", "__invert__"}


def _op_counter(n: int):
    import torch

    class _OpCount(torch.overrides.TorchFunctionMode):
        """Counts the counted operations whose result has n elements."""
        ops = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (getattr(func, "__name__", "") in _COUNTED
                    and isinstance(out, torch.Tensor) and out.numel() == n):
                type(self).ops += 1
            return out
    return _OpCount


def _count(fn, n: int) -> int:
    """The counted operations of fn() on n candidates (the plain version's
    square roots through torch.sqrt, which the mode sees)."""
    from unittest import mock
    from eigensolver_tpu_torch import cplx, profiles
    import torch
    counter = _op_counter(n)
    with mock.patch.object(cplx, "rsqrt", torch.sqrt), \
            mock.patch.object(profiles, "sqrt", torch.sqrt), counter():
        fn()
    return counter.ops


def complex_cylinder_ops() -> dict:
    """chip_smoke.py's OPS entries for the cylinder at complex omega
    ("cyl_cx_*": the density chain; "cyl_tw_cx_*": the twisted one; value
    pass and "dual_" pass), counted from physics/cylinder.py's plain
    versions (see `_COUNTED`)."""
    import dataclasses
    import torch
    from eigensolver_tpu_torch import cases, special
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.dual import Dual
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    n = 3
    om = C(torch.tensor([0.9, 1.3, 2.1], dtype=torch.float64),
           torch.tensor([0.05, -0.1, 0.2], dtype=torch.float64))
    k = torch.tensor([1.0, 1.5, 2.0], dtype=torch.float64)
    m = torch.tensor([0.0, 1.0, 1.0], dtype=torch.float64)

    def shoot(case, dual, **grid):
        case = dataclasses.replace(case, complex_omega=True,
                                   grid=dataclasses.replace(case.grid,
                                                            **grid))
        ph = CylinderPhysics.from_case(case)
        fn = (ph.make_dispersion_dual_plain if dual
              else ph.make_dispersion_plain)(m=None)
        return _count(lambda: fn(om, k, m), n)

    density = cases.cylinder_density_coronal(0.9)
    twist = cases.cylinder_twisted_photospheric(0.1, 1.0, 1)
    out = {}
    for dual, f in ((False, "cyl_cx_"), (True, "cyl_cx_dual_")):
        z = C(om.re * 0.7 + 1.0, om.im)
        z = Dual(z, C(torch.ones_like(k), torch.zeros_like(k))) if dual \
            else z
        series = _count(lambda: special._series_ratio_c(z), n)
        cf2 = _count(lambda: special._cf2_ratio_c(z), n)
        kve = _count(lambda: special.kve_ratio_both_c(z), n)
        out[f + "kve_series"], out[f + "kve_cf2"] = series, cf2
        out[f + "kve_ends"] = kve - series - cf2
        a = shoot(density, dual, n_interior=4, n_axis_log=2)
        b = shoot(density, dual, n_interior=8, n_axis_log=2)
        c = shoot(density, dual, n_interior=4, n_axis_log=4)
        out[f + "step"] = (b - a) // 4
        out[f + "log_step"] = (c - a) // 2
        ends = a - 4 * out[f + "step"] - 2 * out[f + "log_step"] - kve
        out[f + "ends"] = ends
        e4 = shoot(density, dual, n_interior=4, n_axis_log=2,
                   exterior_method="numeric", n_exterior=4)
        e8 = shoot(density, dual, n_interior=4, n_axis_log=2,
                   exterior_method="numeric", n_exterior=8)
        out[f + "ext_step"] = (e8 - e4) // 4
        out[f + "num_ends"] = (e4 - 4 * out[f + "step"]
                               - 2 * out[f + "log_step"]
                               - 4 * out[f + "ext_step"])
        t = "cyl_tw_cx_" + ("dual_" if dual else "")
        a = shoot(twist, dual, n_interior=4)
        b = shoot(twist, dual, n_interior=8)
        out[t + "step"] = (b - a) // 4
        out[t + "ends"] = a - 4 * out[t + "step"] - kve
    return out


def complex_cylinder_table_ops() -> dict:
    """chip_smoke.py's OPS entries for the complex-omega cylinder kernel's
    tables: one evaluation of the chain's (1/F, g) at an interior radius
    ("cyl_cx_chain", "cyl_tw_cx_chain"; on the Newton pass "*dual_chain"),
    counted as `complex_cylinder_ops` counts (see `_COUNTED`), and of it the
    values of (k, m, r) that do not depend on omega ("cyl_cx_row",
    "cyl_tw_cx_row"): the evaluation's count less its count with k and m
    0-d tensors (then those values are 0-d, counted none). A step's update
    is its "*step" less 3 chains; the log tail's chain its interior one and
    a third of the tail step's excess."""
    import dataclasses
    import torch
    from eigensolver_tpu_torch import cases
    from eigensolver_tpu_torch.cplx import C
    from eigensolver_tpu_torch.dual import Dual
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    n = 3
    om = C(torch.tensor([0.9, 1.3, 2.1], dtype=torch.float64),
           torch.tensor([0.05, -0.1, 0.2], dtype=torch.float64))
    k = torch.tensor([1.0, 1.5, 2.0], dtype=torch.float64)
    m = torch.tensor([0.0, 1.0, 1.0], dtype=torch.float64)
    r = torch.tensor(0.5, dtype=torch.float64)
    out = {}
    for f, case in (("cyl_cx_", cases.cylinder_density_coronal(0.9)),
                    ("cyl_tw_cx_",
                     cases.cylinder_twisted_photospheric(0.1, 1.0, 1))):
        ph = CylinderPhysics.from_case(
            dataclasses.replace(case, complex_omega=True))
        q = ph.twisted_point_fn()(r) if f == "cyl_tw_cx_" else None
        for dual in (False, True):
            w = (Dual(om, C(torch.ones_like(k), torch.zeros_like(k)))
                 if dual else om)

            def chain(kk, mm):
                if q is not None:
                    return lambda: ph.twisted_invF_g(
                        q, ph.twisted_chain(q, w, kk, mm))
                return lambda: ph.complex_invF_g(w, kk, mm)(r)
            full = _count(chain(k, m), n)
            out[f + ("dual_" if dual else "") + "chain"] = full
            out[f + "row"] = full - _count(chain(k[1].clone(),
                                                 m[1].clone()), n)
    return out


def _tally_deps(outs) -> dict:
    """Operations that outs need, by what each depends on (the sorted
    letters of its dependences)."""
    seen, stack, tally = set(), list(outs), {}
    while stack:
        n = stack.pop()
        if n.key is None or id(n) in seen:
            continue
        seen.add(id(n))
        stack.extend(n.args)
        if not n.free and n.deps:
            d = "".join(sorted(n.deps))
            tally[d] = tally.get(d, 0) + 1
    return tally


def main() -> int:
    sys.path.insert(0, str(ROOT))
    ext = exterior_ops()
    cx = {**complex_ops(), **complex_flux_ops(), **complex_flux_kernel_ops(),
          **complex_exterior_ops(),
          **complex_cylinder_ops(), **complex_cylinder_table_ops()}
    cyl = cylinder_ops()
    sl = slab_ops()
    print(json.dumps({"traced": {**traced_ops(False), **traced_ops(True),
                                 **ext, **cx, **cyl, **sl},
                      "ops": {**twisted_ops(False), **twisted_ops(True),
                              **ext, **cx, **cyl, **sl}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
