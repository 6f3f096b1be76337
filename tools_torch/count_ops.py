"""Count the operations of the twisted cylinder chain that chip_smoke.py's
bound uses (its OPS entries "cyl_tw_*").

    python tools_torch/count_ops.py

Traces `physics/cylinder.py::CylinderPhysics.twisted_chain` (the order of
operations that csrc/cylinder_disp.cu::twisted_chain follows) on symbols
instead of tensors and counts each operation the outputs need once:

- an operation repeated on the same operands is one (a dual square's two
  cross products, k B_z in the Alfven term and in f B);
- a negation is free (an operand modifier on the card), and so is a
  product or a quotient by an exact 1 (the radius' unit tangent dr/dr,
  and r itself at r = 1);
- an exact 0 propagates: with B_phi = 0 the terms in B_phi vanish;
- by what each result depends on: the radius alone (once per abscissa and
  launch: the table's job), the candidate alone (once per candidate), both
  (per candidate and abscissa), neither (a constant of the launch, 0).

Per RK4 step, 3 evaluations of the chain with (1/F, g) (physics/cylinder.py
`_twisted_coefficients`), per evaluation the chain's values at r = 1 and
F(1), C1(1)/C3(1). The parts that the trace does not cover are counted by
hand from csrc/cylinder_disp.cu below.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# counted by hand from csrc/cylinder_disp.cu
RK4_UPDATE = 68      # rk4_step2: 4 x 4 slopes, 3 x 8 midpoints, 4 x 7 sums
FINISH = 35          # finish() without the K_m ratio and k k (the chain's)
R_POINT = 84         # r_point_tw per abscissa, sqrt(rho) and rho v^2 aside
LAUNCH_CONSTANTS = 2  # sqrt(rho), rho v_twist^2
J_TERM = 8           # J = B_phi(1)^2 - rho v_phi(1)^2
ABSCISSAE = 4        # x0 + i h, + h/2, + h


class Sym:
    """A value of the trace: what it depends on ("r", "c"), the operation
    and operands that formed it, or a known constant."""

    nodes: dict = {}

    def __init__(self, deps=frozenset(), val=None, key=None, args=(),
                 free=False):
        self.deps, self.val, self.key, self.args, self.free = (
            frozenset(deps), val, key, args, free)

    @staticmethod
    def of(x) -> "Sym":
        return x if isinstance(x, Sym) else Sym(val=float(x))

    def _op(self, op: str, other, swap: bool = False):
        from eigensolver_tpu_torch.dual import Dual
        if isinstance(other, Dual):
            return NotImplemented
        a, b = (Sym.of(other), self) if swap else (self, Sym.of(other))
        if op == "*":
            if 0.0 in (a.val, b.val):
                return ZERO
            if a.val == 1.0:
                return b
            if b.val == 1.0:
                return a
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
    """A TwistedPoint of symbols at radius r: rho and sqrt(rho) constants;
    B_phi = 0 and B_z = B_0 exactly when b_phi_zero."""
    from eigensolver_tpu_torch.dual import Dual
    from eigensolver_tpu_torch.physics.cylinder import TwistedPoint

    def radial():
        return Dual(Sym({"r"}), Sym({"r"}))
    return TwistedPoint(
        r=r, rho=Sym(), sqrt_rho=Sym(), v=radial(),
        b=Dual(ZERO, ZERO) if b_phi_zero else radial(),
        Bz=Dual(Sym(), ZERO) if b_phi_zero else radial(),
        ci=radial(), csum=radial(), sqrt_csum=radial(), U=radial(),
        rdc=radial())


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
    ("cyl_tw_b0_*") or every term live ("cyl_tw_*")."""
    import torch
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    chain = CylinderPhysics.twisted_chain
    Sym.nodes = {}
    om, k, m = Sym({"c"}), Sym({"c"}), Sym({"c"})
    ones_like = torch.ones_like
    torch.ones_like = lambda x: ONE         # the unit tangent of R
    try:
        r = Sym({"r"})
        c = chain(_point(r, b_phi_zero), om, k, m)
        iF = c.A.v / r + c.B.v / (r * c.D.v)
        g = -c.rc.d - r * (c.C2 - c.C1.v * c.C1.v / c.C3.v) / c.D.v
        step = _tally([iF, g])
        c1 = chain(_point(ONE, b_phi_zero), om, k, m)
        ends = _tally([ONE * c1.D.v / c1.C3.v, c1.C1.v * ONE / c1.C3.v])
        per_cand = _tally([iF, g, c1.D.v, c1.C1.v, c1.C3.v])["c"]
    finally:
        torch.ones_like = ones_like
    f = "cyl_tw_b0_" if b_phi_zero else "cyl_tw_"
    out = {f + "step": 3 * step["cr"] + RK4_UPDATE,
           f + "ends": ends["cr"] + per_cand + FINISH}
    if not b_phi_zero:     # the r-only part: counted with every term live
        out["cyl_tw_r_step"] = 3 * (R_POINT + step["r"]) + ABSCISSAE
        out["cyl_tw_launch"] = (LAUNCH_CONSTANTS + R_POINT + ends["r"]
                                + J_TERM)
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    print(json.dumps({**twisted_ops(False), **twisted_ops(True)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
