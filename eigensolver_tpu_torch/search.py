"""Batched root search over the (omega, k) plane, in PyTorch.

Port of the real-omega path of `eigensolver_tpu.search`:

1. ladder scan:  evaluate D(omega, k) on dense omega ladders for every
                 (k, band, mode) row at once (scan dtype);
2. bracketing:   sign changes in-array, a fixed budget of brackets per row,
                 chosen by smallest endpoint residual;
3. polish:       fixed-count bisection of every bracket at once (polish
                 dtype), then acceptance by the % residual.

PyTorch runs eagerly, so the JAX package's fused-pipeline cache, the
128-row padding (which bounded XLA recompiles) and the 1.2M-cell chunking
(which bounded TPU VMEM) have no counterpart here. The f64 re-bisection of
f32 roots (`refine_on_cpu` there, `refine_roots_f64` here) runs on the
sweep's own device. The continuum masks (the phase-speed ranges
`exclude_v_ranges`, the twisted family's row-local `exclude_omega_rowfn`)
and the pole pre-filter (`pole_det_factor`) sit between scan and
bracketing; the reference-parity fuzz acceptance (`fuzz_accept_pct`) adds
scan points to the polished roots.

The complex-omega search (Kelvin-Helmholtz growth rates, search.py:525-603)
is the damped Newton iteration of a seed batch (`newton_complex`: one fused
launch on the card, which can also evaluate the dispersion at its roots;
`newton_loop` over the plain dual shoot on the CPU) and the
argument-principle winding numbers of contours
(`count_roots_rectangle`, and `winding_numbers` of many contours' values
from one dispersion call).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .cplx import C, angle, cabs, divisor, is_zero, where
from .profiles import div


class BracketBatch(NamedTuple):
    lo: torch.Tensor        # (B,) lower omega of bracket
    hi: torch.Tensor        # (B,) upper omega
    k: torch.Tensor         # (B,) wavenumber of the cell
    mask: torch.Tensor      # (B,) bool - real bracket vs filler
    mode: Optional[torch.Tensor] = None  # (B,) mode id when fused sweeps
    n_in_row: Optional[torch.Tensor] = None  # (rows,) sign changes per row
    #   (before the top-K budget cut - saturation diagnostic)


class PolishResult(NamedTuple):
    omega: torch.Tensor     # (B,) converged root candidates
    k: torch.Tensor
    mismatch: torch.Tensor  # (B,) reference-style % residual at the root
    mask: torch.Tensor      # (B,) bracket validity / acceptance
    mode: Optional[torch.Tensor] = None
    # (B,) bool: entry is a reference-parity fuzz record (a scan point, kept
    # at its seed by the f64 refinement); None = all polished
    fuzz: Optional[torch.Tensor] = None


def _call_disp(disp_batch, omega, k, mode):
    return disp_batch(omega, k) if mode is None else disp_batch(omega, k, mode)


def ladder_scan(disp_batch: Callable, omegas: torch.Tensor, ks: torch.Tensor,
                modes: Optional[torch.Tensor] = None, paired: bool = False):
    """Evaluate the dispersion function on a (rows, n_omega) ladder grid.

    disp_batch: batched disp over flat (omega, k[, mode]) -> .det/.valid/...
    paired: the caller's word that the grid is one row set twice, its
    parity 0 rows then the same rows at parity 1 (modes 0 ... 0, 1 ... 1):
    the first half's candidates go through `disp_batch.both_parities`
    once, which gives both halves' results in the grid's order.
    Returns (det, valid, mismatch) as (rows, n_omega) tensors."""
    rows, n_omega = omegas.shape
    if paired:
        half = rows // 2
        res = disp_batch.both_parities(
            omegas[:half].reshape(-1), ks[:half].repeat_interleave(n_omega))
    else:
        flat_om = omegas.reshape(-1)
        flat_k = ks.repeat_interleave(n_omega)
        flat_m = None if modes is None else modes.repeat_interleave(n_omega)
        res = _call_disp(disp_batch, flat_om, flat_k, flat_m)
    det = res.det.reshape(rows, n_omega)
    valid = res.valid.reshape(rows, n_omega)
    mism = res.mismatch_pct.reshape(rows, n_omega)
    return det, valid, mism


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """The median of each row's non-NaN values, (rows, 1), as
    `jnp.nanmedian(x, axis=1, keepdims=True)` forms it: of an even count
    the mean of the two middle values, low 0.5 + high 0.5 in float64, then
    rounded to x's dtype (`torch.nanmedian` takes the lower of the two);
    NaN for a row without one. Sorts each row."""
    v = torch.sort(x, dim=1).values              # NaN sorts last
    count = (~torch.isnan(v)).sum(dim=1, keepdim=True)
    half = 0.5 * (count - 1).to(torch.float64)
    lo = half.floor().clamp(min=0).long()
    hi = half.ceil().clamp(min=0).long()
    w_hi = half - half.floor()
    med = (v.gather(1, lo).to(torch.float64) * (1.0 - w_hi)
           + v.gather(1, hi).to(torch.float64) * w_hi)
    return torch.where(count > 0, med, torch.nan).to(x.dtype)


def find_brackets(omegas: torch.Tensor, ks: torch.Tensor, det: torch.Tensor,
                  valid: torch.Tensor, max_per_row: int,
                  modes: Optional[torch.Tensor] = None,
                  pole_det_factor: Optional[float] = None,
                  mism: Optional[torch.Tensor] = None) -> BracketBatch:
    """Select up to `max_per_row` sign-change brackets per ladder row.

    pole_det_factor: when set, drop sign changes whose smaller endpoint
    |det| exceeds pole_det_factor x the row's median finite |det|
    (`nanmedian`; the product in det's dtype): at a pole crossing both
    endpoints are huge against the row, at a root one is small.

    mism: optional (rows, n_omega) residual %. When given, a saturated row
    keeps the `max_per_row` brackets with the smallest endpoint residual;
    otherwise the lowest-omega ones. Ties go to the lower index, as XLA's
    TopK breaks them in the JAX package (a stable sort here; `torch.topk`
    promises no order among ties). Rows with fewer brackets are filled with
    the lowest-index non-bracket columns, mask False.
    """
    finite = torch.isfinite(det)
    ok = valid & finite
    neg = torch.signbit(det)
    is_br = (neg[:, :-1] != neg[:, 1:]) & ok[:, :-1] & ok[:, 1:]
    if pole_det_factor is not None:
        absd = torch.abs(det)
        med = nanmedian(torch.where(ok, absd, torch.nan))
        lo_mag = torch.minimum(absd[:, :-1], absd[:, 1:])
        bound = torch.tensor(pole_det_factor, dtype=det.dtype,
                             device=det.device) * med
        is_br = is_br & (lo_mag <= bound)
    n_in_row = is_br.sum(dim=1)
    max_per_row = min(max_per_row, is_br.shape[1])
    if mism is not None:
        inf = torch.full((), torch.inf, dtype=mism.dtype, device=mism.device)
        big = torch.where(torch.isfinite(mism), mism, inf)
        score = torch.minimum(big[:, :-1], big[:, 1:])
        # genuine brackets clamp to a large FINITE score so one whose both
        # endpoint residuals are non-finite still outranks every non-bracket
        # column (which carries inf)
        cap = torch.full((), 1e30, dtype=mism.dtype, device=mism.device)
        score = torch.where(is_br, torch.minimum(score, cap), inf)
        key = score
    else:
        key = (~is_br).to(torch.int8)
    order = torch.sort(key, dim=1, stable=True).indices[:, :max_per_row]
    lo = omegas.gather(1, order)
    hi = omegas.gather(1, order + 1)
    mask = is_br.gather(1, order)
    kcol = ks[:, None].expand_as(lo)
    mcol = (None if modes is None
            else modes[:, None].expand_as(lo).reshape(-1))
    return BracketBatch(lo=lo.reshape(-1), hi=hi.reshape(-1),
                        k=kcol.reshape(-1), mask=mask.reshape(-1), mode=mcol,
                        n_in_row=n_in_row)


def bisect_loop(disp_batch: Callable, lo: torch.Tensor, hi: torch.Tensor,
                k: torch.Tensor, mode: Optional[torch.Tensor], n_iter: int,
                final_eval: bool = True, levels: int = 1):
    """Fixed-count sign bisection of every bracket as a loop of dispersion
    calls (the JAX package's fori_loop, search.py:152-167): f(lo), n_iter
    midpoints, root = 0.5 (lo + hi), and with final_eval one evaluation at
    the root for the % residual. Returns (root, mismatch or None). The
    fused kernels (`disp.bisect`) compute the same, bit for bit.

    levels > 1 takes `levels` levels a round, as the speculative fused
    kernel does (csrc/bisect.cuh::spec_kernel): one dispersion call on the
    2^d - 1 midpoints of the round's d levels (and f(lo) in the first),
    each formed from (lo, hi) as the loop forms it, then the walk down the
    tree with the loop's sign test; the residual at the root is one more
    level. The same midpoints, root and residual as levels=1, bit for
    bit."""
    if levels <= 1:
        f_lo = _call_disp(disp_batch, lo, k, mode).det
        lo_neg = torch.signbit(f_lo)
        for _ in range(n_iter):
            mid = 0.5 * (lo + hi)
            f_mid = _call_disp(disp_batch, mid, k, mode).det
            go_right = torch.signbit(f_mid) == lo_neg   # root in [mid, hi]
            lo = torch.where(go_right, mid, lo)
            hi = torch.where(go_right, hi, mid)
        root = 0.5 * (lo + hi)
        if not final_eval:
            return root, None
        return root, _call_disp(disp_batch, root, k, mode).mismatch_pct
    n_lv = n_iter + int(final_eval)
    cols = torch.arange(lo.numel(), device=lo.device)
    lo_neg, mism, done = None, None, 0
    while done < n_lv:
        d = min(levels, n_lv - done)
        # the round's tree in heap order: node n's children 2n, 2n + 1
        bounds, pts = {1: (lo, hi)}, []
        for node in range(1, 2 ** d):
            a, b = bounds.pop(node)
            mid = 0.5 * (a + b)
            pts.append(mid)
            bounds[2 * node], bounds[2 * node + 1] = (a, mid), (mid, b)
        if lo_neg is None and n_iter > 0:
            pts.append(lo)
        reps = len(pts)
        res = _call_disp(disp_batch, torch.cat(pts), k.repeat(reps),
                         None if mode is None else mode.repeat(reps))
        neg = torch.signbit(res.det).reshape(reps, -1)
        if lo_neg is None and n_iter > 0:
            lo_neg = neg[-1]
        node = torch.ones_like(cols)
        for t in range(d):
            if done + t < n_iter:
                go_right = neg[node - 1, cols] == lo_neg
                mid = 0.5 * (lo + hi)
                lo = torch.where(go_right, mid, lo)
                hi = torch.where(go_right, hi, mid)
                node = 2 * node + go_right.to(node.dtype)
            else:       # the residual at the root
                mism = res.mismatch_pct.reshape(reps, -1)[node - 1, cols]
        done += d
    return 0.5 * (lo + hi), mism


def bisect(disp_batch: Callable, br: BracketBatch, n_iter: int,
           dtype=torch.float64) -> PolishResult:
    """Fixed-count bisection of every bracket at once, then one evaluation
    at the midpoint for the residual, through the dispersion's own entry
    (`make_dispersion(...).bisect`: one fused launch on the card,
    `bisect_loop` on the CPU)."""
    lo = br.lo.to(dtype)
    hi = br.hi.to(dtype)
    k = br.k.to(dtype)
    md = br.mode
    root, mism = disp_batch.bisect(lo, hi, k, md, n_iter)
    return PolishResult(omega=root, k=k, mismatch=mism, mask=br.mask,
                        mode=md)


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Field for field `eigensolver_tpu.search.SearchConfig`, same defaults
    (see the comments there)."""
    n_omega: int = 256
    max_brackets_per_row: int = 8
    n_bisect: int = 60
    accept_pct: float = 1.0
    accept_pct_refined: Optional[float] = None   # with refine_f64
    scan_dtype: str = "float64"
    polish_dtype: str = "float64"
    # reference-parity acceptance: also record the scan points (every
    # fuzz_stride-th, |omega/k| inside fuzz_v_ranges) whose residual is
    # below fuzz_accept_pct (the local minima and each run's first)
    fuzz_accept_pct: Optional[float] = None
    fuzz_stride: int = 1
    fuzz_v_ranges: Optional[tuple] = None
    pole_det_factor: Optional[float] = None      # find_brackets
    # signed phase-speed ranges (lo, hi[, label]) masked for bracket
    # formation, typically `equilibrium.genuine_continua(case)`
    exclude_v_ranges: Optional[tuple] = None
    # row-local omega mask: fn(ks, ms) -> (lo, hi), (rows, n_bands) each,
    # typically `equilibrium.genuine_continua_rowfn(case)`; bracket
    # formation is masked for omega strictly inside any [lo_j, hi_j] of its
    # row. None = off.
    exclude_omega_rowfn: Optional[Callable] = None

    @classmethod
    def from_jax(cls, cfg) -> "SearchConfig":
        """The port's SearchConfig equal to a JAX-package SearchConfig.
        A row mask does not carry over: the JAX package's is a JAX function
        of one row; build the port's own."""
        if cfg.exclude_omega_rowfn is not None:
            raise TypeError(
                "SearchConfig.from_jax: exclude_omega_rowfn is a JAX "
                "function; set the port's own, eigensolver_tpu_torch."
                "equilibrium.genuine_continua_rowfn(case)")
        return cls(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cls)})


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


def mask_rows(omegas: torch.Tensor, ks: torch.Tensor,
              modes: Optional[torch.Tensor], det: torch.Tensor,
              rowfn: Callable) -> torch.Tensor:
    """det with NaN where omega lies strictly inside any of its row's
    ranges rowfn(ks, modes) (modes None: m = 1), so that no bracket forms
    there (eigensolver_tpu/search.py:268-273). The ranges and the test are
    in float64, as the JAX package forms them with x64 enabled."""
    f64 = torch.float64
    md = torch.ones_like(ks) if modes is None else modes
    lo, hi = rowfn(ks.to(f64), md.to(f64))
    om = omegas.to(f64)[:, :, None]
    in_band = ((om > lo[:, None, :]) & (om < hi[:, None, :])).any(dim=-1)
    return torch.where(in_band, torch.full_like(det, torch.nan), det)


def _bound(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python-float bound as the JAX code compares with it: weakly typed,
    so rounded to the dtype of the tensor it meets (f32 in an f32 scan)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def mask_v_ranges(omegas: torch.Tensor, ks: torch.Tensor, det: torch.Tensor,
                  ranges) -> torch.Tensor:
    """det with NaN where the phase speed omega/k lies strictly inside any
    (lo, hi[, ...]) of `ranges` (eigensolver_tpu/search.py:262-267): v and
    the comparison in the ladder's dtype, the bounds rounded to it."""
    v = omegas / ks[:, None]
    excl = torch.zeros(det.shape, dtype=torch.bool, device=det.device)
    for lo_v, hi_v, *_ in ranges:
        excl = excl | ((v > _bound(lo_v, v)) & (v < _bound(hi_v, v)))
    return torch.where(excl, torch.full_like(det, torch.nan), det)


def fuzz_records(omegas: torch.Tensor, ks: torch.Tensor,
                 modes: Optional[torch.Tensor], valid: torch.Tensor,
                 mism: torch.Tensor, cfg: SearchConfig) -> PolishResult:
    """The reference-parity acceptance of the scan itself
    (eigensolver_tpu/search.py:284-318): on every fuzz_stride-th ladder
    point, those whose residual is below fuzz_accept_pct and that are a
    local minimum of it or the first of a run under it, inside
    fuzz_v_ranges (|omega|/|k|, bounds inclusive) if given. Every
    comparison in the scan's dtype, the bounds rounded to it. One entry per
    strided point, mask the acceptance, fuzz True."""
    sub = slice(None, None, cfg.fuzz_stride)
    om_f, mism_f, valid_f = omegas[:, sub], mism[:, sub], valid[:, sub]
    fin = torch.isfinite(mism_f)
    acc = valid_f & fin & (mism_f < _bound(cfg.fuzz_accept_pct, mism_f))
    big = torch.where(fin, mism_f, torch.inf)
    inf_col = torch.full_like(big[:, :1], torch.inf)
    left = torch.cat([inf_col, big[:, :-1]], dim=1)
    right = torch.cat([big[:, 1:], inf_col], dim=1)
    acc_left = torch.cat([torch.zeros_like(acc[:, :1]), acc[:, :-1]], dim=1)
    keep = acc & ((big <= left) & (big <= right) | ~acc_left)
    if cfg.fuzz_v_ranges is not None:
        v = torch.abs(om_f) / torch.abs(ks)[:, None]
        in_rng = torch.zeros_like(keep)
        for lo_v, hi_v in cfg.fuzz_v_ranges:
            in_rng = in_rng | ((v >= _bound(lo_v, v)) & (v <= _bound(hi_v, v)))
        keep = keep & in_rng
    n_fuzz = om_f.shape[1]
    return PolishResult(
        omega=om_f.reshape(-1), k=ks.repeat_interleave(n_fuzz),
        mismatch=mism_f.reshape(-1), mask=keep.reshape(-1),
        mode=None if modes is None else modes.repeat_interleave(n_fuzz),
        fuzz=torch.ones(om_f.numel(), dtype=torch.bool, device=om_f.device))


def _concat(a: PolishResult, b: PolishResult) -> PolishResult:
    """a's entries then b's, each field in the wider of the two dtypes."""
    def cat(x, y):
        if x is None or y is None:
            return None
        dt = torch.promote_types(x.dtype, y.dtype)
        return torch.cat([x.to(dt), y.to(dt)])
    return PolishResult(*(cat(x, y) for x, y in zip(a, b)))


def search_rows(disp_batch_scan: Callable, disp_batch_polish: Callable,
                omegas: torch.Tensor, ks: torch.Tensor, cfg: SearchConfig,
                modes: Optional[torch.Tensor] = None,
                paired: bool = False) -> PolishResult:
    """Scan -> mask -> bracket -> bisect -> accept for one ladder batch.

    omegas: (rows, n_omega) ladders; ks: (rows,); modes: optional (rows,)
    mode column (fused sausage+kink sweep); paired: the rows are one row
    set at parity 0 then the same at parity 1, and the scan evaluates each
    (omega, k) once for both (`ladder_scan`). Returns a PolishResult of
    rows * max_brackets_per_row entries whose mask includes acceptance,
    then, with fuzz_accept_pct, one fuzz record per strided scan point
    (`fuzz_records`; `fuzz` marks them)."""
    det, valid, mism = ladder_scan(disp_batch_scan, omegas, ks, modes,
                                   paired)
    # the masks take det alone: valid and mism stay unmasked, as in the JAX
    # package, so the fuzz records see the whole scan
    if cfg.exclude_v_ranges:
        det = mask_v_ranges(omegas, ks, det, cfg.exclude_v_ranges)
    if cfg.exclude_omega_rowfn is not None:
        det = mask_rows(omegas, ks, modes, det, cfg.exclude_omega_rowfn)
    br = find_brackets(omegas, ks, det, valid, cfg.max_brackets_per_row,
                       modes, pole_det_factor=cfg.pole_det_factor, mism=mism)
    n_sat = int((br.n_in_row > cfg.max_brackets_per_row).sum())
    if n_sat:
        warnings.warn(
            f"{n_sat} ladder rows found more sign changes than "
            f"max_brackets_per_row={cfg.max_brackets_per_row}; only the "
            f"{cfg.max_brackets_per_row} smallest-residual brackets per row "
            f"were polished - raise max_brackets_per_row if dense bands "
            f"matter", stacklevel=2)
    pr = bisect(disp_batch_polish, br, cfg.n_bisect,
                dtype=torch_dtype(cfg.polish_dtype))
    accepted = (pr.mask & torch.isfinite(pr.mismatch)
                & (pr.mismatch < cfg.accept_pct))
    pr = pr._replace(mask=accepted)
    if cfg.fuzz_accept_pct is None:
        return pr
    return _concat(pr._replace(fuzz=torch.zeros_like(accepted)),
                   fuzz_records(omegas, ks, modes, valid, mism, cfg))


def collect(pr: PolishResult, with_fuzz: bool = False):
    """Device->host gather of accepted roots: (omega, k, mismatch[, mode]
    [, fuzz_flag]). All leaves travel in ONE stacked transfer."""
    leaves = [pr.omega, pr.k, pr.mismatch, pr.mask]
    if pr.mode is not None:
        leaves.append(pr.mode)
    if pr.fuzz is not None:
        leaves.append(pr.fuzz)
    dt = torch.promote_types(torch.promote_types(pr.omega.dtype, pr.k.dtype),
                             pr.mismatch.dtype)
    host = list(torch.stack([x.to(dt) for x in leaves]).cpu().numpy())
    om, kk, mm = host[0], host[1], host[2]
    mask = host[3].astype(bool)
    i = 4
    md = None
    if pr.mode is not None:
        md = host[i]
        i += 1
    fz = host[i].astype(bool) if pr.fuzz is not None else None
    out = (om[mask], kk[mask], mm[mask])
    if md is not None:
        out = out + (md[mask],)
    if with_fuzz:
        out = out + ((np.zeros(int(mask.sum()), bool) if fz is None
                      else fz[mask]),)
    return out


def refine_roots_f64(disp64: Callable, omega: torch.Tensor, k: torch.Tensor,
                     mode: Optional[torch.Tensor] = None, n_iter: int = 30,
                     rel_halfwidth: float = 4e-7):
    """Float64 re-bisection of converged roots, on the device of `omega`
    (port of `eigensolver_tpu.search.refine_on_cpu`, search.py:468-522).

    Each root is bracketed within +-rel_halfwidth relative, the window
    widened x8 per round for 4 rounds (to ~2e-3) where the f64 signs do not
    yet bracket, then bisected n_iter times. Returns (root, bracketed):
    an entry whose window never brackets keeps its input value and is
    marked False - it is not a zero of the f64 dispersion (f32 scan noise),
    and callers drop it. disp64: a batched float64 `make_dispersion`
    callable disp(omega, k[, mode]) with its `.bisect` entry.

    The 5 windows' 10 endpoints per root go through one dispersion call and
    each root takes the first window that brackets, which is what the 4
    rounds of widening give; then one bisection call (one fused launch on
    the card) without the final evaluation."""
    om = omega.to(torch.float64)
    kk = k.to(torch.float64)
    lo, hi, bad = refine_windows(disp64, om, kk, mode, rel_halfwidth)
    root, _ = disp64.bisect(lo, hi, kk, mode, n_iter, final_eval=False)
    return root, ~bad


def refine_window_ends(om: torch.Tensor, kk: torch.Tensor,
                       mode: Optional[torch.Tensor],
                       rel_halfwidth: float = 4e-7):
    """The windows om (1 -+ w), w = rel_halfwidth 8^j, j = 0..4, of each
    root, and their 10 endpoints per root as `refine_windows` evaluates them
    in one dispersion call: (los, his, (omega, k, mode))."""
    ws = [rel_halfwidth]
    for _ in range(4):
        ws.append(8.0 * ws[-1])
    los = torch.stack([om * (1.0 - w) for w in ws])
    his = torch.stack([om * (1.0 + w) for w in ws])
    n_w = len(ws)
    md = None if mode is None else mode.repeat(2 * n_w)
    return los, his, (torch.cat([los, his]).reshape(-1), kk.repeat(2 * n_w),
                      md)


def refine_windows(disp64: Callable, om: torch.Tensor, kk: torch.Tensor,
                   mode: Optional[torch.Tensor], rel_halfwidth: float = 4e-7):
    """The first of the windows om (1 -+ w), w = rel_halfwidth 8^j, j = 0..4,
    whose float64 signs bracket, from one dispersion call on all 10
    endpoints: (lo, hi, bad); a root with none is bad, lo = hi = om."""
    los, his, ends = refine_window_ends(om, kk, mode, rel_halfwidth)
    neg = torch.signbit(_call_disp(disp64, *ends).det)
    neg = neg.reshape(2, los.shape[0], -1)
    brackets = neg[0] != neg[1]                       # (window, root)
    bad = ~brackets.any(dim=0)
    first = brackets.to(torch.int8).argmax(dim=0, keepdim=True)
    lo = torch.where(bad, om, los.gather(0, first)[0])
    hi = torch.where(bad, om, his.gather(0, first)[0])
    return lo, hi, bad


# ---------------------------------------------------------------------------
# Complex-omega search (Kelvin-Helmholtz growth rates)
# ---------------------------------------------------------------------------

class ComplexSearchResult(NamedTuple):
    omega: C               # complex roots
    k: torch.Tensor
    resid: torch.Tensor    # |D| at the root (normalised)
    mask: torch.Tensor


def newton_step(om: C, d: C, dd: C, damping: float = 1.0) -> C:
    """One damped Newton step from D = d and dD/domega = dd
    (search.py:595-601): step = d / dd (0 where dd == 0), clamped to
    0.2 (1 + |omega|) in modulus; omega - damping step. The Newton kernel
    (csrc/slab_complex.cu) repeats these operations in this order."""
    q = d / dd
    nil = torch.zeros_like(q.re)
    step = where(is_zero(dd), C(nil, nil), q)
    max_step = 0.2 * (1.0 + cabs(om))
    mag = cabs(step)
    step = where(mag > max_step, step * (max_step / mag), step)
    return om - damping * step


def newton_loop(dual_batch: Callable, omega0: C, k: torch.Tensor,
                mode: Optional[torch.Tensor], n_iter: int,
                damping: float = 1.0) -> C:
    """The plain version of the fused Newton kernel: n_iter steps, each one
    call of the dual dispersion dual_batch(omega, k[, mode]) -> (D,
    dD/domega) and `newton_step`."""
    om = omega0
    for _ in range(n_iter):
        d, dd = _call_disp(dual_batch, om, k, mode)
        om = newton_step(om, d, dd, damping)
    return om


def newton_complex(disp_batch: Callable, omega0, k: torch.Tensor,
                   n_iter: int = 20, damping: float = 1.0,
                   mode: Optional[torch.Tensor] = None,
                   final_eval: bool = False):
    """Batched damped Newton iteration in complex omega on the holomorphic
    dispersion determinant (search.py:581-603), through the dispersion's
    own entry `disp_batch.newton`: one `slab_newton` launch on CUDA
    tensors, `newton_loop` over the plain dual shoot on CPU tensors.
    omega0: a `cplx.C` or a complex tensor; returns a `cplx.C`, with
    final_eval (omega, disp_batch(omega, k[, mode])), the evaluation in the
    same launch on the card."""
    return disp_batch.newton(omega0, k, mode, n_iter, damping, final_eval)


def winding_numbers(det: C) -> torch.Tensor:
    """Winding numbers of closed polylines from the determinant's values
    along them, det of shape (..., n_points): the sum of the phase
    increments angle(det[i + 1] / det[i]) over 2 pi (search.py:536-546)."""
    nxt = C(torch.roll(det.re, -1, dims=-1), torch.roll(det.im, -1, dims=-1))
    dphase = angle(nxt / divisor(det))
    return div(dphase.sum(dim=-1), 2.0 * np.pi)


def _path_tensors(path, device, dtype=torch.float64):
    z = np.asarray(path)
    return C(torch.from_numpy(np.ascontiguousarray(z.real)).to(device, dtype),
             torch.from_numpy(np.ascontiguousarray(z.imag)).to(device, dtype))


def winding_number(disp_batch: Callable, k, path, mode=None, *, device):
    """Winding number of the dispersion determinant along the closed
    polyline `path` (a complex numpy array) in the complex omega plane:
    zeros minus poles enclosed, by the argument principle (phase-increment
    quadrature), with one dispersion call on `device`."""
    z = _path_tensors(path, device)
    kk = torch.full_like(z.re, float(k))
    md = None if mode is None else torch.full_like(z.re, float(mode))
    return float(winding_numbers(_call_disp(disp_batch, z, kk, md).det))


def count_roots_argument_principle(disp_batch: Callable, k, center, radius,
                                   n_points: int = 512, mode=None, *,
                                   device):
    """Zeros minus poles inside a circle of the complex omega plane
    (search.py:549-558)."""
    th = np.linspace(0.0, 2.0 * np.pi, n_points, endpoint=False)
    z = center + radius * np.exp(1j * th)
    return winding_number(disp_batch, k, z, mode=mode, device=device)


def rectangle_path(re_lo, re_hi, im_lo, im_hi, n_per_side: int = 128):
    """The rectangle's closed polyline, n_per_side points a side from each
    corner, counter-clockwise from (re_lo, im_lo) (search.py:570-577), a
    complex128 numpy array."""
    t = np.linspace(0.0, 1.0, n_per_side, endpoint=False)
    c = [complex(re_lo, im_lo), complex(re_hi, im_lo),
         complex(re_hi, im_hi), complex(re_lo, im_hi)]
    return np.concatenate([c[i] + (c[(i + 1) % 4] - c[i]) * t
                           for i in range(4)])


def count_roots_rectangle(disp_batch: Callable, k, re_lo, re_hi, im_lo,
                          im_hi, n_per_side: int = 128, mode=None, *,
                          device):
    """Zeros minus poles inside a rectangle of the complex omega plane
    (search.py:561-578); the completeness audit lifts it off the real axis,
    where the determinant's continuum poles lie."""
    return winding_number(disp_batch, k, rectangle_path(
        re_lo, re_hi, im_lo, im_hi, n_per_side), mode=mode, device=device)
