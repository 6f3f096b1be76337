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
sweep's own device. The row-local continuum mask of the twisted family
(`exclude_omega_rowfn`) sits between scan and bracketing. Not ported yet:
the reference-parity fuzz acceptance, the phase-speed continuum masks and
the pole pre-filter (ROADMAP A11), the complex-omega search (A10).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


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
    # (B,) bool: entry is a reference-parity fuzz record; None = all polished
    # (always, until fuzz acceptance is ported: ROADMAP A11)
    fuzz: Optional[torch.Tensor] = None


def _call_disp(disp_batch, omega, k, mode):
    return disp_batch(omega, k) if mode is None else disp_batch(omega, k, mode)


def ladder_scan(disp_batch: Callable, omegas: torch.Tensor, ks: torch.Tensor,
                modes: Optional[torch.Tensor] = None):
    """Evaluate the dispersion function on a (rows, n_omega) ladder grid.

    disp_batch: batched disp over flat (omega, k[, mode]) -> .det/.valid/...
    Returns (det, valid, mismatch) as (rows, n_omega) tensors."""
    rows, n_omega = omegas.shape
    flat_om = omegas.reshape(-1)
    flat_k = ks.repeat_interleave(n_omega)
    flat_m = None if modes is None else modes.repeat_interleave(n_omega)
    res = _call_disp(disp_batch, flat_om, flat_k, flat_m)
    det = res.det.reshape(rows, n_omega)
    valid = res.valid.reshape(rows, n_omega)
    mism = res.mismatch_pct.reshape(rows, n_omega)
    return det, valid, mism


def find_brackets(omegas: torch.Tensor, ks: torch.Tensor, det: torch.Tensor,
                  valid: torch.Tensor, max_per_row: int,
                  modes: Optional[torch.Tensor] = None,
                  pole_det_factor: Optional[float] = None,
                  mism: Optional[torch.Tensor] = None) -> BracketBatch:
    """Select up to `max_per_row` sign-change brackets per ladder row.

    mism: optional (rows, n_omega) residual %. When given, a saturated row
    keeps the `max_per_row` brackets with the smallest endpoint residual;
    otherwise the lowest-omega ones. Ties go to the lower index, as XLA's
    TopK breaks them in the JAX package (a stable sort here; `torch.topk`
    promises no order among ties). Rows with fewer brackets are filled with
    the lowest-index non-bracket columns, mask False.
    """
    if pole_det_factor is not None:
        raise NotImplementedError("pole_det_factor: ROADMAP A11")
    finite = torch.isfinite(det)
    ok = valid & finite
    neg = torch.signbit(det)
    is_br = (neg[:, :-1] != neg[:, 1:]) & ok[:, :-1] & ok[:, 1:]
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
                final_eval: bool = True):
    """Fixed-count sign bisection of every bracket as a loop of dispersion
    calls (the JAX package's fori_loop, search.py:152-167): f(lo), n_iter
    midpoints, root = 0.5 (lo + hi), and with final_eval one evaluation at
    the root for the % residual. Returns (root, mismatch or None). The
    fused kernels (`disp.bisect`) compute the same, bit for bit."""
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
    (see the comments there). The fields marked below are not ported yet
    and raise when set."""
    n_omega: int = 256
    max_brackets_per_row: int = 8
    n_bisect: int = 60
    accept_pct: float = 1.0
    accept_pct_refined: Optional[float] = None   # with refine_f64
    scan_dtype: str = "float64"
    polish_dtype: str = "float64"
    fuzz_accept_pct: Optional[float] = None      # A11
    fuzz_stride: int = 1
    fuzz_v_ranges: Optional[tuple] = None
    pole_det_factor: Optional[float] = None      # A11
    exclude_v_ranges: Optional[tuple] = None     # A11
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


def _check_supported(cfg: SearchConfig):
    for name in ("fuzz_accept_pct", "pole_det_factor", "exclude_v_ranges"):
        if getattr(cfg, name) is not None:
            raise NotImplementedError(f"SearchConfig.{name}: ROADMAP A11")


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


def search_rows(disp_batch_scan: Callable, disp_batch_polish: Callable,
                omegas: torch.Tensor, ks: torch.Tensor, cfg: SearchConfig,
                modes: Optional[torch.Tensor] = None) -> PolishResult:
    """Scan -> bracket -> bisect -> accept for one ladder batch.

    omegas: (rows, n_omega) ladders; ks: (rows,); modes: optional (rows,)
    mode column (fused sausage+kink sweep). Returns a PolishResult of
    rows * max_brackets_per_row entries whose mask includes acceptance."""
    _check_supported(cfg)
    det, valid, mism = ladder_scan(disp_batch_scan, omegas, ks, modes)
    if cfg.exclude_omega_rowfn is not None:
        # valid and mism stay unmasked, as in the JAX package
        det = mask_rows(omegas, ks, modes, det, cfg.exclude_omega_rowfn)
    br = find_brackets(omegas, ks, det, valid, cfg.max_brackets_per_row,
                       modes, mism=mism)
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
    return pr._replace(mask=accepted)


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
