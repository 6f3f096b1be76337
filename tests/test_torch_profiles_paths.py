"""The profile paths that no shipped case takes (tools_torch/
profiles_cases.py): power-law density and flow profiles, and twist
profiles other than power laws, through the port against the JAX package
on the CPU in float64.

- `kernels.slab.disp_params` and `kernels.cylinder.disp_params` take every
  `ProfileKind` for each profile field of their geometry, and hand the
  kernels the kind and the constants that `profiles.make_profile` and
  `make_profile_derivative` use;
- the six configurations' sweeps (`run_case`, n_interior 256,
  n_axis_log 32, SearchConfig(n_omega=64, n_bisect=12), float64; n_k 6
  for the slabs and the flow cylinder, 3 for the density cylinder, 2 for
  the twisted tubes) against the JAX package's: counts per branch equal,
  roots to rtol 1e-9 (the port's closed-form profile derivatives agree
  with jax.grad to rounding, not bit for bit); the degenerate power-law
  slab density finds no root in either package, and its determinants are
  non-finite, as JAX's are;
- `run_case_complex` of pl_slab_flow and pl_cyl_density (kink) at a
  reduced size (n_k 2, 4 x 3 seeds, 10 Newton steps, n_interior 64)
  against the JAX package's Newton iteration of the same seeds, per
  seed: the seeds converged in both runs (`kh.seed_verdicts`) accepted
  alike, their roots to rtol 1e-9, the counts equal;
- on the card (`gpu`): each configuration's scan bit-equal to its plain
  version (chip_smoke.py phase 26 holds every kernel variant at full
  width).

The JAX package's reduced sweeps run in processes of their own, all
started at once by a module fixture, while the port's run here.

`python tests/test_torch_profiles_paths.py jax-counts NAME DTYPE [--ieee]`
and `... jax-complex NAME` take the full-size JAX targets that
`chip_smoke.py` holds (profiles_cases.TARGETS, COMPLEX_TARGETS); `...
port-counts NAME DTYPE` the port's own sweep on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools_torch import kh, profiles_cases  # noqa: E402

MODE_NAMES = {0: "sausage", 1: "kink"}
IEEE_XLA_FLAGS = "--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp"
REDUCED = dict(n_interior=256, n_axis_log=32)
# k per reduced sweep: the slabs and the flow cylinder 6, the density
# cylinder 3, the twisted tubes 2 (their CPU sweeps are the file's
# longest)
N_K = {"pl_slab_flow": 6, "pl_slab_density": 6, "pl_cyl_flow": 6,
       "pl_cyl_density": 3, "tw_gauss": 2, "tw_epstein_b": 2}
SEARCH = dict(n_omega=64, n_bisect=12)
ROOT_RTOL = 1e-9


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's reduced sweeps (`jax-reduced NAME`, and
    `jax-reduced-complex NAME` of the COMPLEX configurations), each in a
    process of its own, all started at once (each compiles its own
    dispersion, ~30-60 s on a CPU): get(key) waits for one and returns its
    JSON line."""
    env = {**{k: v for k, v in os.environ.items() if k != "XLA_FLAGS"},
           "JAX_PLATFORMS": "cpu"}
    jobs = [("jax-reduced", n) for n in profiles_cases.CONFIGS]
    jobs += [("jax-reduced-complex", n) for n in profiles_cases.COMPLEX]
    procs = {job: subprocess.Popen([sys.executable, __file__, *job],
                                   env=env, cwd=ROOT, text=True,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE)
             for job in jobs}

    def get(cmd, name):
        out, err = procs[cmd, name].communicate(timeout=900)
        if procs[cmd, name].returncode:
            raise RuntimeError(f"{cmd} {name} failed:\n{out}\n{err}")
        return json.loads(out.strip().splitlines()[-1])
    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _cases(name, **grid):
    """(JAX case, port case) of a configuration at the reduced size."""
    import dataclasses
    _jax()
    from eigensolver_tpu import cases as jcases
    from eigensolver_tpu import config as jconfig
    from eigensolver_tpu_torch import config
    jcase = profiles_cases.configure(name, jcases, jconfig,
                                     **{**REDUCED, **grid})
    jcase = dataclasses.replace(jcase, n_k=N_K[name])
    return jcase, config.from_jax(jcase)


# -- disp_params: every kind for every field --------------------------------

KINDS = ("UNIFORM", "GAUSSIAN", "EPSTEIN", "POWER_LAW")
FIELDS = {"slab": ("density_profile", "flow_profile"),
          "cylinder": ("density_profile", "flow_profile", "twist_profile",
                       "b_twist_profile")}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("geometry, field", [
    (g, f) for g, fs in FIELDS.items() for f in fs])
def test_disp_params_take_every_kind(geometry, field, kind):
    """The kernels' parameters of a case whose `field` is of `kind`: the
    kind's id, and the constants of the closed forms as
    profiles.derivative_coefs forms them (f0, fe of the field: the
    regime's, or 0 and 0 for the twist profiles)."""
    import dataclasses
    from eigensolver_tpu_torch import cases, config
    from eigensolver_tpu_torch.kernels import common, cylinder, slab
    from eigensolver_tpu_torch.profiles import derivative_coefs
    base = {"slab": cases.slab_density_photospheric(0.9),
            "cylinder": cases.cylinder_twisted_magnetic()}[geometry]
    if geometry == "cylinder" and field in ("density_profile",
                                            "flow_profile"):
        base = cases.cylinder_density_coronal(0.9)
    prof = config.ProfileConfig(kind=getattr(config.ProfileKind, kind),
                                width=0.5, center=0.1, amplitude=0.7,
                                power=-1.5)
    case = dataclasses.replace(base, **{field: prof})
    struct = (slab if geometry == "slab" else cylinder).disp_params(
        case).struct
    rg = case.regime
    f0, fe = {"density_profile": (rg.rho_i0, rg.rho_e),
              "flow_profile": (rg.U_i0, rg.U_e)}.get(field, (0.0, 0.0))
    got = getattr(struct, {"density_profile": "rho", "flow_profile": "flow",
                           "twist_profile": "vphi",
                           "b_twist_profile": "bphi"}[field])
    assert got.kind == common.KIND_ID[prof.kind]
    d1, d2, d2_shift = derivative_coefs(prof, f0, fe)
    assert (got.f0, got.fe, got.d1, got.d2, got.d2_shift) == (
        f0, fe, d1, d2, d2_shift)
    assert (got.amplitude, got.power, got.power_m1, got.power_m2) == (
        0.7, -1.5, -2.5, -3.5)
    if field == "twist_profile":
        # the pressure balance takes the twist's amplitude and power
        # whatever its kind, as the JAX package's P_i does
        assert (struct.amp2, struct.pw2) == (0.7 ** 2, -3.0)


# -- the reduced sweeps against the JAX package -------------------------

def _physics(case):
    from eigensolver_tpu_torch.config import Geometry
    from eigensolver_tpu_torch.physics.cylinder import CylinderPhysics
    from eigensolver_tpu_torch.physics.slab import SlabPhysics
    return (SlabPhysics if case.geometry == Geometry.SLAB
            else CylinderPhysics).from_case(case)


def _ladder_draws(case, n: int, seed: int):
    """n (omega, k, mode) candidates drawn from the case's ladders (numpy
    float64), the modes the case sweeps."""
    from eigensolver_tpu_torch import sweep
    om, ks = sweep.build_ladders(case, SEARCH["n_omega"])
    rng = np.random.default_rng(seed)
    row = rng.integers(0, om.shape[0], n)
    col = rng.integers(0, om.shape[1], n)
    mode = rng.choice(np.asarray(case.modes, np.float64), n)
    return om[row, col], ks[row], mode


@pytest.mark.parametrize("name", sorted(profiles_cases.CONFIGS))
def test_reduced_sweep_equals_jax(name, jax_runs):
    """run_case on the CPU gives the JAX package's counts per branch and
    its roots to ROOT_RTOL."""
    from eigensolver_tpu_torch import search, sweep
    _, case = _cases(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # saturated-row notices
        got, _ = sweep.run_case(case, search.SearchConfig(**SEARCH),
                                device="cpu")
    want = jax_runs("jax-reduced", name)
    assert got.counts() == want["counts"]
    if name == "pl_slab_density":
        assert sum(got.counts().values()) == 0      # rho(0) = 0
    else:
        assert sum(got.counts().values()) >= 5
    for b, (ks, omegas) in want["roots"].items():
        np.testing.assert_array_equal(got[b].ks, ks)
        np.testing.assert_allclose(got[b].omegas, omegas, rtol=ROOT_RTOL)


def test_power_law_slab_density_is_non_finite_as_jax():
    """The degenerate configuration (rho(0) = 0 at the slab's centre): on
    its ladder draws the plain dispersion's det is non-finite everywhere,
    as the JAX package's is, and valid equal."""
    jax = _jax()
    import jax.numpy as jnp
    from eigensolver_tpu import sweep as jsweep
    jcase, case = _cases("pl_slab_density")
    om, k, mode = _ladder_draws(case, 256, seed=3)
    jres = jax.jit(jsweep.make_dispersion_moded(jcase, jnp.float64))(
        jnp.asarray(om), jnp.asarray(k), jnp.asarray(mode))
    pres = _physics(case).make_dispersion_plain(None, torch.float64)(
        *(torch.from_numpy(a) for a in (om, k, mode)))
    assert not np.isfinite(np.asarray(jres.det)).any()
    assert not np.isfinite(pres.det.numpy()).any()
    np.testing.assert_array_equal(pres.valid.numpy(), np.asarray(jres.valid))


COMPLEX_KW = dict(n_re=4, n_im=3, newton_iters=10)


def _complex_cases(name):
    """(JAX case, port case, run_case_complex's keywords) of a COMPLEX
    configuration at the reduced size: n_k 2, n_interior 64, n_axis_log
    16, 4 x 3 seeds, 10 Newton steps; the cylinder's kink only (the JAX
    package compiles each mode's complex dispersion, the K_m ratio at
    complex z inside, apart)."""
    import dataclasses
    _jax()
    from eigensolver_tpu import cases as jcases
    from eigensolver_tpu import config as jconfig
    from eigensolver_tpu_torch import config
    jcase, _ = profiles_cases.complex_case(name, jcases, jconfig, k_stride=1,
                                           n_interior=64, n_axis_log=16)
    jcase = dataclasses.replace(jcase, n_k=2)
    if jcase.geometry.value == "cylinder":
        jcase = dataclasses.replace(jcase, modes=(1,))
    return jcase, config.from_jax(jcase), dict(COMPLEX_KW)


@pytest.mark.parametrize("name", sorted(profiles_cases.COMPLEX))
def test_reduced_complex_sweep_equals_jax_per_seed(name, jax_runs):
    """run_case_complex on the CPU against the JAX package's Newton
    iteration of the same seeds (_complex_cases): the counts equal the
    roots of the JAX package's accepted seeds; per seed (the Newton pass
    again, and one step further: kh.seed_verdicts), every seed converged
    in both runs accepted alike, with its omega to rtol 1e-9. (The audit
    is held at full size on the card: chip_smoke.py phase 26.)"""
    from eigensolver_tpu_torch import search, sweep
    from eigensolver_tpu_torch.cplx import C
    _, case, kw = _complex_cases(name)
    rs, _ = sweep.run_case_complex(case, **kw, device="cpu")
    want = jax_runs("jax-reduced-complex", name)
    assert rs.counts() == want["counts"] and sum(rs.counts().values()) > 0
    om0, k0 = sweep.complex_seeds(case, kw["n_re"], kw["n_im"])
    kk = torch.from_numpy(k0)

    def np_c(z):
        return z.re.numpy() + 1j * z.im.numpy()

    for mode in case.modes:
        d = sweep.make_dispersion(case, mode, torch.float64)
        seeds = C(torch.from_numpy(om0.real.copy()),
                  torch.from_numpy(om0.imag.copy()))
        om, res = search.newton_complex(d, seeds, kk,
                                        n_iter=kw["newton_iters"],
                                        final_eval=True)
        nxt = search.newton_complex(d, om, kk, n_iter=1)
        om = np_c(om)
        acc, conv = kh.seed_verdicts(case, om, np_c(nxt),
                                     res.mismatch_pct.numpy(),
                                     res.valid.numpy(), k0)
        w = want["seeds"][MODE_NAMES[mode]]
        jom = np.asarray(w["re"]) + 1j * np.asarray(w["im"])
        both = conv & np.asarray(w["converged"])
        assert both.sum() >= 20
        np.testing.assert_array_equal(acc[both],
                                      np.asarray(w["accepted"])[both])
        np.testing.assert_allclose(om[both], jom[both], rtol=1e-9)


# -- on the card: each kernel against its plain version ---------------------

@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(profiles_cases.CONFIGS))
def test_scan_bit_equal_to_plain_on_card(name, dtype):
    """The configuration's scan kernel (make_dispersion on CUDA tensors)
    bit-equal to its plain version on the same card at the reduced size,
    non-finite values where the plain version's are; 2,048 ladder draws
    (and the twisted tubes' small-batch path on 256 of them)."""
    from eigensolver_tpu_torch import config
    from eigensolver_tpu_torch.kernels import cylinder as kcyl
    from eigensolver_tpu_torch.kernels import slab as kslab
    from eigensolver_tpu_torch import cases as tcases
    case = profiles_cases.configure(name, tcases, config, **REDUCED)
    ph = _physics(case)
    om, k, mode = _ladder_draws(case, 2048, seed=7)
    for n in (2048, 256):
        args = [torch.from_numpy(a[:n]).to("cuda", dtype)
                for a in (om, k, mode)]
        before = kslab.launches + kcyl.launches
        kres = ph.make_dispersion(None, dtype)(*args)
        torch.cuda.synchronize()
        assert kslab.launches + kcyl.launches == before + 1
        pres = ph.make_dispersion_plain(None, dtype)(*args)
        for f in ("det", "mismatch_pct", "valid"):
            a, b = getattr(kres, f), getattr(pres, f)
            same = (a == b) | (a.isnan() & b.isnan())
            assert bool(same.all()), (f, int((~same).sum()))


# -- the JAX package's full-size targets -----------------------------------

def jax_counts(name: str, dtype: str) -> dict:
    """The configuration's full sweep through the JAX package on the CPU:
    its counts per branch and wall."""
    jax = _jax()
    from eigensolver_tpu import cases, config, search
    from eigensolver_tpu.sweep import run_case
    case = profiles_cases.configure(name, cases, config)
    cfg = profiles_cases.search_config(search.SearchConfig, dtype)
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # saturated-row notices
        rs, st = run_case(case, cfg)
    return {"target": name, "dtype": dtype, "counts": rs.counts(),
            "candidates": st.n_candidates,
            "xla_flags": os.environ.get("XLA_FLAGS"),
            "wall_s": time.perf_counter() - t, "jax": jax.__version__}


def port_counts(name: str, dtype: str) -> dict:
    """The configuration's full sweep through the port on the CPU (its
    plain versions): counts per branch and wall."""
    from eigensolver_tpu_torch import cases, config, search, sweep
    case = profiles_cases.configure(name, cases, config)
    cfg = profiles_cases.search_config(search.SearchConfig, dtype)
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # saturated-row notices
        rs, st = sweep.run_case(case, cfg, device="cpu")
    return {"target": name, "dtype": dtype, "counts": rs.counts(),
            "candidates": st.n_candidates, "torch": torch.__version__,
            "wall_s": time.perf_counter() - t}


def jax_complex(name: str) -> dict:
    """The configuration's complex sweep through the JAX package on the CPU
    on every k_stride-th k, and its seeds' verdicts per mode (the Newton
    pass again, one step further), as tools_torch/cx_cyl.py's targets."""
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np
    from eigensolver_tpu import cases, config
    from eigensolver_tpu.roots import dedup_complex_roots as jdedup
    from eigensolver_tpu.search import newton_complex as jnewton
    from eigensolver_tpu.sweep import make_dispersion_jitted, run_case_complex
    from eigensolver_tpu_torch.sweep import complex_seeds
    case, kw = profiles_cases.complex_case(name, cases, config)
    t = time.perf_counter()
    rs, st = run_case_complex(case, **kw)
    wall = time.perf_counter() - t
    margin = 0.05 * case.imag_band
    om0, k0 = complex_seeds(case, kw["n_re"], kw["n_im"])
    kk = jnp.asarray(k0)
    out = {"counts": rs.counts(),
           "counts_off_axis": {b: int(np.sum(np.abs(r.omegas_imag) > margin))
                               for b, r in rs.branches.items()},
           "completeness": st.completeness, "candidates": st.n_candidates,
           "k_stride": profiles_cases.COMPLEX[name],
           "counts_converged": {}, "accepted": {}, "converged": {},
           "seeds_accepted": {}, "seeds_converged": {}}
    for mode in case.modes:
        b = MODE_NAMES[mode]
        disp = make_dispersion_jitted(case, mode, jnp.float64)
        om = jnewton(disp, jnp.asarray(om0), kk, n_iter=kw["newton_iters"])
        res = disp(om, kk)
        nxt = jnewton(disp, om, kk, n_iter=1)
        om = np.asarray(om)
        acc, conv = kh.seed_verdicts(case, om, np.asarray(nxt),
                                     np.asarray(res.mismatch_pct),
                                     np.asarray(res.valid), k0)
        # the verdicts accept what the sweep accepted
        assert len(jdedup(om[acc], k0[acc], case.tol.dedup_rel)[0]) == \
            rs.counts()[b]
        out["counts_converged"][b] = kh.converged_count(
            om, k0, acc, conv, jdedup, case.tol.dedup_rel)
        out["accepted"][b] = int(acc.sum())
        out["converged"][b] = int(conv.sum())
        out["seeds_accepted"][b] = kh.pack_mask(acc)
        out["seeds_converged"][b] = kh.pack_mask(conv)
    out.update(wall_s=wall, total_s=time.perf_counter() - t,
               jax=jax.__version__)
    return out


def jax_reduced(name: str) -> dict:
    """The reduced sweep of test_reduced_sweep_equals_jax through the JAX
    package: counts, and (ks, omegas) per branch."""
    from eigensolver_tpu import search as jsearch
    from eigensolver_tpu import sweep as jsweep
    jcase, _ = _cases(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rs, _ = jsweep.run_case(jcase, jsearch.SearchConfig(**SEARCH))
    return {"counts": rs.counts(),
            "roots": {b: [br.ks.tolist(), br.omegas.tolist()]
                      for b, br in rs.branches.items()}}


def jax_reduced_complex(name: str) -> dict:
    """The JAX side of test_reduced_complex_sweep_equals_jax_per_seed: per
    mode, the sweep's seeds through the JAX package's Newton iteration
    (one jitted step, taken newton_iters times and once more), their
    omegas and verdicts (kh.seed_verdicts), and the roots its accepted
    seeds give (`roots.dedup_complex_roots`, as its run_case_complex
    counts them)."""
    import jax
    import jax.numpy as jnp
    from eigensolver_tpu.roots import dedup_complex_roots as jdedup
    from eigensolver_tpu.search import newton_complex as jnewton
    from eigensolver_tpu.sweep import make_dispersion_jitted
    from eigensolver_tpu_torch.sweep import complex_seeds
    jcase, _, kw = _complex_cases(name)
    om0, k0 = complex_seeds(jcase, kw["n_re"], kw["n_im"])
    kk = jnp.asarray(k0)
    out = {"counts": {}, "seeds": {}}
    for mode in jcase.modes:
        jd = make_dispersion_jitted(jcase, mode, jnp.float64)
        step = jax.jit(lambda o: jnewton(jd, o, kk, n_iter=1))
        om = jnp.asarray(om0)
        for _ in range(kw["newton_iters"]):
            om = step(om)
        res = jd(om, kk)
        nxt = np.asarray(step(om))
        om = np.asarray(om)
        acc, conv = kh.seed_verdicts(jcase, om, nxt,
                                     np.asarray(res.mismatch_pct),
                                     np.asarray(res.valid), k0)
        b = MODE_NAMES[mode]
        out["counts"][b] = len(jdedup(om[acc], k0[acc],
                                      jcase.tol.dedup_rel)[0])
        out["seeds"][b] = {
            "re": om.real.tolist(), "im": om.imag.tolist(),
            "accepted": acc.tolist(), "converged": conv.tolist()}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("jax-counts")
    p.add_argument("target", choices=sorted(profiles_cases.CONFIGS))
    p.add_argument("dtype", choices=["float32", "float64"])
    p.add_argument("--ieee", action="store_true",
                   help="compile as IEEE rounds (XLA_FLAGS)")
    p = sub.add_parser("port-counts")
    p.add_argument("target", choices=sorted(profiles_cases.CONFIGS))
    p.add_argument("dtype", choices=["float32", "float64"])
    p = sub.add_parser("jax-complex")
    p.add_argument("target", choices=sorted(profiles_cases.COMPLEX))
    for cmd in ("jax-reduced", "jax-reduced-complex"):
        p = sub.add_parser(cmd)
        p.add_argument("target", choices=sorted(
            profiles_cases.CONFIGS if cmd == "jax-reduced"
            else profiles_cases.COMPLEX))
    a = ap.parse_args()
    if a.cmd == "jax-counts":
        if a.ieee:      # read when jax initialises its CPU backend
            os.environ["XLA_FLAGS"] = IEEE_XLA_FLAGS
        res = jax_counts(a.target, a.dtype)
    elif a.cmd == "port-counts":
        res = port_counts(a.target, a.dtype)
    elif a.cmd == "jax-complex":
        res = jax_complex(a.target)
    elif a.cmd == "jax-reduced":
        res = jax_reduced(a.target)
    else:
        res = jax_reduced_complex(a.target)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
