"""Port K_m-ratio (plain and kernel wrapper) vs the JAX package's, including
the Pallas kernel in interpret mode."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eigensolver_tpu import special as jspecial
from eigensolver_tpu_torch import special
from eigensolver_tpu_torch.kernels import bessel

ZS = np.concatenate([np.geomspace(0.05, 200.0, 193), [1.99, 2.0, 2.01]])


@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-13),
                                         (np.float32, 1e-5)])
def test_kve_ratio_both_real_matches_jax(dtype, rtol):
    z = ZS.astype(dtype)
    w0, w1 = (np.asarray(x) for x in jspecial.kve_ratio_both(jnp.asarray(z)))
    g0, g1 = (x.numpy() for x in special.kve_ratio_both(torch.from_numpy(z)))
    assert g0.dtype == dtype and g1.dtype == dtype
    np.testing.assert_allclose(g0, w0, rtol=rtol)
    np.testing.assert_allclose(g1, w1, rtol=rtol)


def test_kve_ratio_both_complex_matches_jax():
    rng = np.random.default_rng(0)
    z = rng.uniform(0.05, 20, 64) + 1j * rng.uniform(-10, 10, 64)
    w0, w1 = (np.asarray(x) for x in jspecial.kve_ratio_both(jnp.asarray(z)))
    g0, g1 = (x.numpy() for x in special.kve_ratio_both(torch.from_numpy(z)))
    np.testing.assert_allclose(g0, w0, rtol=1e-12)
    np.testing.assert_allclose(g1, w1, rtol=1e-12)


@pytest.mark.parametrize("m", [0, 1])
def test_kve_ratio_selects_order(m):
    z = torch.from_numpy(ZS)
    both = special.kve_ratio_both(z)
    assert torch.equal(special.kve_ratio(m, z), both[m])


def test_wrapper_on_cpu_is_the_plain_version():
    z = torch.from_numpy(np.random.default_rng(1).uniform(0.05, 30, 300))
    before = bessel.launches
    got = bessel.kve_ratio_both(z)
    want = special.kve_ratio_both(z)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bessel.launches == before


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        bessel.kve_ratio_both(torch.empty(4, device="meta"))


def test_matches_pallas_kernel_interpret():
    from eigensolver_tpu.kernels.bessel import kve_ratio_pallas
    z = np.random.default_rng(1).uniform(0.05, 30, 1024).astype(np.float32)
    p0, p1 = (np.asarray(x) for x in kve_ratio_pallas(jnp.asarray(z),
                                                       interpret=True))
    g0, g1 = (x.numpy() for x in bessel.kve_ratio_both(torch.from_numpy(z)))
    np.testing.assert_allclose(g0, p0, rtol=1e-5)
    np.testing.assert_allclose(g1, p1, rtol=1e-5)


def _card_sets(dtype):
    """Argument sets of the card test, as numpy arrays of `dtype`: series
    only, CF2 only, 2 -+ 1 ulp, small z (whose float32 series terms
    underflow), a shuffled mix of all, each 4099 long (no multiple of the
    kernel's 256-argument block), and a 257-long mix."""
    rng = np.random.default_rng(2)
    two = dtype(2.0)
    below = np.nextafter(two, dtype(0.0))
    series = np.minimum(10.0 ** rng.uniform(-2.0, np.log10(2.0), 4099),
                        below).astype(dtype)
    cf2 = np.maximum(10.0 ** rng.uniform(np.log10(2.0), 2.3, 4099),
                     two).astype(dtype)
    edge = np.resize(np.array([below, two, np.nextafter(two, dtype(4.0))],
                              dtype), 4099)
    small = (10.0 ** rng.uniform(-3.0, -1.0, 4099)).astype(dtype)
    mix = rng.permutation(np.concatenate([series, cf2, edge, small]))
    return {"series": series, "cf2": cf2, "edge": edge, "small": small,
            "mix": mix[:4099], "mix_257": mix[-257:]}


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    """The kernel gives the plain version's bits on every argument set."""
    np_dtype = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    for name, zs in _card_sets(np_dtype).items():
        z = torch.from_numpy(zs).cuda()
        before = bessel.launches
        k0, k1 = bessel.kve_ratio_both(z)
        torch.cuda.synchronize()
        assert bessel.launches == before + 1
        p0, p1 = special.kve_ratio_both(z)
        for k, p in ((k0, p0), (k1, p1)):
            assert k.dtype == dtype
            same = (k == p) | (k.isnan() & p.isnan())
            assert bool(same.all()), (name, int((~same).sum()))
    z = torch.from_numpy(_card_sets(np_dtype)["mix"]).cuda()
    with pytest.raises(ValueError, match="contiguous"):
        bessel.kve_ratio_both(z[::2])
    with pytest.raises(TypeError):
        bessel.kve_ratio_both(z.to(torch.complex128))


# -- the unscaled functions and the I_m ratio (the uniform limit's analytic
# checks), on the arguments of tests/test_special.py, against the JAX
# package's: the same series and expansion, to rounding

@pytest.mark.parametrize("m", [0, 1])
def test_ive_ratio_matches_jax(m):
    z = np.array([0.1, 1.0, 4.0, 8.0])
    want = np.asarray(jspecial.ive_ratio(m, jnp.asarray(z)))
    got = special.ive_ratio(m, torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14)


@pytest.mark.parametrize("fn", ["k0", "k1", "i0", "i1"])
def test_unscaled_bessel_matches_jax(fn):
    # tests/test_special.py's small arguments, and both sides of the
    # series' range |z| <= 9 for K (the asymptotic expansion beyond)
    z = np.array([0.1, 0.7, 1.9, 5.0, 8.9, 9.0, 9.1, 15.0, 50.0])
    if fn.startswith("i"):
        z = z[z <= 9.0]
    want = np.asarray(getattr(jspecial, fn)(jnp.asarray(z)))
    got = getattr(special, fn)(torch.from_numpy(z))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)


def test_asymp_k_scaled_matches_jax():
    z = np.array([9.5, 12.0, 30.0, 200.0])
    for m in (0, 1):
        want = np.asarray(jspecial._asymp_k_scaled(jnp.asarray(z), m))
        got = special._asymp_k_scaled(torch.from_numpy(z), m).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-15)


def test_block_and_time_and_device_trace(tmp_path):
    """utils.block_and_time runs fn once and then n times, each call waited
    for; utils.device_trace writes a Chrome trace, and does nothing
    without a directory."""
    from eigensolver_tpu_torch import utils
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return x * scale
    x = torch.arange(4.0)
    out, sec = utils.block_and_time(fn, x, n=3, device="cpu", scale=2.0)
    assert len(calls) == 4 and torch.equal(out, 2 * x) and sec >= 0.0
    with utils.device_trace(None):
        special.k0(torch.ones(3, dtype=torch.float64))
    with utils.device_trace(str(tmp_path / "trace")):
        special.k0(torch.ones(3, dtype=torch.float64))
    trace = tmp_path / "trace" / "trace.json"
    assert trace.is_file() and "traceEvents" in trace.read_text()
