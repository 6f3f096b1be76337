"""The port's checkpoint store (`native.store`) against the JAX package's:
for the same appends the port's two writers (the ctypes library and the
pure-Python writer, forced here by patching `get_lib`) and the JAX store
write byte-identical files, and every reader reads every writer's file.
Also the JAX package's store test (tests/test_analysis_synthesis.py::
test_result_store_roundtrip_and_resume) on the port, with both writers."""
import numpy as np
import pytest

from eigensolver_tpu.native import store as jstore
from eigensolver_tpu_torch.native import _lib, store

APPENDS = (  # (mode, ks, omegas, omegas_imag)
    (0, np.array([0.5, 0.5, 0.7]), np.array([1.1, 1.2, 1.3]), None),
    (1, np.array([0.7]), np.array([1.5]), np.array([0.02])),
    (1, np.array([0.9, 1.1]), np.array([np.nan, np.nan]), np.zeros(2)),
    (0, np.array([1.3]), np.array([2.5]), None),
)


def _write(pkg_store, path, split: int = 2):
    """The appends through pkg_store, closing and reopening the store after
    the first `split` (a resume)."""
    with pkg_store.ResultStore(path) as st:
        backend = getattr(st, "backend", None)
        for mode, ks, om, oi in APPENDS[:split]:
            st.append(mode, ks, om, oi)
    with pkg_store.ResultStore(path) as st:
        for mode, ks, om, oi in APPENDS[split:]:
            st.append(mode, ks, om, oi)
    return backend


def test_native_library_loads():
    assert _lib.get_lib() is not None


def test_both_writers_bytes_equal_jax(tmp_path, monkeypatch):
    pj, pn, pp = (str(tmp_path / f"{n}.eigr") for n in ("jax", "nat", "py"))
    _write(jstore, pj)
    assert _write(store, pn) == "native"
    monkeypatch.setattr(store, "get_lib", lambda: None)
    assert _write(store, pp) == "python"
    want = open(pj, "rb").read()
    assert len(want) == 16 + 32 * 7
    assert open(pn, "rb").read() == want
    assert open(pp, "rb").read() == want


@pytest.mark.parametrize("reader", ["native", "python", "jax"])
@pytest.mark.parametrize("writer", ["native", "python", "jax"])
def test_every_reader_reads_every_writer(writer, reader, tmp_path,
                                         monkeypatch):
    p = str(tmp_path / "s.eigr")
    if writer == "jax":
        _write(jstore, p)
    else:
        with monkeypatch.context() as mp:
            if writer == "python":
                mp.setattr(store, "get_lib", lambda: None)
            _write(store, p)
    with monkeypatch.context() as mp:
        if reader == "python":
            mp.setattr(store, "get_lib", lambda: None)
        read = jstore.read_all if reader == "jax" else store.read_all
        modes, ks, om, oi = read(p)
        done1 = (jstore if reader == "jax" else store).resume_k_done(p, 1)
    assert list(modes) == [0, 0, 0, 1, 1, 1, 0]
    np.testing.assert_array_equal(ks, [0.5, 0.5, 0.7, 0.7, 0.9, 1.1, 1.3])
    np.testing.assert_array_equal(om[:4], [1.1, 1.2, 1.3, 1.5])
    assert np.isnan(om[4:6]).all() and om[6] == 2.5
    np.testing.assert_array_equal(oi, [0, 0, 0, 0.02, 0, 0, 0])
    np.testing.assert_array_equal(done1, [0.7, 0.9, 1.1])


@pytest.mark.parametrize("writer", ["native", "python"])
def test_result_store_roundtrip_and_resume(writer, tmp_path, monkeypatch):
    if writer == "python":
        monkeypatch.setattr(store, "get_lib", lambda: None)
    p = str(tmp_path / "roots.eigr")
    with store.ResultStore(p) as st:
        assert st.backend == writer
        st.append(0, np.array([0.5, 0.5]), np.array([1.1, 1.2]))
        st.append(1, np.array([0.7]), np.array([1.5]), np.array([0.02]))
    modes, ks, om, oi = store.read_all(p)
    assert list(modes) == [0, 0, 1]
    np.testing.assert_allclose(om, [1.1, 1.2, 1.5])
    np.testing.assert_allclose(oi, [0.0, 0.0, 0.02])
    np.testing.assert_allclose(store.resume_k_done(p, 0), [0.5])
    with store.ResultStore(p) as st:
        st.append(0, np.array([0.9]), np.array([2.0]))
    modes2, _, _, _ = store.read_all(p)
    assert len(modes2) == 4
    np.testing.assert_allclose(store.resume_k_done(p, 0), [0.5, 0.9])
    assert len(store.resume_k_done(str(tmp_path / "none.eigr"), 0)) == 0


@pytest.mark.parametrize("writer", ["native", "python"])
def test_read_refuses_a_file_without_the_header(writer, tmp_path,
                                                monkeypatch):
    if writer == "python":
        monkeypatch.setattr(store, "get_lib", lambda: None)
    p = tmp_path / "bad.eigr"
    p.write_bytes(b"NOPE" + bytes(12))
    with pytest.raises(IOError):
        store.read_all(str(p))
