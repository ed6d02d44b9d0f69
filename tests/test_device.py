"""The device gate, the compile-cache directory and the native build path."""

import os

import pytest

from tnsh.core import device


@pytest.fixture
def no_flag(monkeypatch):
    monkeypatch.delenv("TNSH_DEVICE_MSM", raising=False)


def test_gate_off_on_cpu_by_default(no_flag):
    import jax

    assert jax.default_backend() == "cpu"
    assert not device.on_gpu()
    assert not device.device_msm_enabled()


def test_gate_opt_in_and_out(monkeypatch):
    monkeypatch.setenv("TNSH_DEVICE_MSM", "1")
    assert device.device_msm_enabled()
    monkeypatch.setattr(device, "on_gpu", lambda: True)
    monkeypatch.setenv("TNSH_DEVICE_MSM", "0")
    assert not device.device_msm_enabled()


def test_gate_on_for_gpu_backend(no_flag, monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert device.on_gpu()
    assert device.device_msm_enabled()


def test_kzg_routes_large_msm_through_gate(monkeypatch):
    """kzg.msm sends an SRS MSM at or above the hybrid threshold to the
    hybrid exactly when the gate is on."""
    _native = pytest.importorskip("tnsh._native")
    if not _native.available:
        pytest.skip("native layer unavailable")
    from tnsh.commit import kzg
    from tnsh.core.params import NativeSRS
    from tnsh.field.fr import Fr
    from tnsh.field.g1 import G1

    calls = []
    monkeypatch.setattr(kzg, "_DEVICE_MSM_MIN", 4)
    monkeypatch.setattr(kzg, "_hybrid_srs_msm",
                        lambda srs, sc, n: calls.append(n) or G1.zero())
    srs = _native.srs_create_fixed_base(
        G1.generator(), b"".join(i.to_bytes(32, "little")
                                 for i in range(1, 9)))
    try:
        scalars = [Fr(i) for i in range(8)]
        monkeypatch.setenv("TNSH_DEVICE_MSM", "0")
        kzg.msm(NativeSRS(srs), scalars)
        assert calls == []
        monkeypatch.setenv("TNSH_DEVICE_MSM", "1")
        kzg.msm(NativeSRS(srs), scalars)
        assert calls == [8]
    finally:
        _native.srs_free(srs)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    import jax

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert device.DEFAULT_CACHE_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert device.setup_compile_cache() == device.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == (
            device.DEFAULT_CACHE_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_library_path_is_keyed_by_source():
    from tnsh import _native

    with open(_native._SRC, "rb") as f:
        src = f.read()
    path = _native.lib_path(src)
    assert os.path.dirname(path) == _native._BUILD_DIR
    assert _native.lib_path(src) == path
    assert _native.lib_path(src + b"\n// edited\n") != path
    if _native.available:
        # the loaded library is the build of the committed source
        assert os.path.exists(path)
        assert os.path.realpath(_native._lib._name) == os.path.realpath(path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        assert "tnsh/_native/build/" in f.read().split()
