"""The one backend decision (lorastencil/backend.py) and the compile
cache placement."""

import os

import jax
import pytest

from lorastencil import backend, engine


@pytest.mark.parametrize("requested,applies,plat,k,want", [
    ("auto", True, "gpu", None, "kernel"),
    ("auto", True, "gpu", 2, "kernel"),
    ("auto", True, "gpu", 1, "xla"),
    ("auto", False, "gpu", None, "xla"),
    ("xla", True, "gpu", None, "xla"),
    ("kernel", True, "gpu", None, "kernel"),
    ("kernel", True, "gpu", 1, "kernel"),
    ("auto", True, "cpu", None, "xla"),
    ("xla", False, "cpu", None, "xla"),
])
def test_resolve(requested, applies, plat, k, want):
    assert backend.resolve(requested, applies, plat, fused_steps=k) == want


def test_kernel_on_cpu_raises():
    """No interpret mode: the kernel is never emulated."""
    with pytest.raises(ValueError, match="interpret"):
        backend.resolve("kernel", True, "cpu")


def test_kernel_that_does_not_apply_raises():
    with pytest.raises(ValueError, match="no kernel"):
        backend.resolve("kernel", False, "gpu")


@pytest.mark.parametrize("plat", ["rocm", "metal"])
def test_other_platforms_raise(plat):
    with pytest.raises(RuntimeError, match=plat):
        backend.resolve("auto", True, plat)


def test_unknown_backend_name_raises():
    with pytest.raises(ValueError, match="backend"):
        backend.resolve("pallas", True, "cpu")


def test_platform_is_the_first_device():
    assert backend.platform() == jax.devices()[0].platform == "cpu"


@pytest.mark.parametrize("name,kw,want", [
    ("star2d1r", {}, "kernel"),
    ("box2d3r", {"dtype": "bfloat16"}, "kernel"),
    ("star2d1r", {"dtype": "df64"}, "xla"),
    ("box3d1r", {}, "xla"),
    ("1d2r", {}, "xla"),
    ("star2d1r", {"backend": "xla"}, "xla"),
    ("star2d1r", {"fused_steps": 1}, "xla"),
    ("star2d1r", {"fused_steps": 2}, "kernel"),
])
def test_engine_path_on_a_gpu(name, kw, want, monkeypatch):
    """With a GPU, 2-D fp32/bf16 engines take the kernel at its default
    depth or the depth asked for, unless that is one step per pass, and
    everything else XLA (the kernel is built only when a step is traced,
    so nothing is compiled here)."""
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    interior = {1: (4096,), 2: (64, 256), 3: (8, 16, 128)}[
        engine.get_shape(name).ndim]
    eng = engine.StencilEngine.for_shape(name, interior, **kw)
    assert eng.backend == want
    if want == "kernel":
        assert eng._fused_k() == kw.get("fused_steps",
                                        engine.KERNEL_FUSED_STEPS)
        assert min(eng.layout.origin) >= eng._fused_k() * eng.spec.radius


@pytest.mark.parametrize("kw,want", [
    ({}, "xla"),
    ({"fused_steps": 2}, "kernel"),
    ({"fused_steps": 2, "dtype": "df64"}, "xla"),
])
def test_sharded_block_path_on_a_gpu(kw, want, monkeypatch):
    """Sharded blocks follow the same rule; their default is one step per
    exchange, so the plain step."""
    from lorastencil.parallel import domain

    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    sh = domain.sharded_engine("star2d1r", (256, 512), (2, 2), **kw)
    assert sh.backend == want


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert backend.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = backend.setup_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache") == backend.CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_generated_dirs_are_ignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        lines = set(f.read().split())
    assert {".jax_cache/", ".build/", "chiprun_out/"} <= lines
