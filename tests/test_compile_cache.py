"""The entry points' compile-cache helper (utils/compile_cache.py)."""

import os

import jax
import pytest

from polychordlite_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_used_and_nothing_is_set(
    monkeypatch, restore_cache_dir, tmp_path
):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing in code
    assert jax.config.jax_compilation_cache_dir is None


def test_fixed_repo_path_without_env(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    second = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert first == second == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first


def test_library_import_sets_no_cache():
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, polychordlite_tpu, polychordlite_tpu.run; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env={**env, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert out.stdout.strip() == "None"
