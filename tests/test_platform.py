"""Platform-dependent choices made in Python: which Viterbi implementation
a receiver gets, and where the persistent compile cache lives."""

import os
import subprocess
import sys

import pytest

from dvbt_tpu.models import rx as rxm
from dvbt_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,want", [
    ("gpu", "pallas"), ("cpu", "jnp"), ("rocm", "jnp"),
])
def test_auto_viterbi_impl_per_platform(platform, want):
    assert rxm._resolve_viterbi_impl("auto", platform) == want


@pytest.mark.parametrize("impl", rxm.VITERBI_IMPLS)
def test_explicit_viterbi_impl_is_kept(impl):
    assert rxm._resolve_viterbi_impl(impl, "gpu") == impl
    assert rxm._resolve_viterbi_impl(impl, "cpu") == impl


def test_unknown_viterbi_impl_is_refused():
    with pytest.raises(AssertionError):
        rxm._resolve_viterbi_impl("mosaic", "gpu")


def test_auto_viterbi_impl_on_this_backend_is_jnp():
    assert rxm._resolve_viterbi_impl("auto") == "jnp"   # tests run on CPU


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache_sets_only_the_default(env_set, tmp_path):
    """With the env var set, JAX's own setting stands (nothing is written
    in code); without it, JAX is pointed at the in-checkout default."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop(compile_cache.ENV, None)
    if env_set:
        env[compile_cache.ENV] = str(tmp_path)
    code = ("import jax\n"
            "from dvbt_tpu.utils.compile_cache import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.split()
    want = str(tmp_path) if env_set else os.path.join(REPO, ".jax_cache")
    assert out == [want, want]
