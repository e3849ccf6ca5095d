"""Compile-cache placement rule (utils/cache.py).

With ``JAX_COMPILATION_CACHE_DIR`` set, compiled executables land there
and the program names no other directory.  Without it they land in one
fixed, gitignored directory inside the checkout, the same path from
every process.  Each case runs in a fresh process so the global jax
config of the test worker stays untouched.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, os, sys
import jax, jax.numpy as jnp
from phylonium_tpu.utils.cache import cache_dir, enable_compile_cache
enable_compile_cache(force=True)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + 1)(jnp.ones((8, 128))).block_until_ready()
print(json.dumps({
    "config": jax.config.jax_compilation_cache_dir,
    "cache_dir": cache_dir(),
}))
"""


def _probe(env_extra, drop=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    for k in drop:
        env.pop(k, None)
    env.update(env_extra)
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=120, env=env, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_env_cache_dir_is_used_alone(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the entries land in it, and the
    program sets no directory of its own."""
    target = tmp_path / "cachedir"
    out = _probe({"JAX_COMPILATION_CACHE_DIR": str(target)})
    assert out["config"] == str(target)
    assert out["cache_dir"] == str(target)
    assert target.is_dir() and any(target.iterdir())


def test_default_cache_dir_fixed_in_checkout(tmp_path):
    """No JAX_COMPILATION_CACHE_DIR: one fixed, gitignored directory in
    the checkout, the same from two processes started in different
    working directories."""
    expected = os.path.join(REPO, ".jax_cache")
    first = _probe({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    env = {"HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    second = _probe(env, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert first["config"] == second["config"] == expected
    assert os.path.isdir(expected)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cpu_pinned_run_leaves_cache_alone(monkeypatch):
    """CPU-pinned runs (tests, forced host runs) never engage the cache."""
    import phylonium_tpu.utils.cache as cache

    monkeypatch.setattr(cache, "_enabled", False)
    cache.enable_compile_cache()
    assert cache._enabled is False
