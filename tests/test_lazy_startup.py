"""Host-dispatch runs must never import jax; device paths pick their
implementation without reading a platform name.

``import jax`` costs ~1.8 s, and panels below the work threshold are
counted entirely on the host (core/pipeline._auto_prefers_host), so the
whole run — parse, index, map, pileup, count, print — must complete
without touching jax.  ``PHYLONIUM_TPU_EXPECT_NO_JAX=1`` turns a
violation into exit code 70 (phylonium_tpu/__main__.py).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def small_panel(tmp_path):
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, 4000)
    files = []
    for k in range(3):
        arr = base.copy()
        idx = rng.random(arr.size) < 0.02 * (k + 1)
        arr[idx] = (arr[idx] + rng.integers(1, 4, int(idx.sum()))) % 4
        seq = bytes(b"ACGT"[c] for c in arr)
        p = tmp_path / f"L{k}.fasta"
        p.write_bytes(b">L%d\n" % k + seq + b"\n")
        files.append(str(p))
    return files


def _cli_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_host_run_never_imports_jax(small_panel):
    r = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu", "--progress=never",
         *small_panel],
        capture_output=True, timeout=300,
        env=_cli_env(PHYLONIUM_TPU_EXPECT_NO_JAX="1"),
    )
    assert r.returncode == 0, r.stderr.decode()[-500:]
    assert b"jax was imported" not in r.stderr
    # sanity: a real matrix came out
    assert r.stdout.startswith(b"3\n")


def test_host_run_verbose_flags_never_import_jax(small_panel):
    """-v -v, -b, ani — the decorated host paths stay jax-free too."""
    r = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu", "--progress=never",
         "-v", "-v", "-b", "2", "--distance", "ani", *small_panel],
        capture_output=True, timeout=300,
        env=_cli_env(PHYLONIUM_TPU_EXPECT_NO_JAX="1"),
    )
    assert r.returncode == 0, r.stderr.decode()[-500:]
    assert b"jax was imported" not in r.stderr


def test_platform_override_applied_once(monkeypatch):
    """PHYLONIUM_TPU_PLATFORM reaches jax through the config API at the
    first device chokepoint, exactly once."""
    import jax

    import phylonium_tpu.utils.platform as plat

    calls = []
    monkeypatch.setattr(plat, "_override_applied", False)
    monkeypatch.setenv("PHYLONIUM_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.append((k, v))
    )
    plat.apply_platform_override()
    plat.apply_platform_override()
    assert calls == [("jax_platforms", "cpu")]
    assert plat.cpu_pinned()


def test_no_platform_name_branch_in_package():
    """The choice between implementations never reads a platform name:
    no source line of the package compares against one."""
    import re

    pattern = re.compile(
        r"""platform\s*[!=]=\s*["'](?!cpu["'])[a-z]+["']"""
        r"""|["'](?!cpu["'])[a-z]+["']\s*[!=]=\s*\S*platform"""
    )
    hits = []
    for root, _, names in os.walk(os.path.join(REPO, "phylonium_tpu")):
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    for k, line in enumerate(f, 1):
                        if pattern.search(line):
                            hits.append(f"{path}:{k}: {line.strip()}")
    assert not hits, hits


@pytest.mark.parametrize("platform", ["gpu", "rocm", "cpu"])
def test_device_path_ignores_reported_platform(monkeypatch, platform):
    """Whatever platform the devices report, the device path runs the
    one entry point, compiled (not interpreted) unless CPU-pinned."""
    import jax

    import phylonium_tpu.core.pipeline as pipe
    import phylonium_tpu.ops.device_counts as dc
    import phylonium_tpu.utils.platform as plat
    from phylonium_tpu.config import RunConfig
    from phylonium_tpu.ops.match_table import pair_counts_numpy

    class Dev:
        pass

    dev = Dev()
    dev.platform = platform
    seen = []

    def spy(padded, packed, interpret):
        # the kernel's (matches, homs) from the numpy oracle
        seen.append(interpret)
        subs, homs = pair_counts_numpy(np.asarray(padded))
        return np.stack((homs - subs, homs))

    import phylonium_tpu.utils.cache as cache

    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    monkeypatch.setattr(plat, "cpu_pinned", lambda: False)
    monkeypatch.setattr(cache, "_enabled", True)  # keep the worker's config
    monkeypatch.setattr(dc, "_panel_counts", spy)
    states = np.random.default_rng(1).integers(0, 11, (4, 300), np.uint8)
    subs, homs = pipe.pair_counts(states, RunConfig(count_backend="device"))
    assert seen == [False]
    es, eh = pair_counts_numpy(states)
    assert (subs == es).all() and (homs == eh).all()
