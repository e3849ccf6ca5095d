"""chip_smoke.py's contract where there is no GPU.

It must exit non-zero and end with ``"ok": false`` when no card is
visible, when JAX finds no accelerator, and when it stands alone in a
directory without the package; its rehearsal mode drives the phases at
toy sizes on the CPU and still never reports ok.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(args, path_dir, script=SCRIPT, timeout=300, **env_extra):
    env = dict(os.environ)
    env["PATH"] = str(path_dir)  # nvidia-smi only if the test puts one
    env.update(env_extra)
    r = subprocess.run(
        [sys.executable, script, *args], capture_output=True, text=True,
        timeout=timeout, env=env, cwd=os.path.dirname(script),
    )
    last = json.loads(r.stdout.strip().splitlines()[-1])
    return r.returncode, last, r


def _fake_nvidia_smi(tmp_path):
    tool = tmp_path / "nvidia-smi"
    tool.write_text(
        "#!/bin/sh\n"
        'case "$1" in --query-gpu=*) echo "NVIDIA H100 80GB HBM3, 700.00 W";;'
        " esac\n"
    )
    tool.chmod(0o755)
    return tmp_path


def test_fails_without_a_visible_gpu(tmp_path):
    rc, last, _ = _run([], tmp_path)
    assert rc != 0
    assert last["ok"] is False and "GPU" in last["error"]


def test_fails_when_jax_finds_no_gpu(tmp_path):
    """nvidia-smi answers, but JAX runs on the CPU: no result."""
    rc, last, r = _run([], _fake_nvidia_smi(tmp_path), JAX_PLATFORMS="cpu")
    assert rc != 0
    assert last == {"ok": False, "error": last["error"]}
    assert "no GPU" in last["error"]
    assert "card: NVIDIA H100" in r.stdout  # printed before the last line


def test_fails_alone_in_a_directory(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(SCRIPT, alone / "chip_smoke.py")
    rc, last, _ = _run(
        [], _fake_nvidia_smi(tmp_path), script=str(alone / "chip_smoke.py")
    )
    assert rc != 0
    assert last["ok"] is False and "phylonium_tpu" in last["error"]
    assert not (alone / ".smoke").exists()


def test_rehearsal_four_devices_never_reports_ok(tmp_path):
    """--rehearse --four drives the multi-device phase on four virtual
    CPU devices — auto mesh, --mesh 2,2 and one device byte-compared
    with the host — and still ends with ok: false."""
    rc, last, r = _run(
        ["--rehearse", "--four"], tmp_path, timeout=600
    )
    assert rc != 0
    assert last["ok"] is False and "rehearsal" in last["error"]
    assert "phase four passed" in r.stderr, r.stderr[-3000:]
