"""On-demand build of the native host library.

Compiles phylonium_native.cpp into a shared library next to the sources
(cached by mtime).  No external build system needed; plain g++ with
OpenMP.  Equivalent role to the reference's autotools + per-ISA kernel
libs (configure.ac, libs/Makefile.am) — here a single -O3 -march=native
translation unit.
"""

from __future__ import annotations

import os
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).parent / "src"
BUILD_DIR = Path(__file__).parent / "_build"
LIB_NAME = "libphylonium_native.so"
_BUILD_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def lib_path() -> Path:
    return BUILD_DIR / LIB_NAME


def needs_rebuild() -> bool:
    lib = lib_path()
    if not lib.exists():
        return True
    lib_mtime = lib.stat().st_mtime
    return any(
        src.stat().st_mtime > lib_mtime for src in SRC_DIR.glob("*.cpp")
    )


def _run(cmd: list[str]) -> None:
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=300
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"compiler invocation failed: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(
            f"native build failed:\n{proc.stderr[-4000:]}"
        )


def _gomp_link_args(cxx: str) -> list[str]:
    """How to link the OpenMP runtime: the compiler's own libgomp when
    it has one, else the system's (a compiler can ship ``omp.h`` but no
    runtime library)."""
    try:
        own = subprocess.run(
            [cxx, "-print-file-name=libgomp.so"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        own = ""
    if os.path.isabs(own) and os.path.exists(own):
        return [own]
    import ctypes.util

    system = ctypes.util.find_library("gomp")
    return [f"-l:{system}"] if system else ["-lgomp"]


def build(verbose: bool = False) -> Path:
    """Compile, then link against libgomp in a separate step: a g++
    that compiles OpenMP may still lack the ``libgomp.spec`` that
    ``-fopenmp`` at link time reads.  The library is linked under a
    name of this process's own and moved into place, so a concurrent
    process never loads a half-written file (threads of one process
    take turns through ``ensure_built``)."""
    BUILD_DIR.mkdir(exist_ok=True)
    sources = sorted(SRC_DIR.glob("*.cpp"))
    if not sources:
        raise NativeBuildError("no native sources found")

    cxx = os.environ.get("CXX", "g++")
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}"
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    try:
        for src, obj in zip(sources, objs):
            _run([
                cxx, "-O3", "-march=native", "-std=c++17", "-fPIC",
                "-fopenmp", "-Wall", "-c", "-o", str(obj), str(src),
            ])
        _run([
            cxx, "-shared", "-o", str(tmp), *map(str, objs),
            *_gomp_link_args(cxx), "-pthread",
        ])
        os.replace(tmp, lib_path())
    finally:
        for path in (tmp, *objs):
            path.unlink(missing_ok=True)
    if verbose:
        print(f"built {lib_path()}")
    return lib_path()


def ensure_built() -> Path:
    if os.environ.get("PHYLONIUM_TPU_NATIVE", "1") == "0":
        raise NativeBuildError("native backend disabled by env")
    # threads of one process share the build's file names: one builds
    with _BUILD_LOCK:
        if needs_rebuild():
            build()
    return lib_path()
