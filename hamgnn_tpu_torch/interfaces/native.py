"""The native readers (C++17, no dependencies), built from the sources in the
checkout on first use.

``scfout_reader`` is the port's own (``hamgnn_tpu_torch/native``: every
double printed so that it reads back to the same bits); ``hsx_reader`` and
``csr_reader`` are the repository's ``native/`` sources, whose outputs are
exact already.  Each is compiled with ``g++ -O2 -std=c++17 -Wall`` (the flags
of ``native/Makefile``) into ``build/native/`` and rebuilt when its source is
newer.  A failed build raises: the native path never gives way to the Python
parsers, which stay the default of every reader.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parents[1]
ROOT = _PKG.parent
BUILD_DIR = ROOT / "build" / "native"
SOURCES = {
    "scfout_reader": _PKG / "native" / "scfout_reader.cpp",
    "hsx_reader": ROOT / "native" / "hsx_reader.cpp",
    "csr_reader": ROOT / "native" / "csr_reader.cpp",
}
CXXFLAGS = ["-O2", "-std=c++17", "-Wall"]


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: the native readers need g++ (or $CXX)")
    return cxx


def build_native(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Tuple[Path, float]]:
    """Compile the named readers, one compiler each, all started together.
    Returns {name: (executable, seconds its build took, 0 where it was
    current)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, jobs = {}, {}
    for name in names:
        src, exe = SOURCES[name], BUILD_DIR / name
        if exe.exists() and exe.stat().st_mtime >= src.stat().st_mtime:
            out[name] = (exe, 0.0)
            continue
        tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp"
        cmd = [_cxx(), *CXXFLAGS, "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, exe, time.perf_counter())
    failed = []
    for name, (proc, tmp, exe, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, exe)
        out[name] = (exe, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("native reader build failed for " + "\n".join(failed))
    return out


def native_tool(name: str) -> str:
    """Path of the named reader, built first where it is missing or stale."""
    return str(build_native([name])[name][0])
