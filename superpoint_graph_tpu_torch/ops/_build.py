"""Build the package's native sources into shared libraries and load them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first use
with `nvcc` for Hopper (sm_90a) into `_build/` inside the package (listed in
.gitignore), then loaded with ctypes. The library's file name carries a hash
of the source, of every `csrc/*.cuh` header and of the flags, so an edited
source or header is rebuilt and a stale library is never loaded. ptxas's
report (registers, shared memory, spills of each kernel) is kept beside the
library.

`csrc/<name>.cpp` is host C++ (the host library, `native.py`): `build_host`
compiles it with g++ from PATH into the same directory. Its hash also takes
the compiler's version and the machine's architecture, so a library built on
one host is rebuilt, not loaded, on a host with another compiler; no
`-march=native`, so a library never holds instructions another CPU of the
same architecture lacks. Nothing here runs at import time: the CPU tests
import every module on a machine with no nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# -ffp-contract=off: no fused multiply-add, so the host library computes in
# the order its source writes, whatever the host's CPU
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _digest(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def ptxas_summary(log: str) -> str:
    """ptxas's per-kernel lines (function, registers and shared memory,
    spills) from nvcc's -Xptxas -v output, one per line."""
    keep = ("Compiling entry function", "Used ", "spill stores")
    return "\n".join(line.split("ptxas info    :")[-1].strip()
                     for line in log.splitlines()
                     if any(k in line for k in keep))


def build(name: str, src: Path | None = None) -> tuple[Path, float, str]:
    """Compile csrc/<name>.cu (or another source `src` of the same kernel,
    for A/B timing) unless its library exists; returns (path, seconds
    spent compiling, 0.0 when it was already built, ptxas_summary of the
    build)."""
    src = CSRC_DIR / f"{name}.cu" if src is None else Path(src)
    out = BUILD_DIR / f"lib{name}_{_digest(src)}.so"
    report = out.with_suffix(".ptxas.txt")
    if out.is_file() and report.is_file():
        return out, 0.0, report.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name, then rename: a concurrent build never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu:\n{res.stdout}\n{res.stderr}"
            )
        summary = ptxas_summary(res.stdout + res.stderr)
        report.write_text(summary)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0, summary


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    path, _, _ = build(name)
    return ctypes.CDLL(str(path))


def gxx_path() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the host library "
                           "(csrc/*.cpp) needs it")
    return found


def _host_digest(src: Path, gxx: str) -> str:
    version = subprocess.run([gxx, "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(version.encode() + platform.machine().encode())
    return h.hexdigest()[:16]


def build_host(name: str) -> tuple[Path, float]:
    """Compile csrc/<name>.cpp with g++ unless its library exists; returns
    (path, seconds spent compiling, 0.0 when it was already built). Raises
    with g++'s output when the build fails."""
    src = CSRC_DIR / f"{name}.cpp"
    gxx = gxx_path()
    out = BUILD_DIR / f"lib{name}_{_host_digest(src, gxx)}.so"
    if out.is_file():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ failed for {name}.cpp:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0


@functools.cache
def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cpp, built first if needed."""
    path, _ = build_host(name)
    return ctypes.CDLL(str(path))
