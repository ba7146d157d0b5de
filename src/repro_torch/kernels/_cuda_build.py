"""Build and load the port's CUDA C++ kernels (``src/repro_torch/csrc/``).

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface, which ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o .kernel_build/cuda/<name>-<key>.so

- ``<key>`` hashes the source, every shared header ``csrc/*.cuh`` (the
  sources include ``sm90.cuh``), the ``nvcc`` version and the flags, so
  an edited source or header or another toolkit builds anew and an
  unchanged one loads the library already there;
- the compiler writes to a temporary name that is renamed into place, so
  a second process never loads a half-written library;
- ``ptxas``'s report (registers, shared memory and spills per kernel) is
  kept beside the library as ``<name>-<key>.log``;
- ``nvcc`` is looked for under ``$CUDA_HOME/bin``, then on ``PATH``, then
  under ``/usr/local/cuda/bin``; where there is none, building raises.

Nothing here runs at import: the CPU tests import every module of the port
without ``nvcc``. ``build_all`` starts one ``nvcc`` per source at once, so
a cold start costs the slowest build, not their sum.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / ".kernel_build" \
    / "cuda"
SOURCES = ("flash_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + \
        [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels (K3, K4) are built "
        "from src/repro_torch/csrc/ on first use and need the CUDA toolkit")


@functools.cache
def _nvcc_version(nvcc: str) -> str:
    return subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def library_path(name: str, nvcc: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(_nvcc_version(nvcc).encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    (final path, temporary path, process or None)."""
    out = library_path(name, nvcc)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name, out, tmp, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict:
    """Build every named source that is not built yet, one ``nvcc`` each,
    all started together. Returns {name: (library path, seconds)}."""
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    started = {n: _start(n, nvcc) for n in names}
    done = {}
    for n, (out, tmp, proc) in started.items():
        _finish(n, out, tmp, proc)
        done[n] = (out, time.perf_counter() - t0)
    return done


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said when ``name``'s library was built (empty if
    its log is gone)."""
    log = library_path(name, find_nvcc()).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built first if needed)."""
    out, _ = build_all((name,))[name]
    return ctypes.CDLL(str(out))


def check(lib: ctypes.CDLL, entry: str, code: int) -> None:
    """Raise for a nonzero ``cudaError_t`` returned by the C entry
    ``entry``, with the error's name from the library's
    ``<entry>_error_string``."""
    if code != 0:
        name = getattr(lib, f"{entry}_error_string")
        name.argtypes, name.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{entry}: CUDA error {code} "
                           f"({name(code).decode()})")
