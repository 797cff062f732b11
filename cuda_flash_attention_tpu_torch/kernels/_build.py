"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports a plain C interface and is compiled on its own
into `build/kernels/<name>-<hash>.so` at the repository root the first time a
kernel of it is launched (the hash covers the source and the flags, so an
edited source is rebuilt).  Nothing here runs at import: the CPU-only test
machine imports every module and has no nvcc.

No source links libcuda: the sources that use TMA tensor maps look up
cuTensorMapEncodeTiled in libcuda.so.1 with dlopen at their first launch
(csrc/hopper.cuh, the helpers that several sources include).

Calling convention of every entry point: pointers and the CUDA stream are
`ctypes.c_void_p`, sizes `ctypes.c_int`, scalars `ctypes.c_float`; the
function returns the cudaError_t of its launch (or an error of its own that
the library's error-string function names), which `check` turns into an
exception.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# Wall seconds of each source's nvcc process (from its start) in the builds
# of this process.
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "csrc/ at first use"
    )


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    # The shared headers (csrc/*.cuh) are part of every source's hash, and
    # so is a source that this one includes (csrc/<name>_d<D>.cu builds
    # csrc/<name>.cu at one head dim).
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    text = src.read_bytes()
    included = b"".join((CSRC_DIR / inc.decode()).read_bytes()
                        for inc in re.findall(rb'#include "(\w+\.cu)"', text))
    digest = hashlib.sha256(
        text + included + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(*names: str) -> dict[str, str]:
    """Compile the named sources that are not built yet, one nvcc process
    each, at most one a core, started in the order given (so a caller that
    lists the longest first keeps every core busy to the end instead of
    sharing them among all the compilers at once).  Returns each new
    build's compiler log (ptxas register and shared-memory report); raises
    with the log of any source that failed.  Processes that build at once
    take turns (a file lock in the build directory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # One builder at a time across processes (the ranks of a mesh on one
    # host load the same libraries): a second caller waits here, then finds
    # what the first built.
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(names)


def _build_locked(names) -> dict[str, str]:
    pending = []
    slots = threading.Semaphore(os.cpu_count() or 1)
    outputs, threads = {}, []

    # Each process's log is drained on a thread of its own (no full pipe
    # stalls a compiler), which frees its slot when the compiler exits.
    def drain(name, proc, t0):
        outputs[name] = proc.communicate()[0]
        BUILD_SECONDS[name] = time.perf_counter() - t0
        slots.release()

    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        slots.acquire()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        pending.append((name, out, tmp, proc))
        threads.append(threading.Thread(target=drain,
                                        args=(name, proc, time.perf_counter())))
        threads[-1].start()
    for t in threads:
        t.join()
    logs, errors = {}, []
    for name, out, tmp, proc in pending:
        log = outputs[name].decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a half-written library is never loaded
        logs[name] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, error_string: str, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        fn = getattr(lib, error_string)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what} failed: CUDA error {err} ({fn(err).decode()})")
