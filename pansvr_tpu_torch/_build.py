"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles every source in csrc/ for sm_90a (one nvcc process per
source, all started together) and links them into ONE shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). The output lives in build/kernels/ at the repo
root and its name carries a hash of the csrc/ contents, so an edited
kernel rebuilds and an unchanged one is reused. A failed build raises
with nvcc's stderr.

    from pansvr_tpu_torch._build import load_kernels
    lib = load_kernels()          # ctypes.CDLL, argtypes already set
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lock = threading.Lock()
build_seconds = 0.0     # wall time of this process's nvcc calls (0 = reused)
build_log = ""          # their output (ptxas registers / spills per kernel)


def _sources(csrc: str = CSRC) -> list[str]:
    return sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256()
    for f in _sources():
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpansvr_kernels_{h.hexdigest()[:16]}.so")


def compile_library(csrc: str, out: str) -> str:
    """nvcc every .cu of `csrc` (in parallel) and link them into the
    shared library `out`; returns nvcc's output. Raises on a failure."""
    global build_seconds, build_log
    import time

    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for cu in (f for f in _sources(csrc) if f.endswith(".cu")):
        objs.append(f"{tmp}.{os.path.basename(cu)}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], cu]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    runs = []
    for cmd, p in procs:
        so, se = p.communicate()
        runs.append((cmd, p.returncode, so, se))
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    if all(rc == 0 for _, rc, _, _ in runs):
        proc = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, proc.returncode, proc.stdout, proc.stderr))
    build_seconds = time.perf_counter() - t0
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    for cmd, rc, so, se in runs:
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{se}{so}")
    os.replace(tmp, out)       # atomic: concurrent builds race safely
    build_log = "".join(se + so for _, _, so, se in runs)
    return build_log


def _bind(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pansvr_extd2_fwd.restype = I
    lib.pansvr_extd2_fwd.argtypes = [P, P, P, P, P, P] + [I] * 17 + [P]
    lib.pansvr_extd2_tb.restype = I
    lib.pansvr_extd2_tb.argtypes = [P] * 7 + [I] * 5 + [P]
    lib.pansvr_cuda_error_string.restype = ctypes.c_char_p
    lib.pansvr_cuda_error_string.argtypes = [I]
    from .ops.front_cuda import bind

    bind(lib)


def load_kernels():
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                compile_library(CSRC, path)
            lib = ctypes.CDLL(path)
            _bind(lib)
            _lib = lib
    return _lib


def check(lib, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = lib.pansvr_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
