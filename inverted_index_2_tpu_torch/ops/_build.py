"""Build and load the CUDA kernels of csrc/ (K1 decode, K2 fused AND, K3
sorted-set AND, K4 row sort, merge and compaction).

At first use (never at import) nvcc compiles every `csrc/*.cu` for Hopper
(`sm_90a`), one process per source in parallel, and links them into one
shared library with a plain C interface, under
`build/kernels/` in the checkout, named by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads as it is. The
library is loaded with ctypes: every pointer and the stream pass as
c_void_p, and each entry point returns cudaGetLastError() after its launch,
which `check` turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc run in this process (None: loaded)
build_log = ""        # nvcc's output of that run (ptxas register/smem report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of inverted_index_2_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtpi_kernels-{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], False
    for _, proc in jobs:
        logs.append(proc.communicate()[0])
        failed |= proc.returncode != 0
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        res = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *[str(o) for o, _ in jobs]],
            capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        failed = res.returncode != 0
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{build_log}")
    os.replace(tmp, so)


def _bind(lib):
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.tpi_decode_postings.argtypes = [vp, i, vp, vp, vp, vp, i, i, vp, vp,
                                        vp]
    lib.tpi_decode_postings.restype = i
    lib.tpi_fused_and.argtypes = [vp, i, vp, vp, vp, i, i, i, i, vp, vp,
                                  vp]
    lib.tpi_fused_and.restype = i
    lib.tpi_compact_rows.argtypes = [vp, i64, vp, i64, vp, i64, i64, vp]
    lib.tpi_compact_rows.restype = i
    lib.tpi_sort_tiles.argtypes = [vp, i64, vp, i64, i64, i64, i, i, vp]
    lib.tpi_sort_tiles.restype = i
    lib.tpi_merge_runs.argtypes = [vp, i64, vp, i64, i64, i64, i64, vp]
    lib.tpi_merge_runs.restype = i
    lib.tpi_intersect.argtypes = [vp, vp, vp, i, i, i, i, vp, vp, vp]
    lib.tpi_intersect.restype = i
    lib.tpi_error_string.argtypes = [i]
    lib.tpi_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _compile(so)
            _lib = _bind(ctypes.CDLL(str(so)))
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = _lib.tpi_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
