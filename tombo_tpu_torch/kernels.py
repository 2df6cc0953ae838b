"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C interface, loaded with ctypes.  The build happens at first
use into ``build/tombo_tpu_torch/`` at the root of the checkout, keyed on
a hash of the source, the headers it includes and the flags, so an edit
to a shared header rebuilds every source that includes it and a fresh
checkout builds everything
it needs from the repository's sources alone.  All sources compile at
once, one nvcc process each.  A missing nvcc or a failed build raises:
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List

SOURCES = ("banded_dp", "banded_dp_chunked", "count_le")
# the kernels, each launched by one wrapper: K1, K2, K2', K5; K3, the
# read-sharded DP, which counts one per shard it launches on a card (each
# such launch is one of K1, or K2 then K2', and counts there too); K4,
# the start DP, a sub-count of K1's: each launch K1's wrapper makes for
# ``start_dp_segs`` counts under both, where it launches; and the
# row-writing instances of K1 and K2' (``rows=True``, the DP debug dump),
# which count under their own names only
KERNELS = ("banded_dp", "banded_dp_chunked_fwd", "banded_dp_chunked_tb",
           "count_le", "banded_dp_sharded", "start_dp", "banded_dp_rows",
           "banded_dp_chunked_tb_rows")

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tombo_tpu_torch")

# -fmad=false: no multiply-add contraction, so float results match the
# plain PyTorch versions op for op; -Xptxas -v reports registers and
# shared memory per kernel into the build log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}
# kernel launches so far, by kernel: each wrapper adds one where it
# launches a kernel (a CPU call runs the plain version and adds none)
LAUNCHES: Dict[str, int] = {n: 0 for n in KERNELS}


def count_launch(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_bytes(path: str, seen: set) -> bytes:
    """The file's bytes followed by those of every local header it
    includes (``#include "..."``, recursively, each once)."""
    if path in seen:
        return b""
    seen.add(path)
    with open(path, "rb") as f:
        src = f.read()
    return src + b"".join(
        _source_bytes(os.path.join(os.path.dirname(path), inc.decode()),
                      seen) for inc in _INCLUDE.findall(src))


def _lib_path(name: str) -> str:
    src = _source_bytes(os.path.join(CSRC, name + ".cu"), set())
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, h.hexdigest()[:16]))


def build(names: List[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, all nvcc processes started
    together.  Returns name -> library path."""
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = "%s.%d.tmp" % (paths[n], os.getpid())
        procs[n] = (tmp, subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ["-o", tmp, os.path.join(CSRC, n + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[n] = out
        BUILD_SECONDS[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s" % (n, proc.returncode,
                                                      out))
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build()[name])
            _LIBS[name] = lib
        return lib


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a launch.  The launch
    itself goes to the thread's current device, so a wrapper calls the
    library inside ``torch.cuda.device(device)``."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
