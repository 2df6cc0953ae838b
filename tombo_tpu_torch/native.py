"""Build and load the port's host library: the minimizer aligner
(``csrc/aligner.cpp``, a copy of the JAX package's ``csrc/aligner.cpp``).

The source compiles with the host C++ compiler at first use into
``build/tombo_tpu_torch/`` at the root of the checkout, with the flags of
the JAX package's ``csrc/Makefile``, so the mappings equal the JAX
engine's.  The library is keyed on a hash of the source, the flags and
the host (``-march=native`` makes the binary the host's own).  This build
is apart from the CUDA one (``kernels.py``): a missing ``nvcc`` does not
stop the aligner, nor a missing C++ compiler the kernels.  A missing
compiler or a failed build raises :class:`TomboError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional

from .errors import TomboError
from .kernels import BUILD_DIR, CSRC

CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
             "-shared"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _lib_path(cxx: str) -> str:
    with open(os.path.join(CSRC, "aligner.cpp"), "rb") as f:
        src = f.read()
    h = hashlib.sha256(src + " ".join([cxx] + CXX_FLAGS).encode() +
                       ("%s %s" % (platform.node(),
                                   platform.machine())).encode())
    return os.path.join(BUILD_DIR, "libaligner_%s.so" % h.hexdigest()[:16])


def get_lib() -> ctypes.CDLL:
    """The loaded aligner library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        cxx = shutil.which("g++") or shutil.which("c++")
        if not cxx:
            raise TomboError("no C++ compiler (g++ or c++) found to build "
                             "the native aligner")
        path = _lib_path(cxx)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "%s.%d.tmp" % (path, os.getpid())
            try:
                out = subprocess.run(
                    [cxx] + CXX_FLAGS +
                    ["-o", tmp, os.path.join(CSRC, "aligner.cpp")],
                    capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise TomboError("native aligner build failed: %r" % e)
            if out.returncode != 0:
                raise TomboError("native aligner build failed (%s exit %d):"
                                 "\n%s" % (cxx, out.returncode, out.stderr))
            os.replace(tmp, path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise TomboError("native aligner library failed to load: %s" % e)
        lib.aln_index_build.restype = ctypes.c_void_p
        lib.aln_index_build.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.aln_index_free.restype = None
        lib.aln_index_free.argtypes = [ctypes.c_void_p]
        lib.aln_map.restype = ctypes.c_int64
        lib.aln_map.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64]
        _LIB = lib
        return _LIB
