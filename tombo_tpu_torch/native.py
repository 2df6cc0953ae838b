"""Build and load the port's host libraries, and bind the re-squiggle one.

Two libraries, each compiled with the host C++ compiler at first use into
``build/tombo_tpu_torch/`` at the root of the checkout, with the flags of
the JAX package's ``csrc/Makefile``, so their results equal the JAX
package's library bit for bit:

- the minimizer aligner (``csrc/aligner.cpp``, a copy of the JAX
  package's ``csrc/aligner.cpp``), :func:`get_lib`;
- the re-squiggle host library (``csrc/tombo_native.cpp`` and
  ``csrc/resquiggle_baseline.cpp``, copies of the JAX package's, linked
  into one library), :func:`get_native_lib`, bound below as the JAX
  package's ``tombo_tpu/native/__init__.py`` binds it: greedy changepoint
  selection, Theil-Sen, the deletion-window DP, the short-read static
  band, the fused finalize and deletion fix, int8-delta packing and the
  single-core C++ re-squiggle baseline.

A library is keyed on a hash of its sources, the flags and the host
(``-march=native`` makes the binary the host's own).  This build is apart
from the CUDA one (``kernels.py``): a missing ``nvcc`` does not stop the
host libraries, nor a missing C++ compiler the kernels.  There is no
fallback: a missing compiler, a failed build or a failed load raises
:class:`TomboError`.
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

import numpy as np

from . import config
from .errors import TomboError
from .kernels import BUILD_DIR, CSRC

CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
             "-shared"]
# library -> its sources in csrc/, what it is (for an error) and the
# module global that holds it once loaded
LIBRARIES = {
    "aligner": (("aligner.cpp",), "native aligner", "_LIB"),
    "tombo_native": (("tombo_native.cpp", "resquiggle_baseline.cpp"),
                     "native re-squiggle library", "_NATIVE_LIB"),
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_NATIVE_LIB: Optional[ctypes.CDLL] = None


def _lib_path(cxx: str, name: str = "aligner") -> str:
    src = b""
    for fn in LIBRARIES[name][0]:
        with open(os.path.join(CSRC, fn), "rb") as f:
            src += f.read()
    h = hashlib.sha256(src + " ".join([cxx] + CXX_FLAGS).encode() +
                       ("%s %s" % (platform.node(),
                                   platform.machine())).encode())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name,
                                                    h.hexdigest()[:16]))


def _load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use and bound."""
    sources, what, var = LIBRARIES[name]
    with _LOCK:
        lib = globals()[var]
        if lib is not None:
            return lib
        cxx = shutil.which("g++") or shutil.which("c++")
        if not cxx:
            raise TomboError("no C++ compiler (g++ or c++) found to build "
                             "the %s" % what)
        path = _lib_path(cxx, name)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "%s.%d.tmp" % (path, os.getpid())
            try:
                out = subprocess.run(
                    [cxx] + CXX_FLAGS + ["-o", tmp] +
                    [os.path.join(CSRC, fn) for fn in sources],
                    capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise TomboError("%s build failed: %r" % (what, e))
            if out.returncode != 0:
                raise TomboError("%s build failed (%s exit %d):\n%s" % (
                    what, cxx, out.returncode, out.stderr))
            os.replace(tmp, path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise TomboError("%s failed to load: %s" % (what, e))
        _BIND[name](lib)
        globals()[var] = lib
        return lib


def _bind_aligner(lib):
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


_D, _I64, _I32 = (ctypes.POINTER(ctypes.c_double),
                  ctypes.POINTER(ctypes.c_int64),
                  ctypes.POINTER(ctypes.c_int32))


def _bind_native(lib):
    i64, i = ctypes.c_int64, ctypes.c_int
    lib.greedy_cpts_batch.restype = None
    lib.greedy_cpts_batch.argtypes = [_D, i64, i64, _I64, _I64, i64, i64,
                                      i64, _I64, _I32, i64]
    lib.greedy_cpts_uncapped.restype = i64
    lib.greedy_cpts_uncapped.argtypes = [_D, i64, i64, _I64]
    for fn in ("theil_sen_batch", "theil_sen_batch32",
               "theil_sen_batch_fast"):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [_D, _D, i64, i64, _I64,
                                     ctypes.c_double, _D, _D, i64]
    lib.raw_windows_dp_batch.restype = None
    lib.raw_windows_dp_batch.argtypes = [
        _D, _I64, _D, _D, _I64, _I64, _I64, i64, i64, i, ctypes.c_double,
        _I64, _I64, _I32, i64]
    lib.finalize_batch.restype = None
    lib.finalize_batch.argtypes = [
        _D, _I64, _D, _D, _D, _D, _D, _D, _I64, _I64, _I64, _I32, _I32,
        _I64, i64, i64, i, ctypes.c_double, i64, i64, ctypes.c_double, i64,
        ctypes.c_double, i, _D, _D, _D, _D, _I32, i64]
    lib.del_fix_batch.restype = None
    lib.del_fix_batch.argtypes = [
        _D, _I64, _D, _D, _I64, _I64, _I64, i64, i64, i, ctypes.c_double,
        i64, i64, ctypes.c_double, i64, _I32, i64]
    lib.resquiggle_read_baseline.restype = i
    lib.resquiggle_read_baseline.argtypes = [
        _D, i64, _D, _D, i64, _I64, _D, _I64, _I64, _D, _D]
    lib.resquiggle_read_baseline_rna.restype = i
    lib.resquiggle_read_baseline_rna.argtypes = [
        _D, i64, _D, _D, i64, _I64, _I64, i64, _I64, _D, _I64, _I64, _D,
        _D]
    lib.static_base_assignment.restype = i
    lib.static_base_assignment.argtypes = [
        _D, i64, _D, _D, i64, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, i, ctypes.c_double, _I64]
    lib.pack_delta8_batch.restype = None
    lib.pack_delta8_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), _I64, i64, _I64,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int16),
        _I32, _I32, _I32, i64, _I64, i64]


_BIND = {"aligner": _bind_aligner, "tombo_native": _bind_native}


def get_lib() -> ctypes.CDLL:
    """The loaded aligner library, built on first use."""
    return _load("aligner")


def get_native_lib() -> ctypes.CDLL:
    """The loaded re-squiggle host library, built on first use."""
    return _load("tombo_native")


def _as_c(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def greedy_cpts_batch(scores: np.ndarray, n_cands: np.ndarray,
                      num_cpts: np.ndarray, shift: int, min_base_obs: int,
                      n_threads: int = 0):
    """Batched greedy changepoint selection (reference:
    tombo/_c_helper.pyx:100-120).

    scores: (B, C) float64 padded score matrix (padding < any real score);
    n_cands, num_cpts: (B,) int64.  Returns (cpts (B, max num_cpts) int64,
    each row sorted and shifted, status (B,) int32: 1 where fewer
    changepoints were found than requested)."""
    scores = np.ascontiguousarray(scores, dtype=np.float64)
    n_cands = np.ascontiguousarray(n_cands, dtype=np.int64)
    num_cpts = np.ascontiguousarray(num_cpts, dtype=np.int64)
    B, C = scores.shape
    max_cpts = int(num_cpts.max()) if B else 0
    out = np.zeros((B, max_cpts), dtype=np.int64)
    status = np.zeros(B, dtype=np.int32)
    get_native_lib().greedy_cpts_batch(
        _as_c(scores, ctypes.c_double), B, C,
        _as_c(n_cands, ctypes.c_int64), _as_c(num_cpts, ctypes.c_int64),
        max_cpts, shift, min_base_obs, _as_c(out, ctypes.c_int64),
        _as_c(status, ctypes.c_int32), n_threads)
    return out, status


def greedy_cpts_uncapped(scores: np.ndarray, min_base_obs: int) -> np.ndarray:
    """Uncapped changepoint selection: the accepted positions, unshifted,
    in acceptance order."""
    scores = np.ascontiguousarray(scores, dtype=np.float64)
    n = scores.shape[0]
    out = np.empty(n, dtype=np.int64)
    count = get_native_lib().greedy_cpts_uncapped(
        _as_c(scores, ctypes.c_double), n, min_base_obs,
        _as_c(out, ctypes.c_int64))
    return out[:count]


def pack_delta8_batch(raws, lens: np.ndarray, flat8: np.ndarray,
                      offs: np.ndarray, n_threads: int = 0):
    """Threaded int8-delta packing of int16 raw-signal rows.

    raws: list of C-contiguous int16 arrays; lens their sample counts;
    offs[i]: where read i's (lens[i] - 1) deltas start in ``flat8``.
    Returns (firsts (B,) int16, exc_read, exc_pos, exc_res): each read's
    first sample and the deltas that do not fit in int8 (read, position,
    residual)."""
    lib = get_native_lib()
    B = len(raws)
    lens = np.ascontiguousarray(lens, np.int64)
    offs64 = np.ascontiguousarray(offs, np.int64)
    if (lens.shape != (B,) or offs64.shape != (B,) or
            any(a.dtype != np.int16 or not a.flags.c_contiguous or
                a.shape[0] < n for a, n in zip(raws, lens))):
        raise ValueError("pack_delta8_batch takes C-contiguous int16 rows "
                         "of at least lens samples, and B lens and offs")
    if (flat8.dtype != np.int8 or not flat8.flags.c_contiguous or
            (B and int((offs64 + np.maximum(lens - 1, 0)).max()) >
             flat8.shape[0])):
        raise ValueError("pack_delta8_batch: flat8 must be a C-contiguous "
                         "int8 buffer holding every read's deltas")
    firsts = np.zeros(B, np.int16)
    ptrs = (ctypes.c_void_p * B)(*(a.ctypes.data for a in raws))
    # room for an escape in eight samples, so that one pass does (raw DAC
    # signals escape in ~3% of positions); more escapes take a second pass
    exc_cap = max(4096, int(lens.sum()) // 8)
    while True:
        exc_read = np.empty(exc_cap, np.int32)
        exc_pos = np.empty(exc_cap, np.int32)
        exc_res = np.empty(exc_cap, np.int32)
        n_exc = np.zeros(1, np.int64)
        lib.pack_delta8_batch(
            ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
            _as_c(lens, ctypes.c_int64), B,
            _as_c(offs64, ctypes.c_int64), _as_c(flat8, ctypes.c_int8),
            _as_c(firsts, ctypes.c_int16), _as_c(exc_read, ctypes.c_int32),
            _as_c(exc_pos, ctypes.c_int32), _as_c(exc_res, ctypes.c_int32),
            exc_cap, _as_c(n_exc, ctypes.c_int64), n_threads)
        total = int(n_exc[0])
        if total <= exc_cap:
            return (firsts, exc_read[:total], exc_pos[:total],
                    exc_res[:total])
        exc_cap = int(total + 64)


def theil_sen_batch(ev: np.ndarray, mod: np.ndarray, n_points: np.ndarray,
                    max_slope: float = 1000.0, n_threads: int = 0,
                    use_f32: bool = False, use_fast: bool = False):
    """Batched Theil-Sen (median pair slope, then median intercept) over
    padded (B, max_n) float64 arrays.  Returns (slopes (B,), intercepts
    (B,)).  ``use_f32`` takes the float32 pair buffer (about 1e-7
    relative slope error); ``use_fast`` the expected-O(n log n) exact
    slope selection (interval narrowing and inversion counting), the same
    median in float64 comparisons."""
    ev = np.ascontiguousarray(ev, np.float64)
    mod = np.ascontiguousarray(mod, np.float64)
    n_points = np.ascontiguousarray(n_points, np.int64)
    B, max_n = ev.shape
    slopes = np.zeros(B)
    inters = np.zeros(B)
    lib = get_native_lib()
    fn = (lib.theil_sen_batch_fast if use_fast
          else lib.theil_sen_batch32 if use_f32 else lib.theil_sen_batch)
    fn(_as_c(ev, ctypes.c_double), _as_c(mod, ctypes.c_double), B, max_n,
       _as_c(n_points, ctypes.c_int64), max_slope,
       _as_c(slopes, ctypes.c_double), _as_c(inters, ctypes.c_double),
       n_threads)
    return slopes, inters


# csrc/resquiggle_baseline.cpp's return codes, as the JAX package words
# them (the pipeline's failure messages where one corresponds)
_BASELINE_ERRORS = {
    1: "Too much raw signal for mapped sequence",
    2: "Fewer changepoints than requested",
    3: "Read too short for start discovery",
    4: "Poor raw to expected signal matching at read start",
    5: "Very poor signal quality. Read likely includes open pore.",
    6: "Raw signal does not seem to correspond to the sequence from mapping.",
    7: "Traceback determined path outside band boundaries",
    8: "Read contains too many potential genomic deletions",
    9: "Invalid events found after deletion fix",
    10: "Read failed sequence-based signal re-scaling parameter estimation.",
    11: "Masked start plan failure",
}


def resquiggle_read_baseline(raw_signal: np.ndarray, ref_means: np.ndarray,
                             ref_sds: np.ndarray, params,
                             outlier_thresh: float, sig_match_thresh: float,
                             max_scaling_iters: int = 3, stall_ints=None):
    """Single-core end-to-end re-squiggle of one read in C++
    (csrc/resquiggle_baseline.cpp), the CPU baseline a benchmark divides
    by, on the reference's compiled hot path (reference:
    tombo/_c_dynamic_programming.pyx:202-412).  ``params`` is a
    ResquiggleParams; its ``use_t_test_seg`` takes the RNA lane (t-test
    segmentation, removal of the changepoints inside ``stall_ints``,
    event-based scale).

    Returns (segs int64 (seq_len + 1,), read_start_rel_to_raw, (shift,
    scale, lower, upper), sig_match_score); raises :class:`TomboError` on
    a failed read."""
    lib = get_native_lib()
    raw_signal = np.ascontiguousarray(raw_signal, np.float64)
    ref_means = np.ascontiguousarray(ref_means, np.float64)
    ref_sds = np.ascontiguousarray(ref_sds, np.float64)
    seq_len = ref_means.shape[0]
    iparams = np.array([
        params.bandwidth, params.start_bw, params.start_save_bw,
        params.start_n_bases, params.running_stat_width,
        params.min_obs_per_base, params.mean_obs_per_event,
        params.raw_min_obs_per_base, params.band_bound_thresh,
        config.MASK_BASES, config.DEL_FIX_WINDOW, config.MAX_DEL_FIX_WINDOW,
        config.MAX_RAW_CPTS, max_scaling_iters,
        config.MAX_POINTS_FOR_THEIL_SEN], dtype=np.int64)
    dparams = np.array([
        params.z_shift, params.skip_pen, params.stay_pen,
        -1.0 if params.max_half_z_score is None else params.max_half_z_score,
        outlier_thresh, sig_match_thresh, config.MASK_FILL_Z_SCORE,
        config.MIN_EVENT_TO_SEQ_RATIO, config.EXTRA_SIG_FACTOR,
        config.SHIFT_CHANGE_THRESH, config.SCALE_CHANGE_THRESH],
        dtype=np.float64)
    segs = np.zeros(seq_len + 1, dtype=np.int64)
    rsrtr = np.zeros(1, dtype=np.int64)
    scale = np.zeros(4, dtype=np.float64)
    score = np.zeros(1, dtype=np.float64)
    c = _as_c
    if params.use_t_test_seg:
        ints = stall_ints or []
        stall_s = np.ascontiguousarray([s for s, _ in ints], np.int64)
        stall_e = np.ascontiguousarray([e for _, e in ints], np.int64)
        code = lib.resquiggle_read_baseline_rna(
            c(raw_signal, ctypes.c_double), raw_signal.shape[0],
            c(ref_means, ctypes.c_double), c(ref_sds, ctypes.c_double),
            seq_len, c(stall_s, ctypes.c_int64), c(stall_e, ctypes.c_int64),
            len(ints), c(iparams, ctypes.c_int64),
            c(dparams, ctypes.c_double), c(segs, ctypes.c_int64),
            c(rsrtr, ctypes.c_int64), c(scale, ctypes.c_double),
            c(score, ctypes.c_double))
    else:
        code = lib.resquiggle_read_baseline(
            c(raw_signal, ctypes.c_double), raw_signal.shape[0],
            c(ref_means, ctypes.c_double), c(ref_sds, ctypes.c_double),
            seq_len, c(iparams, ctypes.c_int64),
            c(dparams, ctypes.c_double), c(segs, ctypes.c_int64),
            c(rsrtr, ctypes.c_int64), c(scale, ctypes.c_double),
            c(score, ctypes.c_double))
    if code != 0:
        raise TomboError(_BASELINE_ERRORS.get(code,
                                              "baseline failure %d" % code))
    return (segs, int(rsrtr[0]),
            (float(scale[0]), float(scale[1]), float(scale[2]),
             float(scale[3])), float(score[0]))


def resquiggle_read_baseline_with_retries(
        raw_signal, ref_means, ref_sds, params, save_params,
        outlier_thresh, sig_match_thresh, max_scaling_iters: int = 3,
        stall_ints=None):
    """The baseline with the save-bandwidth retry (reference:
    tombo/resquiggle.py:1586-1588): a failed read runs once more with the
    save parameters."""
    try:
        return resquiggle_read_baseline(
            raw_signal, ref_means, ref_sds, params, outlier_thresh,
            sig_match_thresh, max_scaling_iters, stall_ints=stall_ints)
    except TomboError:
        return resquiggle_read_baseline(
            raw_signal, ref_means, ref_sds, save_params, outlier_thresh,
            sig_match_thresh, max_scaling_iters, stall_ints=stall_ints)


def static_base_assignment(event_means: np.ndarray, ref_means: np.ndarray,
                           ref_sds: np.ndarray, z_shift: float,
                           skip_pen: float, stay_pen: float,
                           max_half_z_score) -> np.ndarray:
    """Short-read static-band base assignment in one call: band plan,
    winsorized z-scores, static DP and traceback (reference:
    tombo/resquiggle.py:547-600).  Returns the (seq_len + 1,) event
    positions of the bases."""
    ev = np.ascontiguousarray(event_means, np.float64)
    rm = np.ascontiguousarray(ref_means, np.float64)
    rs = np.ascontiguousarray(ref_sds, np.float64)
    seq_len = rm.shape[0]
    out = np.empty(seq_len + 1, np.int64)
    rc = get_native_lib().static_base_assignment(
        _as_c(ev, ctypes.c_double), ev.shape[0],
        _as_c(rm, ctypes.c_double), _as_c(rs, ctypes.c_double), seq_len,
        float(z_shift), float(skip_pen), float(stay_pen),
        int(max_half_z_score is not None),
        float(max_half_z_score if max_half_z_score is not None else -1.0),
        _as_c(out, ctypes.c_int64))
    if rc != 0:
        raise TomboError("native static band failed (code %d)" % rc)
    return out


# del_fix_batch's status codes -> the reference's error strings
# (tombo/resquiggle.py:402-540 resolve_skipped_bases_with_raw)
DEL_FIX_ERRORS = {
    2: "Not enough raw signal around potential genomic deletion(s)",
    3: "Read contains too many potential genomic deletions",
    4: "Raw-signal traceback failed to find boundary",
    5: "New segments include zero length events",
    6: "New segments start with negative index",
    7: "New segments end past raw signal values",
}

# finalize_batch's status of a read whose Theil-Sen slope is 0
FIT_FAILED_STATUS = 100


def _del_fix_config():
    return (config.DEL_FIX_WINDOW, config.MAX_DEL_FIX_WINDOW,
            config.EXTRA_SIG_FACTOR,
            -1 if config.MAX_RAW_CPTS is None else config.MAX_RAW_CPTS)


def finalize_batch(jobs, params, ts_mode: int, max_slope: float = 1000.0,
                   n_threads: int = 0):
    """Fused finalize of a batch of reads in one threaded call: normalize
    the mapped raw slice, fix deletions where flagged, per-base event
    means, Theil-Sen fit and its correction (the double operations of the
    host lane).

    ``jobs``: list of (raw_slice f64[S], shift, scale, lower, upper,
    ref_means f64[L], ref_sds f64[L], segs i64[L+1], has_del int,
    ts_samp i32[k] or None).  ``ts_mode``: -1 no fit, 0 exact float64,
    1 float32 pair buffer, 2 fast selection.  Returns (segs_list, ev_list
    (per-base means before the correction), norm_list (corrected
    normalized slices), slopes, inters, status): status 0, a
    :data:`DEL_FIX_ERRORS` code or :data:`FIT_FAILED_STATUS`."""
    lib = get_native_lib()
    if not jobs:
        return [], [], [], np.zeros(0), np.zeros(0), np.zeros(0, np.int32)
    R = len(jobs)
    raw_off = np.zeros(R + 1, np.int64)
    lvl_off = np.zeros(R + 1, np.int64)
    segs_off = np.zeros(R + 1, np.int64)
    samp_off = np.zeros(R + 1, np.int64)
    for r, j in enumerate(jobs):
        raw_off[r + 1] = raw_off[r] + j[0].shape[0]
        lvl_off[r + 1] = lvl_off[r] + j[5].shape[0]
        segs_off[r + 1] = segs_off[r] + j[7].shape[0]
        samp_off[r + 1] = samp_off[r] + (0 if j[9] is None
                                         else j[9].shape[0])
    cat = lambda k, dt: np.concatenate([np.ascontiguousarray(j[k], dt)
                                        for j in jobs])
    raw_c, means_c = cat(0, np.float64), cat(5, np.float64)
    sds_c, segs_c = cat(6, np.float64), cat(7, np.int64)
    shift = np.array([j[1] for j in jobs], np.float64)
    scale = np.array([j[2] for j in jobs], np.float64)
    lower = np.array([np.nan if j[3] is None else j[3] for j in jobs])
    upper = np.array([np.nan if j[4] is None else j[4] for j in jobs])
    has_del = np.array([j[8] for j in jobs], np.int32)
    if samp_off[-1] > 0:
        ts_samp = np.concatenate([np.ascontiguousarray(j[9], np.int32)
                                  for j in jobs if j[9] is not None])
    else:
        ts_samp = np.zeros(1, np.int32)
    norm_out = np.empty(int(raw_off[-1]), np.float64)
    ev_out = np.empty(int(lvl_off[-1]), np.float64)
    slopes = np.zeros(R, np.float64)
    inters = np.zeros(R, np.float64)
    status = np.zeros(R, np.int32)
    mhz = params.max_half_z_score
    c, d, q = _as_c, ctypes.c_double, ctypes.c_int64
    lib.finalize_batch(
        c(raw_c, d), c(raw_off, q), c(shift, d), c(scale, d), c(lower, d),
        c(upper, d), c(means_c, d), c(sds_c, d), c(lvl_off, q),
        c(segs_c, q), c(segs_off, q), c(has_del, ctypes.c_int32),
        c(ts_samp, ctypes.c_int32), c(samp_off, q), R,
        params.raw_min_obs_per_base, 0 if mhz is None else 1,
        0.0 if mhz is None else float(mhz), *_del_fix_config(),
        float(max_slope), int(ts_mode), c(norm_out, d), c(ev_out, d),
        c(slopes, d), c(inters, d), c(status, ctypes.c_int32), n_threads)
    segs_list = [segs_c[segs_off[r]:segs_off[r + 1]] for r in range(R)]
    ev_list = [ev_out[lvl_off[r]:lvl_off[r + 1]] for r in range(R)]
    norm_list = [norm_out[raw_off[r]:raw_off[r + 1]] for r in range(R)]
    return segs_list, ev_list, norm_list, slopes, inters, status


def del_fix_batch(jobs, params, n_threads: int = 0):
    """The whole deletion fix (window planning, raw-signal DP, scatter and
    checks) for a batch of reads in one threaded call.

    ``jobs``: list of (norm_signal f64[S], ref_means f64[L], ref_sds
    f64[L], segs i64[L+1]).  Returns (segs_list, status (R,) int32), the
    status 0 or a :data:`DEL_FIX_ERRORS` code."""
    lib = get_native_lib()
    if not jobs:
        return [], np.zeros(0, np.int32)
    R = len(jobs)
    norm_off = np.zeros(R + 1, np.int64)
    lvl_off = np.zeros(R + 1, np.int64)
    segs_off = np.zeros(R + 1, np.int64)
    for r, (norm, means, _, segs) in enumerate(jobs):
        norm_off[r + 1] = norm_off[r] + norm.shape[0]
        lvl_off[r + 1] = lvl_off[r] + means.shape[0]
        segs_off[r + 1] = segs_off[r] + segs.shape[0]
    cat = lambda k, dt: np.concatenate([np.ascontiguousarray(j[k], dt)
                                        for j in jobs])
    norm_c, means_c = cat(0, np.float64), cat(1, np.float64)
    sds_c, segs_c = cat(2, np.float64), cat(3, np.int64)
    status = np.zeros(R, np.int32)
    mhz = params.max_half_z_score
    c, d, q = _as_c, ctypes.c_double, ctypes.c_int64
    lib.del_fix_batch(
        c(norm_c, d), c(norm_off, q), c(means_c, d), c(sds_c, d),
        c(lvl_off, q), c(segs_c, q), c(segs_off, q), R,
        params.raw_min_obs_per_base, 0 if mhz is None else 1,
        0.0 if mhz is None else float(mhz), *_del_fix_config(),
        c(status, ctypes.c_int32), n_threads)
    return [segs_c[segs_off[r]:segs_off[r + 1]] for r in range(R)], status


def raw_windows_dp_batch(windows, min_obs_per_base: int, max_half_z_score,
                         n_threads: int = 0):
    """Batched raw-signal deletion-window DP (threaded).

    ``windows``: list of (sig f64[S], means f64[N], sds f64[N],
    pseudo_starts i64[N+1]).  Returns (segs_list, status (W,) int32):
    segs_list[w] holds the N - 1 boundaries found, relative to the
    window's signal; status 1 where the traceback found no boundary."""
    if not windows:
        return [], np.zeros(0, np.int32)
    lib = get_native_lib()
    W = len(windows)
    sig_off = np.zeros(W + 1, np.int64)
    ev_off = np.zeros(W + 1, np.int64)
    ps_off = np.zeros(W + 1, np.int64)
    out_off = np.zeros(W + 1, np.int64)
    for w, (sig, means, _, ps) in enumerate(windows):
        sig_off[w + 1] = sig_off[w] + sig.shape[0]
        ev_off[w + 1] = ev_off[w] + means.shape[0]
        ps_off[w + 1] = ps_off[w] + ps.shape[0]
        out_off[w + 1] = out_off[w] + means.shape[0] - 1
    cat = lambda k, dt: np.concatenate([np.ascontiguousarray(w[k], dt)
                                        for w in windows])
    sig_c, means_c = cat(0, np.float64), cat(1, np.float64)
    sds_c, ps_c = cat(2, np.float64), cat(3, np.int64)
    out = np.zeros(int(out_off[-1]), np.int64)
    status = np.zeros(W, np.int32)
    winsorize = 0 if max_half_z_score is None else 1
    mhz = 0.0 if max_half_z_score is None else float(max_half_z_score)
    c, d, q = _as_c, ctypes.c_double, ctypes.c_int64
    lib.raw_windows_dp_batch(
        c(sig_c, d), c(sig_off, q), c(means_c, d), c(sds_c, d), c(ev_off, q),
        c(ps_c, q), c(ps_off, q), W, min_obs_per_base, winsorize, mhz,
        c(out, q), c(out_off, q), c(status, ctypes.c_int32), n_threads)
    return [out[out_off[w]:out_off[w + 1]] for w in range(W)], status
