"""The one-read path's DP debug dump (``tombo_tpu_torch/pipeline/
resquiggle.py``, ``debug_dp_dir=``) on the CPU against the JAX package's
(``tombo_tpu/pipeline/resquiggle.py::_dump_dp_debug``, switched on by its
environment variable for the JAX call alone), on reads of
tests/test_torch_resquiggle_read.py's recipe: 1 kb DNA reads, one of them
forced onto the chunked layout, an RNA read with a stall and a short read
that takes the static band.

At float64 every entry of the port's ``.npz`` equals the JAX package's
bit for bit, with the same name, dtype and shape; the chunked read's
file equals its fused file; a static-band read writes none, and no call
without the keyword writes one; the results are bitwise those of the
same call without the dump.  Also the ``rows=True`` outputs of the DP
wrappers' plain versions: the fused and chunked rows bitwise equal, the
usual outputs unchanged, rows past a read's length zero."""
import os

import numpy as np
import pytest
import torch

from tombo_tpu import config as j_config
from tombo_tpu.errors import TomboTpuError
from tombo_tpu.pipeline import resquiggle as j_rsq
from tombo_tpu_torch import kernels
from tombo_tpu_torch.errors import TomboError
from tombo_tpu_torch.ops import banded_dp
from tombo_tpu_torch.ops import dp as t_dp
from tombo_tpu_torch.pipeline import resquiggle as t_rsq

from test_torch_dp import _mk_case, _params
from test_torch_resquiggle_read import (CASES, _assert_bitwise, _case_read,
                                        _port_inputs)

KEYS = ("fwd_pass", "fwd_pass_tb", "band_event_starts", "read_tb",
        "event_means", "ref_means", "ref_sds", "events_start_clip",
        "lower_margin", "upper_margin", "bandwidth")


def _jax_dump(name, out_dir, monkeypatch, retries):
    model, params, sst, mr = _case_read(name)
    monkeypatch.setenv("TOMBO_TPU_DEBUG_DP", str(out_dir))
    try:
        if retries:
            return j_rsq.resquiggle_read_with_retries(
                mr, model, params, j_config.load_resquiggle_parameters(
                    CASES[name][0], use_save_bandwidth=True),
                outlier_thresh=j_config.OUTLIER_THRESH, seq_samp_type=sst)
        return j_rsq.resquiggle_read(
            mr, model, params, outlier_thresh=j_config.OUTLIER_THRESH,
            seq_samp_type=sst)
    except TomboTpuError as e:
        return str(e)
    finally:
        monkeypatch.delenv("TOMBO_TPU_DEBUG_DP")


def _port_dump(name, out_dir, retries, **kw):
    t_model, t_params, t_save, t_sst, t_mr = _port_inputs(name)
    try:
        if retries:
            res = t_rsq.resquiggle_read_with_retries(
                t_mr, t_model, t_params, t_save,
                outlier_thresh=j_config.OUTLIER_THRESH, seq_samp_type=t_sst,
                device="cpu", dtype=torch.float64, **kw)
        else:
            res = t_rsq.resquiggle_read(
                t_mr, t_model, t_params,
                outlier_thresh=j_config.OUTLIER_THRESH, seq_samp_type=t_sst,
                device="cpu", dtype=torch.float64, **kw)
        return res, None
    except TomboError as e:
        return None, str(e)


def _files(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _assert_same_npz(a, b):
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files) == sorted(KEYS)
        for k in KEYS:
            x, y = fa[k], fb[k]
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("name,retries", [
    ("dna_1kb", True), ("deletions", False), ("theil_sen_subsample", False),
    ("rna_stall", False)])
def test_dump_equals_jax_f64(name, retries, tmp_path, monkeypatch):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    j_out = _jax_dump(name, jdir, monkeypatch, retries)
    assert not isinstance(j_out, str), j_out
    launches = dict(kernels.LAUNCHES)
    t = _port_dump(name, str(tdir), retries, debug_dp_dir=str(tdir))
    assert kernels.LAUNCHES == launches
    fn = "dp_debug.p_%s.npz" % name
    assert _files(jdir) == _files(tdir) == [fn]
    _assert_same_npz(jdir / fn, tdir / fn)
    with np.load(tdir / fn) as f:
        L = f["ref_means"].shape[0]
        bw = int(f["bandwidth"])
        assert f["fwd_pass"].shape == (L + 1, bw)
        assert f["read_tb"].shape == (L + 1,)
        assert (f["lower_margin"] >= 0).all() and \
            (f["upper_margin"] >= 0).all()
    # the dump changes no result
    _assert_bitwise(_port_dump(name, None, retries), t)


def test_chunked_dump_equals_fused_and_jax(tmp_path, monkeypatch):
    name = "dna_1kb"
    jdir, fdir, cdir = (tmp_path / d for d in ("jax", "fused", "chunked"))
    assert not isinstance(_jax_dump(name, jdir, monkeypatch, False), str)
    fused = _port_dump(name, None, False, debug_dp_dir=str(fdir))
    calls = []
    chunked = banded_dp.adaptive_banded_dp_tb_chunked

    def spy(*a, **kw):
        calls.append(kw)
        return chunked(*a, **kw)
    monkeypatch.setattr(banded_dp, "PER_READ_MOVE_CAP", 300 * 300)
    monkeypatch.setattr(banded_dp, "adaptive_banded_dp_tb_chunked", spy)
    got = _port_dump(name, None, False, debug_dp_dir=str(cdir))
    assert calls and all(kw["rows"] for kw in calls)
    _assert_bitwise(fused, got)
    fn = "dp_debug.p_%s.npz" % name
    _assert_same_npz(fdir / fn, cdir / fn)
    _assert_same_npz(jdir / fn, cdir / fn)


def test_no_dump_for_static_band_or_without_keyword(tmp_path, monkeypatch):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    _jax_dump("static_band", jdir, monkeypatch, False)
    t = _port_dump("static_band", None, False, debug_dp_dir=str(tdir))
    assert t[0] is not None
    assert _files(jdir) == _files(tdir) == []

    def no_dump(*a, **kw):
        raise AssertionError("dump written without debug_dp_dir")
    rows = []
    k1 = banded_dp.adaptive_banded_dp_tb

    def spy(*a, **kw):
        rows.append(kw.get("rows", False))
        return k1(*a, **kw)
    monkeypatch.setattr(t_rsq, "_dump_dp_debug", no_dump)
    monkeypatch.setattr(banded_dp, "adaptive_banded_dp_tb", spy)
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    assert _port_dump("dna_1kb", None, True)[0] is not None
    # an empty directory is off, as an empty TOMBO_TPU_DEBUG_DP is
    assert _port_dump("dna_1kb", None, True, debug_dp_dir="")[0] is not None
    assert len(rows) >= 2 and not any(rows) and _files(cwd) == []


def test_failed_read_writes_no_dump(tmp_path, monkeypatch):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    assert isinstance(_jax_dump("failed", jdir, monkeypatch, False), str)
    t = _port_dump("failed", None, False, debug_dp_dir=str(tdir))
    assert t[0] is None
    assert _files(jdir) == _files(tdir) == []


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_rows_fused_equal_chunked(dtype):
    """The plain versions' ``rows=True`` outputs: the usual four outputs
    unchanged, the chunked recompute's rows bitwise the fused rows, a
    read's rows past its length zero, codes in {0, 1, 2}."""
    args, _ = _mk_case(7, B=6)
    args = [torch.tensor(a, dtype=dtype) if a.dtype == np.float32
            else torch.tensor(a) for a in args]
    p, L, P = _params(32, t_dp.DpParams), 128, 64
    plain = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 10)
    fused = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 10, rows=True)
    chunked = banded_dp.adaptive_banded_dp_tb_chunked(
        *args, p, L, P, 10, chunk_rows=16, rows=True)
    assert len(fused) == len(chunked) == 7
    for a, b in zip(plain, fused[:4]):
        assert torch.equal(a, b)
    for a, b in zip(fused, chunked):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rows, codes, starts = fused[4:]
    assert rows.shape == codes.shape == (6, L, 32) and rows.dtype == dtype
    assert starts.shape == (6, L) and starts.dtype == torch.int32
    assert codes.dtype == torch.int8 and int(codes.max()) <= 2
    seq_lens = args[4].long()
    past = torch.arange(L)[None, :] >= seq_lens[:, None]
    assert past.any()
    assert not rows[past].any() and not codes[past].any() and \
        not starts[past].any()
    # each read's last row is its final forward row
    for b in range(6):
        n = int(seq_lens[b])
        if 1 <= n <= L:
            assert torch.equal(rows[b, n - 1], fused[3][b])


def test_rows_instances_registered():
    assert {"banded_dp_rows", "banded_dp_chunked_tb_rows"} <= \
        set(kernels.KERNELS)
    assert kernels.LAUNCHES["banded_dp_rows"] >= 0
