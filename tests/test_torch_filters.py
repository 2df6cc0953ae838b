"""The port's index filters (``tombo_tpu_torch/filters.py``) against the
JAX package's (``tombo_tpu/filters.py``) on two copies of one dataset
written by the JAX runner (16 reads of 500 bases on a 3,000-base
reference).

Each case applies the same filters, in the same order, with each
package to its own copy (``level_coverage`` with generators of one
seed); the two indexes, loaded with their filtered reads, then hold the
same records (file names relative to the directory) with the same
``filtered`` flags, and each filter prints the same message.
``parse_genome_regions`` gives the JAX function's result and raises its
errors."""
import os
import re
import shutil

import numpy as np
import pytest

from tombo_tpu import config as j_config
from tombo_tpu import filters as j_filt
from tombo_tpu.io.index import ReadsIndex as JReadsIndex
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.pipeline.aligner import ExactAligner as JExactAligner
from tombo_tpu.pipeline.runner import RunConfig, resquiggle_all_reads
from tombo_tpu.testing import make_synthetic_dataset
from tombo_tpu.types import SeqSampleType as JSeqSampleType
from tombo_tpu_torch import filters as t_filt
from tombo_tpu_torch.errors import TomboError
from tombo_tpu_torch.io.index import ReadsIndex as TReadsIndex

CG = j_config.DEFAULT_CORRECTED_GROUP


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A directory holding the FAST5 directory ``fast5s`` and its index
    (the index file lies beside the FAST5 directory)."""
    root = str(tmp_path_factory.mktemp("filters"))
    fasta, _, fast5_dir = make_synthetic_dataset(
        root, n_reads=16, seed=41, read_len=500, ref_len=3000)
    summary, _ = resquiggle_all_reads(
        fast5_dir, JExactAligner(fasta),
        JKmerModel.load_default(j_config.DNA_SAMP_TYPE),
        JSeqSampleType(j_config.DNA_SAMP_TYPE, False),
        j_config.load_resquiggle_parameters(j_config.DNA_SAMP_TYPE),
        RunConfig(overwrite=True, batch_size=8, num_io_threads=2))
    assert summary.n_success == 16
    idx = JReadsIndex([fast5_dir])
    reads = list(idx.iter_reads())
    return dict(root=root, chrm=idx.get_all_cs()[0][0],
                sig=float(np.median([r.sig_match_score for r in reads])),
                n=len(reads))


def _copies(base, tmp_path):
    out = []
    for pkg in ("j", "t"):
        d = str(tmp_path / pkg)
        shutil.copytree(base["root"], d)
        out.append(os.path.join(d, "fast5s"))
    return out


def _records(fast5_dir):
    """Every record of the index, filtered ones too, in index order; file
    names relative to the directory."""
    idx = JReadsIndex([fast5_dir], CG, remove_filtered=False)
    return [(cs, os.path.relpath(r.fn, fast5_dir), r.start, r.end,
             r.filtered, r.read_id) for cs, reads in idx for r in reads]


def _cases(base):
    chrm = base["chrm"]
    regs = ["%s:0-1500" % chrm]
    return {
        "stuck": [("filter_reads_for_stuck", (CG, [(99, 20)]), {})],
        "level_coverage": [("filter_reads_for_coverage", (CG, 0.4),
                            {"rng": 7})],
        "q_score": [("filter_reads_for_qscore",
                     (j_config.DEFAULT_BASECALL_GROUP, CG, 2.5), {})],
        "raw_signal_matching": [("filter_reads_for_signal_matching",
                                 (CG, base["sig"]), {})],
        "genome_locations": [("filter_reads_for_genome_pos", (CG, regs),
                              {})],
        "genome_locations_partial": [("filter_reads_for_genome_pos",
                                      (CG, regs), {"include_partial": True})],
        "clear_filters": [("filter_reads_for_stuck", (CG, [(50, 0)]), {}),
                          ("clear_filters", (CG,), {})],
        "chained": [("filter_reads_for_signal_matching", (CG, base["sig"]),
                     {}),
                    ("filter_reads_for_genome_pos", (CG, [chrm]), {}),
                    ("filter_reads_for_qscore",
                     (j_config.DEFAULT_BASECALL_GROUP, CG, 1.5), {}),
                    ("filter_reads_for_coverage", (CG, 0.3), {"rng": 3})],
    }


@pytest.mark.parametrize("case", [
    "stuck", "level_coverage", "q_score", "raw_signal_matching",
    "genome_locations", "genome_locations_partial", "clear_filters",
    "chained"])
def test_filters_match_jax(base, tmp_path, capsys, case):
    j_dir, t_dir = _copies(base, tmp_path)
    for name, args, kw in _cases(base)[case]:
        msgs = []
        for mod, d in ((j_filt, j_dir), (t_filt, t_dir)):
            kw_pkg = dict(kw)
            if "rng" in kw:
                kw_pkg["rng"] = np.random.default_rng(kw["rng"])
            a = args
            if name == "filter_reads_for_genome_pos":
                a = (args[0], mod.parse_genome_regions(args[1]))
            getattr(mod, name)(d, *a, **kw_pkg)
            msgs.append(capsys.readouterr().out.replace(d, "<dir>"))
        assert msgs[0] == msgs[1]
    want, got = _records(j_dir), _records(t_dir)
    assert got == want and len(want) == base["n"]
    # the port reads the index the same, with and without filtered reads
    for remove in (False, True):
        t_idx = TReadsIndex([t_dir], CG, remove_filtered=remove)
        assert sum(len(v) for _, v in t_idx) == sum(
            1 for r in want if not (remove and r[4]))
    # the simulated reads' mean q-score is 2 (every read fails 2.5)
    n_filt = sum(r[4] for r in want)
    if case == "clear_filters":
        assert n_filt == 0
    elif case == "q_score":
        assert n_filt == len(want)
    else:
        assert 0 < n_filt < len(want), case


def test_filter_of_an_all_filtered_index_raises_the_jax_error(base,
                                                               tmp_path):
    j_dir, t_dir = _copies(base, tmp_path)
    for mod, d in ((j_filt, j_dir), (t_filt, t_dir)):
        mod.filter_reads_for_stuck(d, CG, [(50, 0)], quiet=True)
    with pytest.raises(Exception) as j_err:
        j_filt.filter_reads_for_signal_matching(j_dir, CG, 1e9, quiet=True)
    with pytest.raises(TomboError) as t_err:
        t_filt.filter_reads_for_signal_matching(t_dir, CG, 1e9, quiet=True)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("regs", [
    ["chr1"], ["chr1", "chr1:5-10"], ["chr2:1-100", "chr2:200-300"],
    ["chr3:1,000-2,000", "chr4"], ["chr5:10-20", "chr5"], []])
def test_parse_genome_regions_matches_jax(regs):
    assert t_filt.parse_genome_regions(regs) == \
        j_filt.parse_genome_regions(regs)


@pytest.mark.parametrize("reg", ["chr1:abc", "chr1:1-2-3", "a:b:c",
                                 "chr1:5"])
def test_parse_genome_regions_errors_match_jax(reg):
    with pytest.raises(Exception) as j_err:
        j_filt.parse_genome_regions([reg])
    with pytest.raises(Exception) as t_err:
        t_filt.parse_genome_regions([reg])
    assert type(t_err.value) is type(j_err.value)
    assert str(t_err.value) == str(j_err.value)


def test_parse_obs_filter_matches_jax():
    assert t_filt.parse_obs_filter(["99:200", "100:5000"]) == \
        j_filt.parse_obs_filter(["99:200", "100:5000"])
    for bad in (["99"], ["a:b"]):
        with pytest.raises(TomboError, match=re.escape(
                "Invalid format for observation filter")):
            t_filt.parse_obs_filter(bad)
