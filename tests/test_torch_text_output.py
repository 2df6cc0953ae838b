"""Text output of the port (``output/text.py``) against the JAX package's
(``tombo_tpu/output/text.py``) on the same index and statistics files.

A dataset written by the JAX runner with event SDs (24 reads of 500
bases on a 2,000-base reference, both strands), split into a sample and
a control, gives a de novo statistics file (a model statistics file) and
a KS file (a level statistics file), both written by the JAX package.
Each package writes the browser files of one case into its own
directory: the directories hold the same file names, and every file is
byte-equal.  The FASTA of the most significant regions is byte-equal for
both files, and the errors for the types a file does not allow carry the
JAX package's messages."""
import os

import pytest

from tombo_tpu import config as j_config
from tombo_tpu.errors import TomboTpuError
from tombo_tpu.io.fasta import Fasta as JFasta
from tombo_tpu.io.index import ReadsIndex as JReadsIndex
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.output import text as j_txt
from tombo_tpu.pipeline.aligner import ExactAligner as JExactAligner
from tombo_tpu.pipeline.runner import RunConfig, resquiggle_all_reads
from tombo_tpu.stats import detect as j_dt
from tombo_tpu.testing import make_synthetic_dataset
from tombo_tpu.types import SeqSampleType as JSeqSampleType
from tombo_tpu_torch.errors import TomboError
from tombo_tpu_torch.io.fasta import Fasta as TFasta
from tombo_tpu_torch.io.index import ReadsIndex as TReadsIndex
from tombo_tpu_torch.output import text as t_txt

MODEL_TYPES = ["fraction", "dampened_fraction", "valid_coverage",
               "coverage", "signal", "signal_sd", "dwell", "difference"]
MOTIFS = ["CG:1:CpG", "GATC:2:dam"]


def _split(cls, fast5_dir):
    """(whole index, sample: even reads, control: odd reads)."""
    full = cls([fast5_dir])
    samp, ctrl = cls(), cls()
    for (chrm, strand), reads in full.reads_index.items():
        for i, r in enumerate(sorted(reads, key=lambda r: r.read_id)):
            (samp, ctrl)[i % 2].add_read_data(chrm, strand, r)
    return full, samp, ctrl


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("text_out"))
    fasta, _, fast5_dir = make_synthetic_dataset(
        tmp, n_reads=24, seed=17, read_len=500, ref_len=2000)
    model = JKmerModel.load_default(j_config.DNA_SAMP_TYPE)
    summary, _ = resquiggle_all_reads(
        fast5_dir, JExactAligner(fasta), model,
        JSeqSampleType(j_config.DNA_SAMP_TYPE, False),
        j_config.load_resquiggle_parameters(j_config.DNA_SAMP_TYPE),
        RunConfig(overwrite=True, batch_size=8, num_io_threads=2,
                  compute_sd=True))
    assert summary.n_success == 24
    full, samp, ctrl = _split(JReadsIndex, fast5_dir)
    th = j_config.DE_NOVO_THRESH["DNA"]
    model_fn = os.path.join(tmp, "de_novo.tombo.stats")
    j_dt.test_significance(full, j_dt.TestParams(
        stat_type="de_novo", lower_thresh=th[0], single_read_thresh=th[1],
        region_size=1000, num_most_signif=500), model_fn, fasta=fasta,
        std_ref=model, num_processes=2)
    level_fn = os.path.join(tmp, "ks.tombo.stats")
    j_dt.test_significance(samp, j_dt.TestParams(
        stat_type="ks", region_size=1000, min_test_reads=3,
        num_most_signif=500), level_fn, ctrl_reads_index=ctrl,
        num_processes=2)
    ref_fn = os.path.join(tmp, "reference.fasta")
    return dict(tmp=tmp, fast5_dir=fast5_dir, model_fn=model_fn,
                level_fn=level_fn, j_fasta=JFasta(ref_fn),
                t_fasta=TFasta.read(ref_fn))


def _indexes(ds, pkg, with_ctrl):
    full, samp, ctrl = _split(JReadsIndex if pkg == "j" else TReadsIndex,
                              ds["fast5_dir"])
    return (samp, ctrl) if with_ctrl else (full, None)


def _tree(d):
    out = {}
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn), "rb") as fp:
            out[fn] = fp.read()
    return out


# name -> (statistics file, types, control, motif descriptions)
CASES = {
    "model_with_control": ("model_fn", MODEL_TYPES, True, None),
    "model_with_motifs": ("model_fn", ["fraction", "dampened_fraction",
                                       "valid_coverage"], False, MOTIFS),
    "model_without_control": ("model_fn", ["coverage", "signal", "dwell",
                                           "fraction"], False, None),
    "level_statistic": ("level_fn", ["statistic", "coverage"], True, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_browser_files_byte_equal(ds, tmp_path, monkeypatch, case):
    """The track names carry the basename, so each package writes with
    the same relative basename, as the command line does."""
    stats_key, types, with_ctrl, motifs = CASES[case]
    trees = []
    for pkg, mod, fasta in (("j", j_txt, ds["j_fasta"]),
                            ("t", t_txt, ds["t_fasta"])):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        idx, ctrl = _indexes(ds, pkg, with_ctrl)
        mod.write_all_browser_files(idx, ctrl, ds[stats_key],
                                    "tombo_results", types,
                                    motif_descs=motifs, fasta=fasta)
        trees.append(_tree(str(d)))
    want, got = trees
    assert sorted(got) == sorted(want)
    assert len(want) >= 2 * len(types)
    for fn, data in want.items():
        assert got[fn] == data, fn
    # every type wrote data lines, on one strand at least
    for t in types:
        name = {"fraction": "fraction_modified_reads",
                "dampened_fraction": "dampened_fraction_modified_reads"
                }.get(t, t)
        assert sum(d.count(b"\n") for fn, d in want.items()
                   if fn.startswith("tombo_results." + name + ".")) > 10, t


@pytest.mark.parametrize("stats_key", ["model_fn", "level_fn"])
def test_signif_sequence_context_byte_equal(ds, tmp_path, stats_key):
    fns = []
    for pkg, mod, fasta in (("j", j_txt, ds["j_fasta"]),
                            ("t", t_txt, ds["t_fasta"])):
        fn = str(tmp_path / (pkg + ".fasta"))
        mod.write_most_signif(ds[stats_key], fn, 20, 21, fasta)
        fns.append(fn)
    with open(fns[0], "rb") as a, open(fns[1], "rb") as b:
        want, got = a.read(), b.read()
    assert want.count(b">") >= 5 and got == want


@pytest.mark.parametrize("stats_key,types", [
    ("level_fn", ["fraction"]), ("level_fn", ["valid_coverage"]),
    ("model_fn", ["statistic"])])
def test_disallowed_types_raise_the_jax_message(ds, tmp_path, stats_key,
                                                types):
    with pytest.raises(TomboTpuError) as j_err:
        j_txt.write_all_browser_files(None, None, ds[stats_key],
                                      str(tmp_path / "j"), types)
    with pytest.raises(TomboError) as t_err:
        t_txt.write_all_browser_files(None, None, ds[stats_key],
                                      str(tmp_path / "t"), types)
    assert str(t_err.value) == str(j_err.value)


def test_bad_motif_descriptions_raise_the_jax_message(ds, tmp_path):
    for bad in (["CG:x:CpG"], ["CG:1"], ["QQ:1:q"]):
        with pytest.raises(TomboTpuError) as j_err:
            j_txt.write_all_browser_files(
                None, None, ds["model_fn"], str(tmp_path / "j"),
                ["fraction"], motif_descs=bad, fasta=ds["j_fasta"])
        with pytest.raises(TomboError) as t_err:
            t_txt.write_all_browser_files(
                None, None, ds["model_fn"], str(tmp_path / "t"),
                ["fraction"], motif_descs=bad, fasta=ds["t_fasta"])
        assert str(t_err.value) == str(j_err.value)
