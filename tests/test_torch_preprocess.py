"""The port's ``preprocess annotate_raw_with_fastqs`` path
(``tombo_tpu_torch/preprocess.py``) against the JAX package's
(``tombo_tpu/preprocess.py``): copies of the same raw FAST5 files
annotated from the same FASTQ files, found by reading each file's read
id and through a sequencing summary, in one process and in two spawned
writer processes.  The returned counts are equal and every written
basecall group is equal (the Fastq dataset's value, type and shape);
a read with no file, an existing slot without ``--overwrite``, a bad
FASTQ record, an incomplete one and a summary without its columns give
the JAX package's counts and messages."""
import os
import shutil

import h5py
import numpy as np
import pytest

from tombo_tpu import preprocess as j_pre
from tombo_tpu.errors import TomboTpuError
from tombo_tpu.testing import make_synthetic_dataset
from tombo_tpu_torch import preprocess as t_pre
from tombo_tpu_torch.errors import TomboError

BC_GRP, BC_SUB = "Basecall_1D_001", "BaseCalled_template"


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """12 simulated raw FAST5 files, two FASTQ files holding their
    records and one for a read with no file, and a sequencing summary
    that also lists a file that does not exist."""
    root = str(tmp_path_factory.mktemp("preprocess"))
    _, reads, fast5_dir = make_synthetic_dataset(
        root, n_reads=12, seed=9, read_len=300, ref_len=2000)
    rng = np.random.default_rng(9)
    fastqs = [os.path.join(root, "a.fastq"), os.path.join(root, "b.fastq")]
    with open(fastqs[0], "w") as a, open(fastqs[1], "w") as b:
        for i, r in enumerate(reads + [None]):
            rid = r.read_id if r is not None else "no_such_read"
            seq = r.seq if r is not None else "ACGT" * 10
            qual = "".join(chr(33 + int(q))
                           for q in rng.integers(2, 40, len(seq)))
            (a if i % 2 == 0 else b).write(
                "@%s runid=x ch=%d\n%s\n+\n%s\n" % (rid, i, seq, qual))
    summary = os.path.join(root, "sequencing_summary.txt")
    with open(summary, "w") as fp:
        fp.write("filename\tread_id\tsequence_length_template\n")
        for r in reads:
            fp.write("%s.fast5\t%s\t%d\n" % (r.read_id, r.read_id,
                                              len(r.seq)))
        fp.write("gone.fast5\tgone_read\t10\n")
    return dict(root=root, fast5_dir=fast5_dir, fastqs=fastqs,
                summary=summary, n=len(reads))


def _copies(raw, tmp_path):
    out = []
    for pkg in ("j", "t"):
        d = str(tmp_path / pkg)
        shutil.copytree(raw["fast5_dir"], d)
        out.append(d)
    return out


def _fastq_slots(d):
    out = {}
    for fn in sorted(os.listdir(d)):
        with h5py.File(os.path.join(d, fn), "r") as fp:
            ds = fp.get("Analyses/%s/%s/Fastq" % (BC_GRP, BC_SUB))
            if ds is not None:
                out[fn] = (ds[()], str(ds.dtype), ds.shape,
                           h5py.check_string_dtype(ds.dtype))
    return out


@pytest.mark.parametrize("summary,threads", [
    (False, 1), (True, 1), (False, 2), (True, 2)])
def test_annotation_matches_jax(raw, tmp_path, summary, threads):
    """The written groups and counts, then again without and with
    overwrite."""
    j_dir, t_dir = _copies(raw, tmp_path)
    summ = [raw["summary"]] if summary else None
    for overwrite in (False, False, True):
        counts = []
        for mod, d in ((j_pre, j_dir), (t_pre, t_dir)):
            counts.append(mod.annotate_reads_with_fastq(
                d, raw["fastqs"], summ, BC_GRP, BC_SUB, overwrite,
                num_threads=threads, min_parallel_records=1))
        assert counts[0] == counts[1]
        want, got = _fastq_slots(j_dir), _fastq_slots(t_dir)
        assert got == want and len(want) == raw["n"]
    # the last pass overwrote every file; the middle one wrote none
    assert counts[1] == (raw["n"], 1)


def _both_raise(tmp_path, raw, fastqs, summ=None):
    j_dir, t_dir = _copies(raw, tmp_path)
    with pytest.raises(TomboTpuError) as j_err:
        j_pre.annotate_reads_with_fastq(j_dir, fastqs, summ, BC_GRP, BC_SUB,
                                        num_threads=1)
    with pytest.raises(TomboError) as t_err:
        t_pre.annotate_reads_with_fastq(t_dir, fastqs, summ, BC_GRP, BC_SUB,
                                        num_threads=1)
    assert str(t_err.value) == str(j_err.value)
    return str(t_err.value)


@pytest.mark.parametrize("bad,message", [
    ("@r1\nACGT\n+\nIIII\n@r2\nACGT\n", "before incomplete record"),
    ("r1\nACGT\n+\nIIII\n", "Invalid FASTQ record"),
    ("@r1\nACGT\n-\nIIII\n", "Invalid FASTQ record")])
def test_bad_fastq_raises_the_jax_error(raw, tmp_path, bad, message):
    fn = str(tmp_path / "bad.fastq")
    with open(fn, "w") as fp:
        fp.write(bad)
    assert message in _both_raise(tmp_path, raw, [fn])


def test_summary_without_its_columns_raises_the_jax_error(raw, tmp_path):
    fn = str(tmp_path / "summary.txt")
    with open(fn, "w") as fp:
        fp.write("fname\tread_id\nx.fast5\tr1\n")
    assert "missing filename or read_id" in _both_raise(
        tmp_path, raw, raw["fastqs"], [fn])


def test_fastq_records_and_summary_parse_as_jax(raw):
    assert list(t_pre.iter_fastq_records(raw["fastqs"])) == \
        list(j_pre.iter_fastq_records(raw["fastqs"]))
    assert t_pre.parse_sequencing_summary([raw["summary"]]) == \
        j_pre.parse_sequencing_summary([raw["summary"]])
    assert t_pre.index_fast5s_by_read_id(raw["fast5_dir"], 2) == \
        j_pre.index_fast5s_by_read_id(raw["fast5_dir"], 2)
