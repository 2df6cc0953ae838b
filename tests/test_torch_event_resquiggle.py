"""The port's legacy event re-squiggle (``build_model event_resquiggle``)
held against the JAX package's bit for bit at float64, on copies of the
same FAST5 files: the corrected group's ``Events`` (start, length, base,
norm_mean, norm_stdev), its attributes and Alignment attributes, and the
failure counts by message.  Alignments come from the in-process aligners
(exact, and the native minimizer engine on basecalls with indels, which
drives the indel-group re-segmentation), SAM files with and without soft
clips, M5 files and an external aligner run as a subprocess (a fake
mapper script); normalizations median, none, pA_raw and pA (with a pore
model TSV).  The normalization branches and the fitted shift and scale
are also held alone, and the three FAST5 writers of ``testing.py``."""
import os
import shutil
import stat
import sys
from dataclasses import replace

import h5py
import numpy as np
import pytest

from tombo_tpu import config as j_config
from tombo_tpu import testing as j_testing
from tombo_tpu.io.fasta import Fasta as JFasta
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.pipeline import aligner as j_aligner
from tombo_tpu.pipeline import event_resquiggle as j_er
from tombo_tpu.pipeline import resquiggle as j_rsq
from tombo_tpu.seq import rev_comp
from tombo_tpu.types import ChannelInfo as JChannelInfo
from tombo_tpu_torch import testing as t_testing
from tombo_tpu_torch.cli import main as t_cli
from tombo_tpu_torch.io import fast5 as t_f5
from tombo_tpu_torch.io.fasta import Fasta as TFasta
from tombo_tpu_torch.io.model_io import KmerModel as TKmerModel
from tombo_tpu_torch.pipeline import aligner as t_aligner
from tombo_tpu_torch.pipeline import event_resquiggle as t_er
from tombo_tpu_torch.pipeline import resquiggle as t_rsq
from tombo_tpu_torch.types import ChannelInfo as TChannelInfo

SUB = j_config.DEFAULT_BASECALL_SUBGROUP


def _with_indels(read, rng, n_edits):
    """``read`` with basecalls that lose or gain a base at ``n_edits``
    places (the raw signal unchanged): a lost base's signal joins the
    previous base, a gained base takes the second half of its base's."""
    seq, segs = list(read.seq), list(read.true_segs)
    for pos in sorted(rng.choice(np.arange(20, len(seq) - 20), n_edits,
                                 replace=False))[::-1]:
        if rng.random() < 0.5:
            del seq[pos]
            del segs[pos]
        else:
            seq.insert(pos + 1, "ACGT"[int(rng.integers(4))])
            segs.insert(pos + 1, (segs[pos] + segs[pos + 1]) // 2)
    return replace(read, seq="".join(seq), true_segs=np.array(segs))


def _build(base, n_reads=5, seed=17, with_model=False, n_edits=0):
    """A reference and FAST5 files with basecaller Events tables, written
    by the JAX package's writers; two copies of the directory."""
    rng = np.random.default_rng(seed)
    fasta = j_testing.random_reference(rng, 3000)
    model = JKmerModel.load_default(j_config.DNA_SAMP_TYPE)
    d = os.path.join(base, "ev_fast5s")
    os.makedirs(d, exist_ok=True)
    reads = []
    for i in range(n_reads):
        read = j_testing.simulate_read(rng, fasta, model, read_len=300,
                                       read_id="evs_%03d" % i)
        if n_edits:
            read = _with_indels(read, rng, n_edits)
        fn = os.path.join(d, read.read_id + ".fast5")
        j_testing.write_synthetic_fast5(fn, read)
        j_testing.write_basecaller_events(fn, read, jitter=2, rng=rng,
                                          model=model if with_model
                                          else None)
        reads.append(read)
    fasta_fn = os.path.join(base, "ref.fasta")
    fasta.write(fasta_fn)
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = os.path.join(base, name)
        shutil.copytree(d, dirs[name])
    return fasta, fasta_fn, model, dirs, reads


def _write_sam(path, fasta, reads, n_clip=0):
    chrm = fasta.iter_chrms()[0]
    with open(path, "w") as fp:
        fp.write("@SQ\tSN:%s\tLN:%d\n" % (chrm, len(fasta.get_seq(chrm))))
        for read in reads:
            n = len(read.seq)
            if read.strand == "+":
                flag, seq = 0, read.seq
                pos = read.start + n_clip + 1
                cigar = ("%dS" % n_clip if n_clip else "") + \
                    "%dM" % (n - n_clip)
            else:
                flag, seq = 16, rev_comp(read.seq)
                pos = read.start + 1
                cigar = "%dM" % (n - n_clip) + \
                    ("%dS" % n_clip if n_clip else "")
            fp.write("\t".join([
                read.read_id, str(flag), chrm, str(pos), "60", cigar,
                "*", "0", "0", seq, "#" * n]) + "\n")


def _write_m5(path, fasta, reads):
    chrm = fasta.iter_chrms()[0]
    t_len = len(fasta.get_seq(chrm))
    with open(path, "w") as fp:
        for read in reads:
            target = fasta.get_seq(chrm, read.start, read.end)
            q_aln = read.seq if read.strand == "+" else rev_comp(read.seq)
            n = len(read.seq)
            fp.write(" ".join([
                read.read_id, str(n), "0", str(n), read.strand,
                chrm, str(t_len), str(read.start), str(read.end), "+",
                str(n), str(n), "0", "0", "0", "254",
                q_aln, "|" * n, target]) + "\n")


def _write_pore_model(path, model):
    with open(path, "w") as fp:
        fp.write("kmer\tlevel_mean\tlevel_stdv\n")
        for code in range(4 ** model.kmer_width):
            kmer, c = "", code
            for _ in range(model.kmer_width):
                kmer = "ACGT"[c % 4] + kmer
                c //= 4
            fp.write("%s\t%f\t%f\n" % (kmer, model.means[code],
                                       model.sds[code]))


def _groups(d, corr_grp):
    """{file: (group attributes, Alignment attributes, Events,
    read_start_rel_to_raw)} of a directory's corrected groups."""
    out = {}
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".fast5"):
            continue
        with h5py.File(os.path.join(d, fn), "r") as f:
            g = f.get("Analyses/%s/%s" % (corr_grp, SUB))
            if g is None or "Events" not in g:
                out[fn] = None
                continue
            out[fn] = (dict(g.attrs.items()),
                       dict(g["Alignment"].attrs.items()), g["Events"][:],
                       int(g["Events"].attrs["read_start_rel_to_raw"]))
    return out


def _assert_same_groups(d_port, d_jax, corr_grp, n_expected):
    got, want = _groups(d_port, corr_grp), _groups(d_jax, corr_grp)
    assert got.keys() == want.keys()
    assert sum(v is not None for v in want.values()) == n_expected
    for fn in want:
        if want[fn] is None:
            assert got[fn] is None, fn
            continue
        (ga, gal, gev, grs), (wa, wal, wev, wrs) = got[fn], want[fn]
        assert grs == wrs, fn
        assert gev.dtype == wev.dtype
        for name in wev.dtype.names:
            np.testing.assert_array_equal(gev[name], wev[name], err_msg=fn)
        assert ga.keys() == wa.keys() and gal.keys() == wal.keys()
        for k in wa:
            assert (ga[k] == wa[k] or
                    (np.isnan(ga[k]) and np.isnan(wa[k]))), (fn, k)
        for k in wal:
            assert gal[k] == wal[k], (fn, k)


def _run_both(dirs, j_kw, t_kw, corr_grp="RawGenomeCorrected_000"):
    want = j_er.event_resquiggle_all_reads(
        dirs["jax"], corr_grp=corr_grp, num_threads=2, **j_kw)
    got = t_er.event_resquiggle_all_reads(
        dirs["port"], corr_grp=corr_grp, num_threads=2, **t_kw)
    assert got == want
    return want


@pytest.mark.parametrize("norm_type", ["median", "none", "pA_raw", "pA"])
def test_exact_aligner_every_normalization(tmp_path, norm_type):
    """The in-process exact aligner, every normalization type (pA with a
    pore-model TSV): groups bit for bit, the same success count."""
    fasta, fasta_fn, model, dirs, reads = _build(
        str(tmp_path), seed=29, with_model=norm_type == "pA")
    kw = {}
    if norm_type == "pA":
        kw["pore_model_fn"] = str(tmp_path / "pore_model.tsv")
        _write_pore_model(kw["pore_model_fn"], model)
    n_ok, _, fails = _run_both(
        dirs, dict(aligner=j_aligner.ExactAligner(fasta),
                   norm_type=norm_type, **kw),
        dict(aligner=t_aligner.ExactAligner(TFasta.read(fasta_fn)),
             norm_type=norm_type, **kw))
    assert n_ok == len(reads), fails
    _assert_same_groups(dirs["port"], dirs["jax"], "RawGenomeCorrected_000",
                        len(reads))


def test_minimizer_aligner_with_indels(tmp_path):
    """Basecalls with indels through the native minimizer aligners: the
    indel groups are re-segmented by changepoints, bit for bit."""
    fasta, fasta_fn, model, dirs, reads = _build(
        str(tmp_path), n_reads=6, seed=3, n_edits=6)
    n_ok, n_fail, fails = _run_both(
        dirs, dict(aligner=j_aligner.MinimizerAligner(fasta)),
        dict(aligner=t_aligner.MinimizerAligner(TFasta.read(fasta_fn))))
    assert n_ok >= 4, fails
    _assert_same_groups(dirs["port"], dirs["jax"], "RawGenomeCorrected_000",
                        n_ok)
    # the indel machinery ran: some read has fewer events than bases
    # called, or more
    got = _groups(dirs["port"], "RawGenomeCorrected_000")
    lens = {fn: v[2].shape[0] for fn, v in got.items() if v is not None}
    calls = {r.read_id + ".fast5": len(r.seq) for r in reads}
    assert any(lens[fn] != calls[fn] for fn in lens)


@pytest.mark.parametrize("source", ["sam", "sam_soft_clip", "m5"])
def test_alignment_files(tmp_path, source):
    """SAM (with and without soft clips) and M5 alignments: the parsed
    alignments equal, then the groups bit for bit."""
    fasta, fasta_fn, model, dirs, reads = _build(str(tmp_path), seed=31)
    t_fasta = TFasta.read(fasta_fn)
    aln_fn = str(tmp_path / ("aln.m5" if source == "m5" else "aln.sam"))
    if source == "m5":
        _write_m5(aln_fn, fasta, reads)
        want, got = j_er.parse_m5_file(aln_fn), t_er.parse_m5_file(aln_fn)
    else:
        _write_sam(aln_fn, fasta, reads,
                   n_clip=20 if source == "sam_soft_clip" else 0)
        want = j_er.parse_sam_file(aln_fn, fasta)
        got = t_er.parse_sam_file(aln_fn, t_fasta)
    assert got.keys() == want.keys() == {r.read_id for r in reads}
    for rid in want:
        assert got[rid].align_vals == want[rid].align_vals
        assert (got[rid].start_clip, got[rid].end_clip) == \
            (want[rid].start_clip, want[rid].end_clip)
        g, w = got[rid].genome_loc, want[rid].genome_loc
        assert (g.start, g.strand, g.chrom) == (w.start, w.strand, w.chrom)
    n_ok, _, fails = _run_both(
        dirs, dict(aligner=None, sam_fn=aln_fn, fasta=fasta),
        dict(aligner=None, sam_fn=aln_fn, fasta=t_fasta))
    assert n_ok == len(reads), fails
    _assert_same_groups(dirs["port"], dirs["jax"], "RawGenomeCorrected_000",
                        len(reads))


def test_failure_counts_by_message(tmp_path):
    """A read the SAM file lacks, a read without an Events table and a
    read whose alignment disagrees with its basecalls: the same counts by
    message, and the same groups for the rest."""
    fasta, fasta_fn, model, dirs, reads = _build(str(tmp_path), n_reads=6,
                                                 seed=37)
    sam_fn = str(tmp_path / "aln.sam")
    bad = replace(reads[2], seq=reads[2].seq[:-5])
    _write_sam(sam_fn, fasta, [reads[0], bad] + reads[3:])
    for d in dirs.values():
        with h5py.File(os.path.join(d, reads[3].read_id + ".fast5"),
                       "r+") as f:
            del f["Analyses/Basecall_1D_000/%s/Events" % SUB]
    n_ok, n_fail, fails = _run_both(
        dirs, dict(aligner=None, sam_fn=sam_fn, fasta=fasta),
        dict(aligner=None, sam_fn=sam_fn, fasta=TFasta.read(fasta_fn)))
    assert (n_ok, n_fail) == (3, 3) and len(fails) == 3, fails
    _assert_same_groups(dirs["port"], dirs["jax"], "RawGenomeCorrected_000",
                        3)


def test_external_aligner_subprocess_command(tmp_path):
    """``build_model event_resquiggle --minimap2-executable``: the reads go
    to FASTA batches, a fake minimap2 maps each batch in a subprocess,
    and the merged SAM feeds the re-squiggle; the port's command against
    the JAX command, bit for bit, and the same merged SAM file."""
    fasta, fasta_fn, model, dirs, reads = _build(str(tmp_path), seed=41)
    full_sam = str(tmp_path / "full.sam")
    _write_sam(full_sam, fasta, reads)
    exe = str(tmp_path / "fake_minimap2")
    with open(exe, "w") as fp:
        fp.write("""#!%s
import sys
reads_fn = sys.argv[-1]
ids = set(l[1:].strip() for l in open(reads_fn) if l.startswith('>'))
for line in open(%r):
    if line.startswith('@') or line.split('\\t', 1)[0] in ids:
        sys.stdout.write(line)
""" % (sys.executable, full_sam))
    os.chmod(exe, os.stat(exe).st_mode | stat.S_IXUSR)
    import importlib
    j_cli = importlib.import_module("tombo_tpu.cli.main")
    argv = ["build_model", "event_resquiggle", None, fasta_fn,
            "--minimap2-executable", exe, "--alignment-batch-size", "2",
            "--align-processes", "2", "--overwrite", "--timeout", "600",
            "-q"]
    for cli, d in ((j_cli, dirs["jax"]), (t_cli, dirs["port"])):
        argv[2] = d
        assert cli.main(list(argv)) == 0
    _assert_same_groups(dirs["port"], dirs["jax"], "RawGenomeCorrected_000",
                        len(reads))
    fns = [os.path.join(dirs["port"], r.read_id + ".fast5") for r in reads]
    outs = []
    for run in (j_er.run_external_aligner, t_er.run_external_aligner):
        out = str(tmp_path / ("merged_%d.sam" % len(outs)))
        run(fns, fasta_fn, exe, "minimap2", batch_size=2,
            num_align_processes=2, out_sam_fn=out)
        outs.append(open(out).read())
    assert outs[0] == outs[1] and outs[1].count("\n") == len(reads) + 1


def test_command_writes_the_jax_provenance_and_index(tmp_path):
    """The command line through an alignment file at pA_raw: the
    corrected groups' resolved-parameter JSON and the index records equal
    the JAX command's."""
    import importlib
    j_cli = importlib.import_module("tombo_tpu.cli.main")
    from tombo_tpu.io.index import ReadsIndex as JIndex
    from tombo_tpu_torch.io.index import ReadsIndex as TIndex
    fasta, fasta_fn, model, dirs, reads = _build(str(tmp_path), seed=43)
    sam_fn = str(tmp_path / "aln.sam")
    _write_sam(sam_fn, fasta, reads)
    for cli, d in ((j_cli, dirs["jax"]), (t_cli, dirs["port"])):
        assert cli.main(["build_model", "event_resquiggle", d, fasta_fn,
                         "--alignment-file", sam_fn, "--overwrite",
                         "--normalization-type", "pA_raw", "-q"]) == 0
    _assert_same_groups(dirs["port"], dirs["jax"], "RawGenomeCorrected_000",
                        len(reads))

    def records(idx):
        return sorted((cs, r.start, r.end, r.strand, os.path.basename(r.fn),
                       r.corr_group, r.read_start_rel_to_raw, r.read_id)
                      for cs, rs in idx.reads_index.items() for r in rs)
    assert records(TIndex([dirs["port"]])) == records(JIndex([dirs["jax"]]))


@pytest.mark.parametrize("norm_type", ["none", "pA_raw", "pA", "median",
                                       "robust_median",
                                       "median_const_scale"])
def test_normalize_raw_signal_every_type(norm_type):
    """Each normalization type, with and without outlier clipping, bitwise
    the JAX host function at float64."""
    rng = np.random.default_rng(5)
    raw = np.round(rng.normal(450, 60, 4000)).astype(np.int16)
    ch = dict(offset=4.0, range=1400.0, digitisation=8192.0, number=1,
              sampling_rate=4000)
    kw = {}
    if norm_type == "pA":
        kw = dict(event_means=rng.normal(80, 10, 200),
                  model_means=rng.normal(0, 1, 200),
                  model_inv_vars=1.0 / rng.uniform(0.1, 0.3, 200) ** 2)
    if norm_type == "median_const_scale":
        kw["const_scale"] = 55.0
    for thresh in (None, 5.0):
        want = j_rsq.normalize_raw_signal(
            raw, 100, 3500, norm_type, thresh,
            channel_info=JChannelInfo(**ch), **kw)
        got = t_rsq.normalize_raw_signal(
            raw, 100, 3500, norm_type, thresh,
            channel_info=TChannelInfo(**ch), **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert tuple(got[1].__dict__.values()) == \
            tuple(want[1].__dict__.values())


@pytest.mark.parametrize("method,n", [("theil_sen", 300),
                                      ("theil_sen", 1500), ("mom", 400)])
def test_fitted_shift_scale(method, n):
    """Both fitting methods, Theil-Sen past its point cap too (the same
    draws from the same generator), bitwise the JAX function."""
    rng = np.random.default_rng(11)
    ev = rng.normal(0, 1, n)
    mm = 0.9 * ev + 0.1 + rng.normal(0, 0.05, n)
    iv = 1.0 / rng.uniform(0.1, 0.3, n) ** 2
    want = j_rsq.calc_kmer_fitted_shift_scale(
        0.5, 2.0, ev, mm, iv, method=method, rng=np.random.default_rng(1))
    got = t_rsq.calc_kmer_fitted_shift_scale(
        0.5, 2.0, ev, mm, iv, method=method, rng=np.random.default_rng(1))
    assert got == want


def test_fast5_writers_and_reader_match_jax(tmp_path):
    """The port's ``make_synthetic_dataset``, ``write_synthetic_fast5`` and
    ``write_basecaller_events`` write the JAX writers' datasets and
    attributes; ``read_corrected_events`` reads what the JAX one reads."""
    sets = {}
    for name, mod in (("jax", j_testing), ("port", t_testing)):
        d = str(tmp_path / name)
        os.makedirs(d)
        fasta, reads, fdir = mod.make_synthetic_dataset(
            d, n_reads=3, seed=8, ref_len=3000, read_len=300,
            noisy_frac=0.5)
        model = (JKmerModel if name == "jax" else
                 TKmerModel).load_default("DNA")
        for i, read in enumerate(reads):
            fn = os.path.join(fdir, read.read_id + ".fast5")
            mod.write_basecaller_events(
                fn, read, jitter=2, rng=np.random.default_rng(i),
                model=model if i else None)
        sets[name] = (fdir, open(os.path.join(d, "reference.fasta")).read())
    assert sets["jax"][1] == sets["port"][1]

    def dump(fdir):
        out = {}
        for fn in sorted(os.listdir(fdir)):
            with h5py.File(os.path.join(fdir, fn), "r") as f:
                def visit(name, obj):
                    attrs = {k: (v.tolist() if hasattr(v, "tolist") else v)
                             for k, v in obj.attrs.items()}
                    data = (obj[()].tobytes() if isinstance(obj, h5py.Dataset)
                            and obj.shape != () else
                            obj[()] if isinstance(obj, h5py.Dataset)
                            else None)
                    out[(fn, name)] = (attrs, data)
                f.visititems(visit)
        return out
    assert dump(sets["port"][0]) == dump(sets["jax"][0])

    j_dirs = {"jax": sets["jax"][0], "port": sets["port"][0]}
    fasta = JFasta(os.path.join(str(tmp_path / "jax"), "reference.fasta"))
    j_er.event_resquiggle_all_reads(j_dirs["jax"], j_aligner.ExactAligner(
        fasta), num_threads=1)
    grp = "RawGenomeCorrected_000/" + SUB
    from tombo_tpu.io.fast5 import read_corrected_events as j_read
    n_read = 0
    for fn, v in _groups(j_dirs["jax"], "RawGenomeCorrected_000").items():
        if v is None:
            continue
        got = t_f5.read_corrected_events(os.path.join(j_dirs["jax"], fn),
                                         grp)
        want = j_read(os.path.join(j_dirs["jax"], fn), grp)
        for name in want[0].dtype.names:
            np.testing.assert_array_equal(got[0][name], want[0][name])
        assert got[1:] == want[1:]
        n_read += 1
    assert n_read
