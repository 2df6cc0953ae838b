"""The port's native minimizer aligner (``tombo_tpu_torch/csrc/aligner.cpp``,
built by ``tombo_tpu_torch/native.py``) held against the JAX package's on
the same reference and reads, and the engine order of ``open_aligner``
and of the command line."""
import argparse
import os

import numpy as np
import pytest

from tombo_tpu.io.fasta import Fasta as JFasta
from tombo_tpu.pipeline.aligner import MinimizerAligner as JMinimizer
from tombo_tpu.testing import mutate_seq
from tombo_tpu_torch import native
from tombo_tpu_torch.cli import main as t_cli
from tombo_tpu_torch.errors import TomboError
from tombo_tpu_torch.io.fasta import Fasta as TFasta
from tombo_tpu_torch.pipeline import aligner as t_aligner
from tombo_tpu_torch.pipeline import ingest
from tombo_tpu_torch.seq import rev_comp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(7)
    return {"chr1": _rand_seq(rng, 40000), "chr2": _rand_seq(rng, 20000)}


def test_copy_of_the_aligner_source_is_byte_identical():
    with open(os.path.join(ROOT, "csrc", "aligner.cpp"), "rb") as a, \
            open(os.path.join(ROOT, "tombo_tpu_torch", "csrc",
                              "aligner.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_minimizer_aligner_equals_jax(genome):
    """~60 reads of 300-3,000 bases with 8% basecall errors on both
    strands, some with foreign flanks, and foreign reads: every
    Alignment field equal, and None for the same reads."""
    j_al = JMinimizer(JFasta(seqs=genome))
    t_al = t_aligner.MinimizerAligner(TFasta(genome))
    rng = np.random.default_rng(11)
    n_hit = n_none = 0
    for i in range(64):
        if i % 16 == 15:
            read = _rand_seq(rng, 800)            # maps nowhere
        else:
            chrm = "chr1" if i % 3 else "chr2"
            rlen = int(rng.integers(300, 3000))
            start = int(rng.integers(0, len(genome[chrm]) - rlen))
            seq = genome[chrm][start:start + rlen]
            if i % 2:
                seq = rev_comp(seq)
            read = mutate_seq(rng, seq, 0.08)
            if i % 5 == 0:
                read = _rand_seq(rng, 60) + read + _rand_seq(rng, 40)
        a, b = j_al.map(read), t_al.map(read)
        if a is None:
            assert b is None, i
            n_none += 1
            continue
        assert vars(b) == vars(a), i
        n_hit += 1
    assert n_hit >= 55 and n_none >= 4
    assert t_al.seq("chr2", 100, 130) == genome["chr2"][100:130]
    assert t_al.seq("chr9", 0, 10) is None


def test_aligner_crosses_a_process_boundary(genome):
    t_al = t_aligner.MinimizerAligner(TFasta(genome))
    rebuilt = ingest.build_aligner(ingest.aligner_spec(t_al))
    read = genome["chr1"][5000:6500]
    assert vars(rebuilt.map(read)) == vars(t_al.map(read))


def test_open_aligner_order_without_mappy(tmp_path, monkeypatch):
    """No mappy here: the native engine; with its build failing, the exact
    aligner."""
    fa = str(tmp_path / "ref.fasta")
    TFasta({"c": _rand_seq(np.random.default_rng(1), 3000)}).write(fa)
    with pytest.raises(TomboError, match="mappy"):
        t_aligner.MappyAligner(fa)
    assert isinstance(t_aligner.open_aligner(fa),
                      t_aligner.MinimizerAligner)

    def no_lib():
        raise TomboError("native aligner build failed")
    monkeypatch.setattr(native, "get_lib", no_lib)
    assert isinstance(t_aligner.open_aligner(fa), t_aligner.ExactAligner)


def test_command_line_refuses_the_exact_aligner(tmp_path, monkeypatch):
    """Without a real aligner the command line refuses to run unless
    --allow-exact-aligner is given (the JAX command line's rule)."""
    fa = str(tmp_path / "ref.fasta")
    TFasta({"c": _rand_seq(np.random.default_rng(2), 3000)}).write(fa)

    def no_lib():
        raise TomboError("native aligner build failed")
    monkeypatch.setattr(native, "get_lib", no_lib)
    args = argparse.Namespace(reference=fa, allow_exact_aligner=False)
    with pytest.raises(TomboError, match="--allow-exact-aligner"):
        t_cli._open_genomic_aligner(args)
    args.allow_exact_aligner = True
    assert isinstance(t_cli._open_genomic_aligner(args),
                      t_aligner.ExactAligner)
    fast5s = tmp_path / "fast5s"
    fast5s.mkdir()
    assert t_cli.main(["resquiggle", str(fast5s), fa, "--dna",
                       "--device", "cpu", "--quiet"]) == 1


def test_build_without_a_compiler_raises(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(TomboError, match="no C\\+\\+ compiler"):
        native.get_lib()


def test_build_key_names_the_host(monkeypatch):
    a = native._lib_path("g++")
    monkeypatch.setattr(native.platform, "node", lambda: "another-host")
    assert native._lib_path("g++") != a
    assert os.path.dirname(a) == native.BUILD_DIR
