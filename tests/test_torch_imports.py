"""The PyTorch port stands alone: no jax, nothing of tombo_tpu, and no
silent CPU fallback."""
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "tombo_tpu_torch", "tombo_tpu_torch.config", "tombo_tpu_torch.convert",
    "tombo_tpu_torch.device", "tombo_tpu_torch.errors",
    "tombo_tpu_torch.kernels", "tombo_tpu_torch.seq",
    "tombo_tpu_torch.testing", "tombo_tpu_torch.types",
    "tombo_tpu_torch.io.fasta", "tombo_tpu_torch.io.model_io",
    "tombo_tpu_torch.ops.banded_dp", "tombo_tpu_torch.ops.delfix",
    "tombo_tpu_torch.ops.dp", "tombo_tpu_torch.ops.normalize",
    "tombo_tpu_torch.ops.precision", "tombo_tpu_torch.ops.ref_impl",
    "tombo_tpu_torch.ops.rescale", "tombo_tpu_torch.ops.segment",
    "tombo_tpu_torch.ops.select", "tombo_tpu_torch.parallel",
    "tombo_tpu_torch.parallel.distributed", "tombo_tpu_torch.parallel.mesh",
    "tombo_tpu_torch.pipeline.aligner", "tombo_tpu_torch.pipeline.batch",
    "tombo_tpu_torch.pipeline.resquiggle",
]


def test_port_imports_no_jax_and_no_jax_package():
    code = textwrap.dedent("""
        import importlib, sys
        for m in %r:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "tombo_tpu"))
        print(",".join(bad))
    """ % (PORT_MODULES,))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|tombo_tpu)\b(?!_)")
    assert not [ln for ln in src.splitlines() if bad.match(ln)]


def test_default_device_needs_a_card(monkeypatch):
    from tombo_tpu_torch import config
    from tombo_tpu_torch.device import resolve_device, resolve_dtype
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler
    from tombo_tpu_torch.types import SeqSampleType

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = KmerModel.load_default("DNA")
    params = config.load_resquiggle_parameters("DNA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedResquiggler(model, params, SeqSampleType("DNA", False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    br = BatchedResquiggler(model, params, SeqSampleType("DNA", False),
                            device="cpu")
    assert br.dtype == torch.float32
    with pytest.raises(ValueError, match="float32"):
        resolve_dtype(torch.float64, torch.device("cuda"))
    assert resolve_dtype(None, torch.device("cpu")) == torch.float32


@pytest.mark.parametrize("kw,exc,item", [
    (dict(seq_samp_type=("DNA_5mC", False)), ValueError,
     "unknown sample type"),
    (dict(mesh=[]), ValueError, "at least one device"),
])
def test_unported_options_name_their_roadmap_item(kw, exc, item):
    """An invalid mesh raises, as every mesh the port cannot run does;
    so does a sample type the port has no parameters for."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler
    from tombo_tpu_torch.types import SeqSampleType

    sst = SeqSampleType(*kw.pop("seq_samp_type", ("DNA", False)))
    with pytest.raises(exc, match=item):
        BatchedResquiggler(KmerModel.load_default("DNA"),
                           config.load_resquiggle_parameters("DNA"), sst,
                           device="cpu", **kw)


@pytest.mark.parametrize("samp_type,kw", [
    ("RNA", {}), ("DNA", dict(const_scale=55.0)),
    ("RNA", dict(const_scale=55.0, skip_seq_scaling=True))],
    ids=["RNA", "const_scale", "RNA_const_scale_skip_seq_scaling"])
def test_rna_and_const_scale_run(samp_type, kw):
    """RNA and constant-scale normalization, once refused, run on the
    CPU: two short simulated reads come back re-squiggled."""
    from tombo_tpu_torch import config, testing
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    from tombo_tpu_torch.pipeline.aligner import ExactAligner
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler
    from tombo_tpu_torch.types import SeqSampleType, SequenceData

    rna = samp_type == "RNA"
    rng = np.random.default_rng(2)
    model = KmerModel.load_default(samp_type)
    fasta = testing.random_reference(np.random.default_rng(3), 5000)
    aligner = ExactAligner(fasta)
    sst = SeqSampleType(samp_type, rna)
    params = config.load_resquiggle_parameters(samp_type)
    maps = []
    for i in range(2):
        read = testing.simulate_read(rng, fasta, model, read_len=400,
                                     mean_dwell=12.0 if rna else 7.0,
                                     rev_sig=rna)
        mr = rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                          aligner, model, sst)
        maps.append(rsq.adjust_map_res(
            mr.replace(raw_signal=read.raw_signal), sst, params))
    out = BatchedResquiggler(model, params, sst, device="cpu",
                             **kw).resquiggle_batch(maps)
    for res, err in out:
        assert err is None, err
        assert res.segs.shape[0] == len(res.genome_seq) + 1
        if "const_scale" in kw and "skip_seq_scaling" in kw:
            assert res.scale_values.scale == 55.0


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from tombo_tpu_torch import kernels
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_header_edit_changes_library_hash(monkeypatch, tmp_path):
    """A library is keyed on its source and every local header the
    source includes, so editing a shared header rebuilds its users."""
    import shutil
    from tombo_tpu_torch import kernels
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    before = {n: kernels._lib_path(n) for n in kernels.SOURCES}
    with open(csrc / "dp_row.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: kernels._lib_path(n) for n in kernels.SOURCES}
    assert after["banded_dp"] != before["banded_dp"]
    assert after["banded_dp_chunked"] != before["banded_dp_chunked"]
    assert after["count_le"] == before["count_le"]


def test_model_file_is_the_jax_package_copy():
    a = open(os.path.join(ROOT, "tombo_tpu", "models",
                          "tombo.DNA.model.npz"), "rb").read()
    b = open(os.path.join(ROOT, "tombo_tpu_torch", "models",
                          "tombo.DNA.model.npz"), "rb").read()
    assert a == b
