"""PyTorch/CUDA port of tombo_tpu's batched re-squiggle: DNA and direct
RNA (t-test segmentation, stall removal, event-based scale), with the
constant-scale and skip-sequence-scaling options, on one card or over a
reads mesh; of modified-base detection on one host or several and of
model estimation (``stats/``), fed by the event means re-squiggle leaves
on the device; of the plot commands (``plot/``: their data as tensor
operations, matplotlib renderers); and of the command line with its
host-only commands (``output/``, ``filters.py``, ``preprocess.py``,
``pipeline/event_resquiggle.py``).

A package of its own beside ``tombo_tpu``: it imports torch, numpy and
the standard library (``h5py`` and ``matplotlib`` only inside the
functions that open an HDF5 file or draw), never jax and nothing of ``tombo_tpu``.  The module
layout follows the JAX package (``ops/``, ``pipeline/``, ``parallel/``,
``io/``) so each function has an obvious counterpart there.  Entry points
take ``device=None``, which means the CUDA card; without a card they
raise unless ``device="cpu"`` is passed (see :mod:`tombo_tpu_torch.device`).

Run the re-squiggle algorithm on one read (start discovery, the adaptive
DP and the Theil-Sen fit on the card, each at a batch of one; the host
steps in numpy and the port's host library, ``native.py``)::

    from tombo_tpu_torch import config
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.pipeline import resquiggle
    from tombo_tpu_torch.pipeline.aligner import open_aligner
    from tombo_tpu_torch.types import SeqSampleType, SequenceData

    aligner = open_aligner('genome.fasta')
    std_ref = KmerModel.load_default(config.DNA_SAMP_TYPE)
    params = config.load_resquiggle_parameters(config.DNA_SAMP_TYPE)
    sst = SeqSampleType(config.DNA_SAMP_TYPE, False)
    map_res = resquiggle.map_read(
        SequenceData(seq, read_id, mean_q_score), aligner, std_ref, sst)
    map_res = map_res.replace(raw_signal=all_raw_signal)
    map_res = resquiggle.adjust_map_res(map_res, sst, params)
    rsqgl_res = resquiggle.resquiggle_read(
        map_res, std_ref, params, outlier_thresh=config.OUTLIER_THRESH,
        seq_samp_type=sst, device=None)

``device="cpu", dtype="float64"`` gives the JAX package's
``resquiggle_read`` bit for bit; ``resquiggle_read_with_retries`` adds
the scaling passes and the save-bandwidth retry.  For whole directories
prefer the batched lane (``pipeline/batch.py``, ``pipeline/runner.py``).
"""

__version__ = "0.1.0"
