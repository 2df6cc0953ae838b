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
"""

__version__ = "0.1.0"
