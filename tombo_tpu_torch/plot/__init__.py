"""The ``plot`` commands (counterpart of ``tombo_tpu/plot/``): data
functions that return arrays, their tensor work on a device, and
matplotlib renderers to PDF (reference: tombo/_plot_commands.py,
tombo/R_scripts/).  Importing the package loads neither matplotlib nor
h5py."""
from .cli import add_plot_parsers  # noqa: F401
