"""The ``tombo-tpu-torch`` command line."""
