"""The port's version, reported by ``tombo-tpu-torch --version`` and
stored in each corrected group it writes (the JAX package's version, the
same value, so both packages write the same attribute)."""
VERSION = "0.1.0"
