"""Genome-browser text output: wiggle and bedGraph tracks and the FASTA of
the most significant regions (counterpart of ``tombo_tpu/output/``;
reference: tombo/_text_output_commands.py).  Host only: numpy and file
work, no device."""
