"""The benchmark of lsi_tpu_torch on the NVIDIA H100 (see run.py)."""
