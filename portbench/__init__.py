"""portbench: the benchmark of vaex_tpu_torch on one NVIDIA GPU (see README.md)."""
