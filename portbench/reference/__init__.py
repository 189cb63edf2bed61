"""The plain references: plain PyTorch over the generated tables, with no
import of vaex_tpu_torch, vaex_tpu or jax."""
