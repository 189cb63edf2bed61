"""Runtime configuration for vaex_tpu_torch.

Env var (optional):
  VAEX_TPU_TORCH_DEVICE     device that ``DataFrame.to_device()`` stages to
                            when none is given, and that a pass over a frame
                            of host arrays no one staged runs on (default
                            'cuda': without a card such a pass raises)

A pass runs eagerly, tile by tile; every tile costs a few kernel launches
and one fold of the kernel's per-CTA partials, so tiles are large.  On an
NVIDIA H100 80GB HBM3 (power limit 700.00 W) a 1e8-row groupby(sum, count)
took 3.43 / 2.86 / 2.70 / 2.67 ms with tiles of 2^22 / 2^24 / 2^26 / all
rows; 2^26 rows keep the per-tile temporaries near 1 GB.
"""

from __future__ import annotations

import os

TILE_ROWS = 1 << 26  # rows per tile of a pass
DEVICE = os.environ.get("VAEX_TPU_TORCH_DEVICE", "cuda")
