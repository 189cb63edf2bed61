"""Uniform floats in ``range`` [lo, hi)."""

import torch


def make(spec, rows, gen, device, made):
    lo, hi = spec["range"]
    x = torch.rand(rows, generator=gen, device=device, dtype=getattr(torch, spec["dtype"]))
    return x * (hi - lo) + lo if lo else x * hi
