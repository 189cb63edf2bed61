"""Uniform integers in ``range`` [lo, hi], both ends included."""

import torch


def make(spec, rows, gen, device, made):
    lo, hi = spec["range"]
    return torch.randint(int(lo), int(hi) + 1, (rows,), generator=gen, device=device,
                         dtype=getattr(torch, spec["dtype"]))
