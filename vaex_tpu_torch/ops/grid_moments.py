"""Per-bin sums of moment terms (kernels B4 and B5): the term contract, the
hand-written CUDA kernels' wrappers, their plain versions and their launch
counters.

The ports of ``vaex_tpu/ops/pallas_gridagg.py:_agg_kernel`` (B4, through
``fused_additive_pallas``) and ``:_agg2_kernel`` (B5, through
``fused_additive_two_level``).  Those kernels add A float64 columns per bin,
columns that vaex_tpu forms in XLA before the kernel runs (x, x^2, x*y, ...;
``vaex_tpu/agg.py:333-338, 1138-1195``).  Here the kernels form them from
the base columns, each base read once per row.  The contract:

* ``idx`` [N] int32; rows outside [0, G) add nothing.
* ``bases``: at most ``MAX_BASES`` columns [N], int64, float32 or float64,
  read as float64.  NaN marks a missing value: a masked column reaches the
  wrapper as a float64 copy with NaN in its masked rows.
* ``terms``: at most ``MAX_TERMS`` tuples ``(a, b, v0, v1)`` of base
  indices, -1 for none.  A float term (``a >= 0``) adds
  ``base[a] * base[b]`` (``base[a]`` when ``b = -1``) in float64; a count
  term (``a = -1``) counts rows.  A row adds to a term only where no base
  the term names (a, b, v0 or v1, those >= 0) is NaN.
* Returns ``(counts [n_count, G] int64, sums [n_float, G] float64)``, each
  in the order of its terms.

``var(x)`` is the terms x, x*x and a count, all valid where x is;
``corr(x, y)`` is x*y, x, y, x*x, y*y and a count, all valid where both
are (vaex_tpu's ``where(notna(y), x, y*0)``).

``grid_moments`` (B4, ``csrc/grid_moments.cu``) keeps B1's ordered scheme:
warp-private [C, G] grids, floats reproducible run to run, counts exact.
``grid_moments_window`` (B5, ``csrc/grid_moments_window.cu``) keeps B2's
bin windows with shared-memory atomics: counts exact, floats NOT
reproducible run to run.  Which one a pass takes is
:func:`.grid_plan.moment_strategy`'s choice.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build
from .grid_additive import (MIN_STEPS_PER_WARP, SM_SMEM, SM_THREADS, SMEM_BUDGET, STAGE_ROWS,
                            check_cuda, grid_additive_reference, plan, warp_bytes)
from .grid_window import grid_window_reference

# mirror MAX_BASES / MAX_TERMS in csrc/moments_common.cuh (checked at load)
MAX_BASES = 4
MAX_TERMS = 16
WINDOW_WARPS = 32  # warps per B5 CTA, all sharing its window
BASE_KINDS = {torch.float64: 0, torch.float32: 1, torch.int64: 2}


def split_terms(terms, n_bases):
    """(count terms, float terms) as (a, b, need) triples, ``need`` the
    bitmask of the bases that must not be NaN; raises on a malformed term."""
    counts, floats = [], []
    for term in terms:
        if len(term) != 4 or any(not -1 <= int(j) < n_bases for j in term):
            raise ValueError(f"term {term!r} must be 4 base indices in [-1, {n_bases})")
        a, b = int(term[0]), int(term[1])
        need = 0
        for j in term:
            if j >= 0:
                need |= 1 << int(j)
        if a < 0:
            if b >= 0:
                raise ValueError(f"count term {term!r} names a factor")
            counts.append((a, b, need))
        else:
            floats.append((a, b, need))
    return counts, floats


def form_terms(idx, bases, terms):
    """The terms as columns, in plain PyTorch: (count columns [N] int64, 0 or
    1; float columns [N] float64, 0.0 where the term's row is not valid)."""
    vals = [b.to(torch.float64) for b in bases]
    nan = [torch.isnan(v) for v in vals]
    count_terms, float_terms = split_terms(terms, len(bases))

    def invalid(need):
        bad = None
        for j, m in enumerate(nan):
            if need >> j & 1:
                bad = m if bad is None else bad | m
        return bad

    count_cols = []
    for _, _, need in count_terms:
        bad = invalid(need)
        count_cols.append(torch.ones_like(idx, dtype=torch.int64) if bad is None
                          else (~bad).to(torch.int64))
    float_cols = []
    for a, b, need in float_terms:
        v = vals[a] if b < 0 else vals[a] * vals[b]
        bad = invalid(need)
        float_cols.append(v if bad is None else v.masked_fill(bad, 0.0))
    return count_cols, float_cols


def check_inputs(idx, bases, terms, G):
    """The checks both moment kernels' wrappers make before they dispatch."""
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be 1-d int32, got {idx.dtype} with shape {tuple(idx.shape)}")
    if len(bases) > MAX_BASES or not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"{len(bases)} bases and {len(terms)} terms: the kernels take at "
                         f"most {MAX_BASES} bases and 1 to {MAX_TERMS} terms")
    for col in bases:
        if col.dtype not in BASE_KINDS:
            raise TypeError(f"bases must be int64, float32 or float64, got {col.dtype}")
        if col.shape != idx.shape:
            raise ValueError(f"base shape {tuple(col.shape)} does not match idx "
                             f"{tuple(idx.shape)}")
        if col.device != idx.device:
            raise ValueError(f"base on {col.device}, idx on {idx.device}")
    if G < 1:
        raise ValueError(f"nothing to add: G={G}")
    split_terms(terms, len(bases))


def grid_moments_reference(idx, bases, terms, G):
    """The plain PyTorch version: the term columns, then ``index_add_``."""
    count_cols, float_cols = form_terms(idx, bases, terms)
    return grid_additive_reference(idx, count_cols, float_cols, int(G), False)


def grid_moments_window_reference(idx, bases, terms, G):
    """The plain PyTorch version of B5: the term columns, then the kernel's
    bin windows one after the other, each an ``index_add_``."""
    count_cols, float_cols = form_terms(idx, bases, terms)
    return grid_window_reference(idx, count_cols, float_cols, int(G), False,
                                 window_width(len(terms)))


def fits(G, C):
    """True when one warp's ordered [C, G] grid fits B4's shared memory."""
    return 1 <= C <= MAX_TERMS and warp_bytes(C, G) <= SMEM_BUDGET


def _library(name):
    lib = kernel_build.library(name, SMEM_BUDGET, MAX_TERMS)
    max_bases = getattr(lib, f"{name}_max_bases")
    max_bases.restype = ctypes.c_int
    if max_bases() != MAX_BASES:
        raise RuntimeError(f"{name}_max_bases disagrees with its wrapper")
    run = getattr(lib, f"{name}_run")
    run.restype = ctypes.c_int
    run.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib, run


def window_width(C):
    """The widest window of B5: its [C, W] 8-byte words fill ``SMEM_BUDGET``."""
    return SMEM_BUDGET // (8 * C)


def n_windows(G, C):
    """Windows of ``window_width(C)`` bins a grid of G bins takes in B5."""
    return -(-G // window_width(C))


def window_plan(n, G, C, sm_count):
    """(W, n_win, n_slices) of one B5 launch: a CTA per window and row
    slice, the CTAs of all windows together filling the card once."""
    W = window_width(C)
    n_win = n_windows(G, C)
    smem = C * W * 8
    resident = sm_count * max(1, min(SM_THREADS // (WINDOW_WARPS * 32), SM_SMEM // smem))
    rows_per_cta = WINDOW_WARPS * STAGE_ROWS * MIN_STEPS_PER_WARP
    n_slices = max(1, min(resident // n_win, -(-n // rows_per_cta), 65535))
    return W, n_win, n_slices


def _launch(name, idx, bases, terms, G, W, n_parts, warps):
    """One launch of ``csrc/<name>.cu``: W is the window width (G for B4),
    n_parts the CTAs (B4) or row slices (B5) whose partials are folded."""
    count_terms, float_terms = split_terms(terms, len(bases))
    ordered = count_terms + float_terms  # the kernels' row order: counts first
    C = len(ordered)
    device = idx.device
    counts = torch.empty((len(count_terms), G), dtype=torch.int64, device=device)
    sums = torch.empty((len(float_terms), G), dtype=torch.float64, device=device)
    scratch = torch.empty(n_parts * C * G, dtype=torch.int64, device=device)
    base_ptrs = (ctypes.c_void_p * MAX_BASES)(*[b.data_ptr() for b in bases])
    base_kinds = (ctypes.c_int * MAX_BASES)(*[BASE_KINDS[b.dtype] for b in bases])
    term_a = (ctypes.c_int * MAX_TERMS)(*[a for a, _, _ in ordered])
    term_b = (ctypes.c_int * MAX_TERMS)(*[b for _, b, _ in ordered])
    term_need = (ctypes.c_uint * MAX_TERMS)(*[need for _, _, need in ordered])
    lib, run = _library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = run(idx.data_ptr(), idx.shape[0], G, W,
                  ctypes.addressof(base_ptrs), ctypes.addressof(base_kinds), len(bases),
                  ctypes.addressof(term_a), ctypes.addressof(term_b),
                  ctypes.addressof(term_need), len(count_terms), len(float_terms),
                  n_parts, warps, scratch.data_ptr(),
                  counts.data_ptr(), sums.data_ptr(), stream)
    kernel_build.raise_on_error(lib, name, err)
    return counts, sums


def grid_moments(idx, bases, terms, G):
    """Per-bin term sums through B4; see the module docstring.  CPU tensors
    take the plain version; CUDA tensors launch the kernel, or raise when it
    cannot take them."""
    G = int(G)
    bases, terms = list(bases), [tuple(t) for t in terms]
    check_inputs(idx, bases, terms, G)
    if idx.device.type == "cpu":
        return grid_moments_reference(idx, bases, terms, G)
    check_cuda("grid_moments", idx, bases, [])
    C = len(terms)
    if not fits(G, C):
        raise ValueError(f"grid_moments: G={G} with {C} terms does not fit the kernel")
    sm_count = torch.cuda.get_device_properties(idx.device).multi_processor_count
    n_ctas, warps = plan(idx.shape[0], G, C, sm_count)
    out = _launch("grid_moments", idx, bases, terms, G, G, n_ctas, warps)
    grid_moments.launches += 1
    return out


def grid_moments_window(idx, bases, terms, G):
    """Per-bin term sums through B5; see the module docstring.  CPU tensors
    take the plain version; CUDA tensors launch the kernel, or raise when it
    cannot take them."""
    G = int(G)
    bases, terms = list(bases), [tuple(t) for t in terms]
    check_inputs(idx, bases, terms, G)
    if idx.device.type == "cpu":
        return grid_moments_window_reference(idx, bases, terms, G)
    check_cuda("grid_moments_window", idx, bases, [])
    C = len(terms)
    if C * G >= 2 ** 31:
        raise ValueError(f"grid_moments_window: G={G} with {C} terms does not fit the kernel")
    sm_count = torch.cuda.get_device_properties(idx.device).multi_processor_count
    W, _, n_slices = window_plan(idx.shape[0], G, C, sm_count)
    out = _launch("grid_moments_window", idx, bases, terms, G, W, n_slices, WINDOW_WARPS)
    grid_moments_window.launches += 1
    return out


grid_moments.launches = 0
grid_moments_window.launches = 0
