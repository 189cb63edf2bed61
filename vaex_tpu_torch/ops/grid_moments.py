"""Per-bin sums of moment terms (kernels B4 and B5): the term contract, the
hand-written CUDA kernels' wrappers, their plain versions and their launch
counters.

The ports of ``vaex_tpu/ops/pallas_gridagg.py:_agg_kernel`` (B4, through
``fused_additive_pallas``) and ``:_agg2_kernel`` (B5, through
``fused_additive_two_level``).  Those kernels add A float64 columns per bin,
columns that vaex_tpu forms in XLA before the kernel runs (x, x^2, x*y, ...;
``vaex_tpu/agg.py:333-338, 1138-1195``).  Here the kernels form them from
the base columns, each base read once per row.  The contract:

* ``idx`` [N] int32; rows outside [0, G) add nothing.  B4 also takes None
  at G = 1 with at least one base: every row is in bin 0, and the kernel
  reads no index (a statistic without binby or selection).
* ``bases``: at most ``MAX_BASES`` columns [N], int64, float32 or float64,
  read as float64.  NaN marks a missing value: a masked column reaches the
  wrapper as a float64 copy with NaN in its masked rows.
* ``shift`` (shifted moments): None, or per base None, a constant that the
  kernel subtracts from every value before it forms a term, or a shift a
  cell: a [G] tensor read as ``shift[idx]`` for each row (a row outside [0,
  G) reads a clamped bin and adds nothing).  Either is an int64 for an
  int64 base (subtracted in int64, then cast: exact to one rounding where
  the span passes 2^63) and a float64 for a float base (subtracted in
  float64); a table of another dtype or shape raises.  var(x) = var(x - a)
  for any a, cell by cell; with a near the cell's data the float64 sums of
  x and x*x no longer cancel.  The constants reach the kernels as one 8-byte
  word a base in device memory (:func:`shift_words`), a call with a table
  as [nb, G] words, every base's table or constant broadcast (each CTA
  copies the bins it adds into shared memory): no host read.  At G = 1 a
  table is its one word.
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

``grid_moments`` (B4, ``csrc/grid_moments.cu``) has two routes, both with
floats reproducible run to run and counts exact: lane-private grids
(``lane``, B1's lane route: [term][G][32 lanes] of 32-bit counts and
doubles, plain read-modify-writes; var's and corr's term sets compiled, a
row's words read and written together, at G = 1 held in registers) while a
CTA of 227 KiB holds :func:`route`'s warps of them, else B1's ordered
warp-private [C, G] grids (``warp``); ``grid_moments.last_route`` names the
last launch's.  B4 takes the float terms in :func:`float_order`, where the
compiled sets have them, and returns them in the caller's order.
``grid_moments_window`` (B5, ``csrc/grid_moments_window.cu``) cuts the
[C, G] grid of the terms into parts, each all 227 KiB of one CTA's shared
memory, 4 bytes a bin per count term and 8 per float term: the fewest bin
windows in which one term's plane fits, each cut into the fewest groups of
terms that fit, of near-equal size (:func:`part_plan`); every part walks
the rows and adds its terms for the rows of its window with shared-memory
atomics: counts exact, floats NOT reproducible run to run.  Which kernel a
pass takes is :func:`.grid_plan.moment_strategy`'s choice.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build
from .grid_additive import (CLUSTER_SMEM, MAX_WARPS, MIN_STEPS_PER_WARP, SM_SMEM, SM_THREADS,
                            SMEM_BUDGET, STAGE_ROWS, check_cuda, grid_additive_reference, plan,
                            warp_bytes)
from .grid_window import grid_window_reference

# mirror MAX_BASES / MAX_TERMS in csrc/moments_common.cuh (checked at load)
MAX_BASES = 4
MAX_TERMS = 16
WINDOW_WARPS = 32  # warps per B5 CTA, all sharing its part
BASE_KINDS = {torch.float64: 0, torch.float32: 1, torch.int64: 2}
# the routes of B4 (csrc/grid_moments.cu): lane-private grids, or the
# warp-private grids of the ordered scheme
LANE, WARP = "lane", "warp"
# the compiled term sets of csrc/moments_common.cuh (term_set), by their
# bases (1: var, 2: corr): after one count, the float terms (a, b) in
# float_order, every term valid where every base is
COMPILED_SETS = {1: [(0, -1), (0, 0)], 2: [(0, 1), (0, -1), (0, 0), (1, -1), (1, 1)]}
# the lane route while one CTA of 227 KiB keeps this many warps of lane
# grids, by compiled set (var, corr: a row's words read and written
# together) or 0 for any other batch (the run-time tables: a term's
# read-modify-write waits on the last); measured, see grid_plan
LANE_MIN_WARPS = {1: 2, 2: 3, 0: 8}


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


def _kind(base):
    """The dtype of a base's shift: int64 for an int64 base, float64 else."""
    return torch.int64 if base.dtype == torch.int64 else torch.float64


def shift_values(bases, shift, G=None):
    """Per base its shift on the base's device: a 0-d tensor of
    :func:`_kind`, a [G] table of it, or None for no shift; ``shift`` is None
    or one entry a base (None, a number, a 0-d tensor or a [G] table).  A
    table of another dtype or shape raises; at G = 1 a table is its one
    value."""
    if shift is None:
        return [None] * len(bases)
    shift = list(shift)
    if len(shift) != len(bases):
        raise ValueError(f"{len(shift)} shifts for {len(bases)} bases")
    out = []
    for base, s in zip(bases, shift):
        dtype = _kind(base)
        if (isinstance(s, torch.Tensor) and s.dim() == 0 and s.dtype == dtype
                and s.device == base.device):  # already one of these: the host's fast path
            out.append(s)
        elif isinstance(s, torch.Tensor) and s.dim() >= 1:
            if s.dtype != dtype or s.dim() != 1 or (G is not None and s.shape[0] != G):
                raise ValueError(f"a shift table must be [G={G}] {dtype} for a {base.dtype} "
                                 f"base, got {s.dtype} {tuple(s.shape)}")
            out.append(s.reshape(()) if s.shape[0] == 1 and G == 1 else s)
        else:
            out.append(None if s is None else
                       torch.as_tensor(s, device=base.device).to(dtype).reshape(()))
    return out


def per_cell(shifts):
    """True where one of :func:`shift_values`' shifts is a table."""
    return any(s is not None and s.dim() == 1 for s in shifts)


def shifted(base, s):
    """``base - s`` in float64 (s None: the base; s a tensor of the base's
    shape: each row less its own), as the kernels form it: an int64 base
    subtracts in int64 first and rounds once, its magnitude taken as two
    exact 32-bit halves; a float base subtracts in float64."""
    if s is None:
        return base.to(torch.float64)
    if base.dtype != torch.int64:
        return base.to(torch.float64) - torch.as_tensor(s, device=base.device).to(torch.float64)
    s = torch.as_tensor(s, device=base.device).to(torch.int64)
    below = base < s
    mag = torch.where(below, s - base, base - s)  # the bits of the uint64 |base - s|
    f = ((mag >> 32) & 0xFFFFFFFF).to(torch.float64) * 2.0 ** 32 + (mag & 0xFFFFFFFF).to(
        torch.float64)
    return torch.where(below, -f, f)


def row_shift(s, idx, n):
    """Each of n rows' shift: a constant as it is, a table read at the row's
    bin (idx None: bin 0), clamped into [0, G) (a row outside adds nothing)."""
    if s is None or s.dim() == 0:
        return s
    if idx is None:
        return s[0].expand(n)
    return s[idx.clamp(0, s.shape[0] - 1).to(torch.int64)]


def _words(s):
    """A shift's 8-byte words: an int64 as it is, a float64's bits."""
    return s if s.dtype == torch.int64 else s.view(torch.int64)


def shift_words(values, device, G=None):
    """The kernels' shift argument from :func:`shift_values`' ``values``: (an
    int64 tensor on ``device``, True for a table a base).  Without a table
    one 8-byte word a base (an int64 shift, or a float64 shift's bits; 0 for
    none); with one, [nb, G] words, every base's table, constant or 0
    broadcast over the bins.  (None, False) where no base has a shift."""
    if all(s is None for s in values):
        return None, False
    if per_cell(values):
        rows = [torch.zeros(G, dtype=torch.int64, device=device) if s is None
                else _words(s.to(device)).expand(G) for s in values]
        return torch.stack(rows).contiguous(), True
    words = [torch.zeros((), dtype=torch.int64, device=device) if s is None
             else _words(s).to(device) for s in values]
    # one base: a view of its word
    return (words[0].reshape(1) if len(words) == 1 else torch.stack(words)), False


def form_terms(idx, bases, terms, shift=None, G=None):
    """The terms as columns, in plain PyTorch: (count columns [N] int64, 0 or
    1; float columns [N] float64, 0.0 where the term's row is not valid),
    each base less its shift (:func:`shifted`; a table at each row's bin,
    :func:`row_shift`)."""
    n = (idx if idx is not None else bases[0]).shape[0]
    vals = [shifted(b, row_shift(s, idx, n))
            for b, s in zip(bases, shift_values(bases, shift, G))]
    nan = [torch.isnan(v) for v in vals]
    count_terms, float_terms = split_terms(terms, len(bases))

    def invalid(need):
        bad = None
        for j, m in enumerate(nan):
            if need >> j & 1:
                bad = m if bad is None else bad | m
        return bad

    ones = torch.ones(n, dtype=torch.int64, device=vals[0].device if vals else idx.device)
    count_cols = []
    for _, _, need in count_terms:
        bad = invalid(need)
        count_cols.append(ones if bad is None else (~bad).to(torch.int64))
    float_cols = []
    for a, b, need in float_terms:
        v = vals[a] if b < 0 else vals[a] * vals[b]
        bad = invalid(need)
        float_cols.append(v if bad is None else v.masked_fill(bad, 0.0))
    return count_cols, float_cols


def check_inputs(idx, bases, terms, G, bin0=False, shift=None):
    """The checks both moment kernels' wrappers make before they dispatch;
    ``bin0``: idx may be None at G = 1 (B4).  Returns the shifts as
    :func:`shift_values` gives them."""
    if idx is None:
        if not (bin0 and G == 1 and bases):
            raise TypeError("idx may be None only for B4 at G = 1 with a base column")
    elif idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be 1-d int32, got {idx.dtype} with shape {tuple(idx.shape)}")
    if len(bases) > MAX_BASES or not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"{len(bases)} bases and {len(terms)} terms: the kernels take at "
                         f"most {MAX_BASES} bases and 1 to {MAX_TERMS} terms")
    rows = idx if idx is not None else bases[0]
    for col in bases:
        if col.dtype not in BASE_KINDS:
            raise TypeError(f"bases must be int64, float32 or float64, got {col.dtype}")
        if col.dim() != 1 or col.shape != rows.shape:
            raise ValueError(f"base shape {tuple(col.shape)} does not match idx "
                             f"{tuple(rows.shape)}")
        if col.device != rows.device:
            raise ValueError(f"base on {col.device}, idx on {rows.device}")
    if G < 1:
        raise ValueError(f"nothing to add: G={G}")
    split_terms(terms, len(bases))
    values = shift_values(bases, shift, G)
    for s in values:
        if s is not None and s.device != rows.device:
            raise ValueError(f"shift on {s.device}, idx on {rows.device}")
    return values


def table_bases(values):
    """The bases whose shifts a call keeps in shared memory, from
    :func:`shift_values`' ``values``: all of them where one has a table
    (:func:`shift_words`), else none."""
    return len(values) if per_cell(values) else 0


def grid_moments_reference(idx, bases, terms, G, shift=None):
    """The plain PyTorch version: the term columns, then ``index_add_``
    (idx None: every row in bin 0)."""
    if idx is None:
        idx = torch.zeros(bases[0].shape[0], dtype=torch.int32, device=bases[0].device)
    count_cols, float_cols = form_terms(idx, bases, terms, shift, int(G))
    return grid_additive_reference(idx, count_cols, float_cols, int(G), False)


def grid_moments_window_reference(idx, bases, terms, G, shift=None):
    """The plain PyTorch version of B5: the term columns, then the kernel's
    bin windows (:func:`part_plan`) one after the other, each an
    ``index_add_`` of every term."""
    count_cols, float_cols = form_terms(idx, bases, terms, shift, int(G))
    W, _, _ = part_plan(int(G), len(terms), len(count_cols),
                        table_bases(shift_values(bases, shift, int(G))))
    return grid_window_reference(idx, count_cols, float_cols, int(G), False, W)


def table_bytes(nb, G):
    """Shared memory of a B4 CTA's copy of ``nb`` bases' shift tables: 8
    bytes a base and bin (0 without a table)."""
    return 8 * nb * G


def fits(G, C, nb_table=0):
    """True when one warp's ordered [C, G] grid fits B4's shared memory, and
    beside it the shift tables of ``nb_table`` bases."""
    return (1 <= C <= MAX_TERMS and warp_bytes(C, G) <= SMEM_BUDGET
            and table_bytes(nb_table, G) <= CLUSTER_SMEM - SMEM_BUDGET)


def lane_rows(nb):
    """Rows a lane of B4's lane route takes per step with nb bases
    (lane_rows in csrc/grid_moments.cu, checked at load)."""
    return 32 if nb <= 1 else 16 if nb == 2 else 8


def lane_warp_bytes(G, n_count, n_float):
    """Shared memory of one warp's lane grids on B4's lane route: per lane and
    bin a 32-bit word per count term and 8 bytes per float term."""
    return 32 * G * (4 * n_count + 8 * n_float)


def compiled(n_bases, terms):
    """The compiled term set of a batch, by its bases: 1 for var's (one
    base: a count, x and x*x), 2 for corr's (two: a count, x*y, x, x*x, y
    and y*y), each term valid where every base is, in any order of the float
    terms; B4's lane route compiles them (SET_VAR, SET_CORR: term_set in
    csrc/moments_common.cuh).  0 for any other batch: the run-time tables."""
    want = COMPILED_SETS.get(n_bases)
    counts, floats = split_terms(terms, n_bases)
    every = (1 << n_bases) - 1
    if want is None or len(counts) != 1 or any(
            need != every for *_, need in counts + floats):
        return 0
    return n_bases if [floats[k][:2] for k in float_order(terms)] == want else 0


def route(G, n_count, n_float, compiled_set=1, nb_table=0):
    """``lane`` or ``warp``: B4's lane route while a CTA of 227 KiB holds
    ``LANE_MIN_WARPS[compiled_set]`` warps of its lane grids (the set as
    :func:`compiled` names it) beside the shift tables of ``nb_table``
    bases, else its warp route."""
    warps = LANE_MIN_WARPS[compiled_set]
    if warps * lane_warp_bytes(G, n_count, n_float) + table_bytes(nb_table, G) <= CLUSTER_SMEM:
        return LANE
    return WARP


def lane_plan(n, G, n_count, n_float, nb, sm_count, nb_table=0):
    """(n_ctas, warps) of one launch of B4's lane route: as many warps a CTA
    as its lane grids fit beside the shift tables (at most ``MAX_WARPS``),
    the CTAs the card holds at once, fewer where the rows would give a warp
    less than its share."""
    wb, tb = lane_warp_bytes(G, n_count, n_float), table_bytes(nb_table, G)
    warps = max(1, min(MAX_WARPS, (CLUSTER_SMEM - tb) // wb))
    ctas_per_sm = max(1, min(SM_THREADS // (warps * 32), SM_SMEM // (warps * wb + tb)))
    rows_per_cta = warps * 32 * lane_rows(nb) * MIN_STEPS_PER_WARP
    n_ctas = max(1, min(sm_count * ctas_per_sm, -(-n // rows_per_cta)))
    return n_ctas, warps


def _library(name):
    lib = kernel_build.library(name, CLUSTER_SMEM if name == "grid_moments_window" else
                               SMEM_BUDGET, MAX_TERMS)
    max_bases = getattr(lib, f"{name}_max_bases")
    max_bases.restype = ctypes.c_int
    if max_bases() != MAX_BASES:
        raise RuntimeError(f"{name}_max_bases disagrees with its wrapper")
    run = getattr(lib, f"{name}_run")
    run.restype = ctypes.c_int
    if name == "grid_moments":
        rows = lib.grid_moments_lane_rows
        rows.restype = ctypes.c_int
        if any(rows(nb) != lane_rows(nb) for nb in range(MAX_BASES + 1)):
            raise RuntimeError("grid_moments_lane_rows disagrees with its wrapper")
        run.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        return lib, run
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    run.argtypes = [ptr, ctypes.c_longlong, i32, i32, i32,  # idx, n, G, W, n_win
                    ptr, i32, ptr,  # group bounds, term rows
                    ptr, ptr, i32, ptr, i32,  # bases, shift words, per cell
                    ptr, ptr, ptr, i32, i32,  # terms
                    i32, i32,  # n_slices, threads
                    ptr, ptr, ptr, ptr]
    return lib, run


def bin_bytes(C, n_count=1, nb_table=0):
    """Shared memory of one bin of all C terms in a B5 part: a 32-bit word
    per count term, 8 bytes per float term, and 8 a base of its shift
    tables."""
    return 4 * n_count + 8 * (C - n_count) + 8 * nb_table


def window_width(C, n_count=1, nb_table=0):
    """The widest bin window of B5: one term's plane of it (8 bytes a bin
    for a float term, 4 where all terms are counts) and the window's slice
    of ``nb_table`` shift tables fill ``CLUSTER_SMEM``; even, so the float
    planes after 32-bit count planes stay 8-byte aligned."""
    return (CLUSTER_SMEM // ((8 if C > n_count else 4) + 8 * nb_table)) & ~1


def term_groups(W, C, n_count=1, nb_table=0):
    """The fewest groups of consecutive terms (counts first) whose planes
    of W bins, beside the window's shift tables, fit ``CLUSTER_SMEM``, of
    near-equal size: their boundaries [0, ..., C]."""
    def fits(lo, hi):
        return W * bin_bytes(hi - lo, max(0, min(hi, n_count) - lo), nb_table) <= CLUSTER_SMEM
    bounds, lo = [0], 0  # greedy: the fewest groups
    for k in range(1, C + 1):
        if not fits(lo, k):
            bounds.append(k - 1)
            lo = k - 1
    n_groups = len(bounds)
    even = [round(g * C / n_groups) for g in range(n_groups + 1)]
    if all(fits(lo, hi) for lo, hi in zip(even, even[1:])):
        return even
    return bounds + [C]


def part_plan(G, C, n_count=1, nb_table=0):
    """(W, n_win, group bounds) of a B5 call: the fewest windows of equal
    even width in which one term's plane fits beside ``nb_table`` bases'
    shift tables, then the fewest term groups that fit such a window
    (:func:`term_groups`)."""
    n_win = -(-G // window_width(C, n_count, nb_table))
    W = -(-G // n_win)
    W += W & 1
    return W, n_win, term_groups(W, C, n_count, nb_table)


def n_parts(G, C, n_count=1, nb_table=0):
    """The CTAs of one row slice of B5: windows times term groups."""
    _, n_win, bounds = part_plan(G, C, n_count, nb_table)
    return n_win * (len(bounds) - 1)


def window_plan(n, G, C, sm_count, n_count=1, nb_table=0):
    """(W, n_win, group bounds, n_slices) of one B5 launch: a CTA per part
    and row slice, the CTAs of all parts together filling the card once."""
    W, n_win, bounds = part_plan(G, C, n_count, nb_table)
    parts = n_win * (len(bounds) - 1)
    smem = max(W * bin_bytes(hi - lo, max(0, min(hi, n_count) - lo), nb_table)
               for lo, hi in zip(bounds, bounds[1:]))
    resident = sm_count * max(1, min(SM_THREADS // (WINDOW_WARPS * 32), SM_SMEM // smem))
    rows_per_cta = WINDOW_WARPS * STAGE_ROWS * MIN_STEPS_PER_WARP
    n_slices = max(1, min(resident // parts, -(-n // rows_per_cta), 65535))
    return W, n_win, bounds, n_slices


def _tables(bases, terms):
    """HOST arrays of the base pointers and kinds and of the term tables
    (counts first), as both moment libraries take them."""
    count_terms, float_terms = split_terms(terms, len(bases))
    ordered = count_terms + float_terms  # the kernels' row order: counts first
    base_ptrs = (ctypes.c_void_p * MAX_BASES)(*[b.data_ptr() for b in bases])
    base_kinds = (ctypes.c_int * MAX_BASES)(*[BASE_KINDS[b.dtype] for b in bases])
    term_a = (ctypes.c_int * MAX_TERMS)(*[a for a, _, _ in ordered])
    term_b = (ctypes.c_int * MAX_TERMS)(*[b for _, b, _ in ordered])
    term_need = (ctypes.c_uint * MAX_TERMS)(*[need for _, _, need in ordered])
    return (len(count_terms), len(float_terms), base_ptrs, base_kinds, term_a, term_b,
            term_need)


def _outputs(device, n_count, n_float, G, n_parts):
    counts = torch.empty((n_count, G), dtype=torch.int64, device=device)
    sums = torch.empty((n_float, G), dtype=torch.float64, device=device)
    scratch = torch.empty(n_parts * (n_count + n_float) * G, dtype=torch.int64, device=device)
    return counts, sums, scratch


def _launch_b4(idx, bases, terms, G, n_ctas, warps, lane, shift=None):
    """One launch of ``csrc/grid_moments.cu`` on its lane route (``lane``)
    or its warp route; idx None passes no index (G = 1).  The float terms go
    in :func:`float_order` and their sums come back in the caller's."""
    order = float_order(terms)
    floats = [t for t in terms if t[0] >= 0]
    n_count, n_float, *tables = _tables(
        bases, [t for t in terms if t[0] < 0] + [floats[k] for k in order])
    base_ptrs, base_kinds, term_a, term_b, term_need = tables
    rows = idx if idx is not None else bases[0]
    counts, sums, scratch = _outputs(rows.device, n_count, n_float, G, n_ctas)
    words, table = shift_words(shift, rows.device, G)
    lib, run = _library("grid_moments")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = run(None if idx is None else idx.data_ptr(), rows.shape[0], G, G,
                  ctypes.addressof(base_ptrs), ctypes.addressof(base_kinds), len(bases),
                  None if words is None else words.data_ptr(), int(table),
                  ctypes.addressof(term_a), ctypes.addressof(term_b),
                  ctypes.addressof(term_need), n_count, n_float,
                  n_ctas, warps, int(lane), scratch.data_ptr(),
                  counts.data_ptr(), sums.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_moments", err)
    if order != sorted(order):
        back = sorted(range(n_float), key=order.__getitem__)  # row of caller's term k
        sums = sums.index_select(0, torch.tensor(back, device=sums.device))
    return counts, sums


def float_order(terms):
    """B5's order of the float terms (indices among them): the terms of two
    bases first, then those of one base, base by base, so that a group of
    consecutive terms keeps one base's terms together (corr: x*y, x, x*x, y,
    y*y; a part of x and x*x then loads no y where y cannot be NaN)."""
    floats = [(a, b) for a, b, *_ in terms if a >= 0]

    def key(k):
        a, b = floats[k]
        bits = 1 << a | (1 << b if b >= 0 else 0)
        return -bin(bits).count("1"), bits
    return sorted(range(len(floats)), key=key)


def _launch_b5(idx, bases, terms, G, shift=None):
    """One launch of ``csrc/grid_moments_window.cu``: the float terms go in
    :func:`float_order`, and the kernel writes each to the caller's row."""
    order = float_order(terms)
    floats = [t for t in terms if t[0] >= 0]
    ordered = [t for t in terms if t[0] < 0] + [floats[k] for k in order]
    n_count, n_float, *tables = _tables(bases, ordered)
    base_ptrs, base_kinds, term_a, term_b, term_need = tables
    term_row = (ctypes.c_int * MAX_TERMS)(*range(n_count), *[n_count + k for k in order])
    n, C = idx.shape[0], n_count + n_float
    sm_count = torch.cuda.get_device_properties(idx.device).multi_processor_count
    words, table = shift_words(shift, idx.device, G)
    W, n_win, bounds, n_slices = window_plan(n, G, C, sm_count, n_count,
                                             len(bases) if table else 0)
    group_lo = (ctypes.c_int * (MAX_TERMS + 1))(*bounds)
    counts, sums, scratch = _outputs(idx.device, n_count, n_float, G, n_slices)
    lib, run = _library("grid_moments_window")
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = run(idx.data_ptr(), n, G, W, n_win, ctypes.addressof(group_lo), len(bounds) - 1,
                  ctypes.addressof(term_row),
                  ctypes.addressof(base_ptrs), ctypes.addressof(base_kinds), len(bases),
                  None if words is None else words.data_ptr(), int(table),
                  ctypes.addressof(term_a), ctypes.addressof(term_b),
                  ctypes.addressof(term_need), n_count, n_float, n_slices, WINDOW_WARPS * 32,
                  scratch.data_ptr(), counts.data_ptr(), sums.data_ptr(), stream)
    kernel_build.raise_on_error(lib, "grid_moments_window", err)
    return counts, sums


def grid_moments(idx, bases, terms, G, shift=None):
    """Per-bin term sums through B4; see the module docstring (idx None:
    every row in bin 0, G = 1).  CPU tensors take the plain version; CUDA
    tensors launch the kernel, or raise when it cannot take them."""
    G = int(G)
    bases, terms = list(bases), [tuple(t) for t in terms]
    shift = check_inputs(idx, bases, terms, G, bin0=True, shift=shift)
    rows = idx if idx is not None else bases[0]
    if rows.device.type == "cpu":
        return grid_moments_reference(idx, bases, terms, G, shift)
    check_cuda("grid_moments", rows, bases, [])
    C, n = len(terms), rows.shape[0]
    nb_table = table_bases(shift)
    if not fits(G, C, nb_table):
        raise ValueError(f"grid_moments: G={G} with {C} terms does not fit the kernel")
    n_count = sum(t[0] < 0 for t in terms)
    how = route(G, n_count, C - n_count, compiled(len(bases), terms), nb_table)
    if how == LANE and n >= 2 ** 32:
        raise ValueError(f"grid_moments: {n} rows in one call; the lane route's 32-bit "
                         f"counts take fewer than 2^32")
    sm_count = torch.cuda.get_device_properties(rows.device).multi_processor_count
    if how == LANE:
        n_ctas, warps = lane_plan(n, G, n_count, C - n_count, len(bases), sm_count, nb_table)
    else:
        n_ctas, warps = plan(n, G, C, sm_count)
    out = _launch_b4(idx, bases, terms, G, n_ctas, warps, how == LANE, shift)
    grid_moments.launches += 1
    grid_moments.last_route = how
    return out


def grid_moments_window(idx, bases, terms, G, shift=None):
    """Per-bin term sums through B5; see the module docstring.  CPU tensors
    take the plain version; CUDA tensors launch the kernel, or raise when it
    cannot take them."""
    G = int(G)
    bases, terms = list(bases), [tuple(t) for t in terms]
    shift = check_inputs(idx, bases, terms, G, shift=shift)
    if idx.device.type == "cpu":
        return grid_moments_window_reference(idx, bases, terms, G, shift)
    check_cuda("grid_moments_window", idx, bases, [])
    C = len(terms)
    if C * G >= 2 ** 31:
        raise ValueError(f"grid_moments_window: G={G} with {C} terms does not fit the kernel")
    if idx.shape[0] >= 2 ** 31:
        raise ValueError(f"grid_moments_window: {idx.shape[0]} rows in one call; its 32-bit "
                         f"counts take fewer than 2^31")
    counts, sums = _launch_b5(idx, bases, terms, G, shift)
    grid_moments_window.launches += 1
    grid_moments_window.last_parts = n_parts(G, C, len(counts), table_bases(shift))
    return counts, sums


grid_moments.launches = 0
grid_moments.last_route = None  # the route of the last launch
grid_moments_window.launches = 0
grid_moments_window.last_parts = None  # the parts of the last launch
