#!/usr/bin/env python3
"""Times the two designs weighed for the route past B3's limits
(``vaex_tpu_torch/ops/grid_sort.py``, ``"sort"``) against each other on one
GPU, at the grids of ``chip_smoke.py``'s phase 19:

* scatter: every row straight into the grid, ``index_add_`` /
  ``scatter_reduce_`` (what ``grid_sort`` does, the reference's backstop
  past ``SORT_MAX_G``);
* sort: ``torch.sort`` of the bin index carrying the row numbers, then per
  run of equal bins a count, a segment sum of each float column
  (``index_add_`` over the sorted segment ids) and one write of each run
  into the grid; for a max a sort by value, then a stable sort by bin, and
  the last row of each run (the reference's ``sort_carry`` +
  ``sorted_additive`` and its lexicographic extreme sort).

    python3 scripts/sweep_grid_sort.py [N]        (default N = 1e8)

x, y, z uniform in [0, 1) and v normal, made on the card from seed 42; the
bins as the port bins them (minmax limits, three edge bins per axis); the
rows in a pass's tiles of 2^26 into grids allocated once.  Per grid: count
and mean at 12 000^2, std (count, sum, sum of squares) at 12 000^2, max at
8192^2, count at 512^3; both designs checked against each other (ints and
maxima exact, float sums within ``chip_smoke.within_sum_bound``), then
timed with CUDA events (a warm-up, then the mean of 3), beside the bound:
the index and the columns read once, one read-modify-write of each touched
grid word, at 3.35 TB/s.  Then the four std's at 4096^2 (12 terms) on the
split route (B3's partition in two calls) against the scatter over the
formed terms.  Prints one line per grid after the card's name and power
limit; exits non-zero on a mismatch.
"""

import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from chip_smoke import PEAK_BYTES, SEED, card, cuda_ms, within_sum_bound  # noqa: E402

TILE = 1 << 26


def scatter_sums(idx, floats, G, count, int_rows, float_rows):
    from vaex_tpu_torch.ops import grid_sort
    grid_sort.grid_sort(idx, [], floats, G, count, out=(int_rows, float_rows))


def sort_sums(idx, floats, G, count, int_rows, float_rows):
    """One tile by the sort: the bins sorted carrying the row numbers, then
    per run a count and a segment sum, written once into the grid."""
    cells = torch.where((idx >= 0) & (idx < G), idx, G)
    sorted_cells, perm = torch.sort(cells)
    starts = torch.ones_like(sorted_cells, dtype=torch.bool)
    starts[1:] = sorted_cells[1:] != sorted_cells[:-1]
    first = torch.nonzero(starts).squeeze(1)
    heads = sorted_cells[first].to(torch.int64)
    inside = heads < G
    if count:
        ends = torch.cat([first[1:], first.new_tensor([cells.shape[0]])])
        int_rows[0].index_add_(0, heads[inside], (ends - first)[inside])
    seg = torch.cumsum(starts, 0) - 1
    for row, col in zip(float_rows, floats):
        v = col[perm]
        part = torch.zeros(first.shape[0], dtype=torch.float64, device=idx.device)
        part.index_add_(0, seg, torch.where(torch.isnan(v), 0.0, v))
        row.index_add_(0, heads[inside], part[inside])


def scatter_max(idx, cols, G, grid):
    from vaex_tpu_torch.ops import grid_sort
    grid_sort.grid_sort_extreme(idx, cols, ["max"], [None], G, out=[grid])


def sort_max(idx, cols, G, grid):
    """One tile's max by the sort: by value, then stably by bin, the last
    row of each run of a bin holds its max."""
    (v,) = cols
    cells = torch.where((idx >= 0) & (idx < G) & ~torch.isnan(v), idx, G)
    by_value = torch.argsort(v)
    sorted_cells, by_cell = torch.sort(cells[by_value], stable=True)
    last = torch.ones_like(sorted_cells, dtype=torch.bool)
    last[:-1] = sorted_cells[:-1] != sorted_cells[1:]
    heads = sorted_cells[last].to(torch.int64)
    values = v[by_value][by_cell][last]
    inside = heads < G
    grid.scatter_reduce_(0, heads[inside], values[inside], "amax", include_self=True)


def pass_of(route, idx, cols, G, *args):
    """route over the rows in a pass's tiles."""
    n = idx.shape[0]
    for i in range(0, n, TILE):
        route(idx[i:i + TILE], [c[i:i + TILE] for c in cols], G, *args)


def bins_of(cols, names, shape):
    from vaex_tpu_torch.ops.binners import BinnerScalar, fuse_bins, grid_size
    from vaex_tpu_torch.ops.nullable import NA
    binners = []
    for name in names:
        lo, hi = torch.aminmax(cols[name])
        binners.append(BinnerScalar(name, float(lo), float(hi), shape))
    idx = fuse_bins(binners, [b.to_bins(NA(cols[b.expression])) for b in binners])
    return idx, grid_size(binners)


def bound_ms(n, n_cols, touched, channels):
    return (n * (4 + 8 * n_cols) + touched * channels * 16) / PEAK_BYTES * 1e3


def sums_case(label, name, idx, G, floats, count):
    n = idx.shape[0]
    C_int, C_f = int(count), len(floats)
    grids = {}
    times = {}
    for design, route in (("scatter", scatter_sums), ("sort", sort_sums)):
        int_rows = [torch.zeros(G, dtype=torch.int64, device="cuda") for _ in range(C_int)]
        float_rows = [torch.zeros(G, dtype=torch.float64, device="cuda") for _ in range(C_f)]

        def run():
            for r in int_rows + float_rows:
                r.zero_()
            pass_of(route, idx, floats, G, count, int_rows, float_rows)
        times[design] = cuda_ms(run, 3)
        grids[design] = (int_rows, float_rows)
    (si, sf), (oi, of) = grids["scatter"], grids["sort"]
    for a, b in zip(si, oi):
        if not torch.equal(a, b):
            raise RuntimeError(f"{name}: the designs' counts differ")
    counts = si[0] if count else None
    for k, (a, b) in enumerate(zip(sf, of)):
        abs_rows = [torch.zeros(G, dtype=torch.float64, device="cuda")]
        scatter_sums(idx, [floats[k].abs()], G, False, [], abs_rows)
        if not within_sum_bound(a, b, abs_rows[0], counts):
            raise RuntimeError(f"{name}: the designs' float sums differ past the bound")
    touched = int((counts > 0).sum()) if count else G
    bound = bound_ms(n, len(floats), touched, C_int + C_f)
    print(f"[{label}] {name} G={G} N={n} touched {touched}: scatter {times['scatter']!r} ms, "
          f"sort {times['sort']!r} ms; bound {bound!r} ms", flush=True)
    del grids
    torch.cuda.empty_cache()
    return times, bound


def max_case(label, name, idx, G, v):
    n = idx.shape[0]
    grids, times = {}, {}
    for design, route in (("scatter", scatter_max), ("sort", sort_max)):
        grid = torch.full((G,), float("-inf"), dtype=torch.float64, device="cuda")

        def run():
            grid.fill_(float("-inf"))
            pass_of(route, idx, [v], G, grid)
        times[design] = cuda_ms(run, 3)
        grids[design] = grid
    if not torch.equal(grids["scatter"], grids["sort"]):
        raise RuntimeError(f"{name}: the designs' maxima differ")
    touched = int((grids["scatter"] > float("-inf")).sum())
    bound = bound_ms(n, 1, touched, 1)
    print(f"[{label}] {name} G={G} N={n} touched {touched}: scatter {times['scatter']!r} ms, "
          f"sort {times['sort']!r} ms; bound {bound!r} ms", flush=True)
    del grids
    torch.cuda.empty_cache()


def split_case(label, cols, n):
    """Four std's at 4096^2, twelve terms: the plan's split into two calls
    of B3's partition against the scatter over the formed terms."""
    from vaex_tpu_torch.ops import grid_moments as gm
    from vaex_tpu_torch.ops import grid_plan, grid_sort
    idx, G = bins_of(cols, ["x", "y"], 4096)
    bases = [cols[c] for c in "xyzv"]
    terms = []
    for b in range(4):
        terms += [(-1, -1, b, -1), (b, -1, -1, -1), (b, b, -1, -1)]
    name = grid_plan.moment_strategy(n, G, len(terms), 4, gm.compiled(len(bases), terms))

    def split():
        for i in range(0, n, TILE):
            grid_plan.moment_sums(idx[i:i + TILE], [b[i:i + TILE] for b in bases], terms, G)

    def scatter():
        for i in range(0, n, TILE):
            t = idx[i:i + TILE]
            counts, floats = gm.form_terms(t, [b[i:i + TILE] for b in bases], terms)
            grid_sort.grid_sort(t, counts, floats, G, False)
    split_ms, scatter_ms = cuda_ms(split, 3), cuda_ms(scatter, 3)
    print(f"[{label}] std of four 4096^2 G={G} N={n} (12 terms): {name} {split_ms!r} ms, "
          f"scatter over the formed terms {scatter_ms!r} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        print("sweep_grid_sort: no CUDA device", file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(float(args[0])) if args else 100_000_000
    label = card()
    print(label, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cols = {c: torch.rand(n, generator=gen, device="cuda", dtype=torch.float64) for c in "xyz"}
    cols["v"] = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64)
    idx, G = bins_of(cols, ["x", "y"], 12_000)
    v = cols["v"]
    sums_case(label, "count 12000^2", idx, G, [], True)
    sums_case(label, "mean 12000^2", idx, G, [v], True)
    sums_case(label, "std 12000^2", idx, G, [v, v * v], True)
    del idx
    idx, G = bins_of(cols, ["x", "y"], 8192)
    max_case(label, "max 8192^2", idx, G, v)
    del idx
    idx, G = bins_of(cols, ["x", "y", "z"], 512)
    sums_case(label, "count 512^3", idx, G, [], True)
    del idx
    torch.cuda.empty_cache()
    split_case(label, cols, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
