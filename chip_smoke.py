#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vaex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card.  It

1. prints the card's name and power limit, and the torch and CUDA versions;
2. builds the seven kernels (five grid kernels, the min/max mode B3x that
   shares grid_partition.cu with B3, and the set probe) from
   vaex_tpu_torch/csrc with nvcc, one nvcc per source, all at once;
3. holds B1 (grid_additive) against its plain PyTorch version on the card,
   at G in {1, 103, 512, largest that fits} and N in {0, 1, 1_000_003, 1e8}:
   int64 values from +-2^62 (sums wrap) and the count exact, float64 from
   N(0, 100) to rtol 1e-9 and atol 1e-9; then both of its routes (the
   lane-private grids and the warp-private ones) at the lane route's edges,
   G in {1, 2, 103, 128} with the count alone, f64, f32 with NaN, int64 +
   f64 and two int64 + f64, columns starting at row 0 and at an odd row,
   the planned route asserted;
4. holds the wide-grid kernels B2 (grid_window) and B3 (grid_partition:
   its partition route b3 and its resident route b3-l2) against their
   plain versions the same way, with some NaN among the floats, at G in
   {B1 limit + 1, 10 609, B2 limit, B2 limit + 1, 100 003, 1 000 003,
   4 000 037} through the kernel the plan picks (printed) and, past B2's
   limit, through both routes of B3, plus both routes on pre-sorted keys,
   on one key and on a Zipf(1.1) draw at G = 1 000 003; then B2 at the
   edges of its thread-block cluster, G = k * W and k * W + 1 for k = 1 ..
   8 windows of the widest window W, at C = 1 (count), 2 (+ int64), 3
   (+ f64 with NaN) and 4 (+ f32), N = 1_000_003 (past 8 windows the
   wrapper must refuse); B2 and B3 add floats in no fixed order, so their
   float sums are held to the error bound of float64 summation in any
   order, per cell rtol 1e-9 * |want| + 1e-9 + n_cell * 2^-52 * S_cell
   (S_cell the cell's sum of |value|, n_cell its rows: within_sum_bound);
5. holds the moment kernels B4 (grid_moments) and B5 (grid_moments_window)
   against their plain versions, through the kernel the plan picks
   (printed), for the terms of var (an f64 column) and of corr (two f64
   columns), with NaN among both, at G in {1, 103, B4's limit at C = 6,
   that + 1, 10 609, B5's limit} and N in {0, 1, 1_000_003, 1e8}: counts
   exact, B4's float sums to rtol 1e-9 and atol 1e-9, B5's (no fixed order)
   to the bound of phase 4, which a cell whose x*y sum nearly cancels
   also meets; then B5 where its parts
   change (a term group or a window one bin past full) on columns starting
   at an odd row, and at G = 10 609 on f32 and int64 bases, on one key and
   on a Zipf(1.1) draw, its parts asserted; then B4's lane route at G = 1
   (also without an index), 103 and its last G for var and corr (both
   compiled sets) on f64, f32 and int64 bases starting at an odd row, the
   route asserted, floats bit-equal run to run; then shifted moments: B4 at
   G = 1 (no index) and 103 and B5 at 10 609, var and corr, with a shift
   per base in device memory against the plain versions with the same
   shift, on f64 and f32 bases at offsets 1e6 and 1e8 and int64 bases near
   2^62 and across a span past 2^63;
6. drives the main path through the public API: a device-resident table
   of N = 1e8 and 4e8 rows (int64 key with K = 100 categories, float64
   value, made on the card from seed 42), categorize, then
   groupby(sum, count, sort=True) and df.sum, checked against
   torch.bincount / index_add_, with B1's launch count and its lane route
   asserted;
7. drives the wide-grid path through the public API: an H2O-groupby-shaped
   table of N = 1e8 rows made on the card from seed 42 (id4, id5 int64 in
   1..100, id6 int64 in 1..1e6, v1, v2 int64 in 1..5, v3 float64 in
   [0, 100)), the keys categorized, then q2 groupby(["id4", "id5"],
   {"v1": sum}, sort=True), count(binby=["id4", "id5"]), q3
   groupby("id6", {"v1": sum, "v3": mean}), q5 groupby("id6",
   {"v1", "v2", "v3": sum}) (both b3-l2: three channels of 1e6 bins stay in
   L2) and q5 with a count beside its sums (four channels: b3), each checked
   against torch.bincount / index_add_, with each kernel's launch count and
   the strategy each pass recorded, both asserted per query;
8. drives the statistics path through the public API on the same table:
   q6's sd part groupby(["id4", "id5"], {"sd_v3": std("v3", ddof=1)},
   sort=True), q9 groupby(["id4", "id5"], {"r2": corr("v1", "v2")}), q7
   groupby("id6", {"max_v1": max("v1"), "min_v2": min("v2")}),
   df.std("v3") and df.std("v3", binby=["id4"]), each checked against
   plain torch (index_add_ of the formed moments, then the same formula;
   scatter_reduce for q7), with B4's and B5's launch counts, the
   strategies, B4's lane route and B5's parts asserted per query (q6-sd one
   part, q9 three);
9. times the main-path groupby, the five wide queries and the five
   statistics against plain PyTorch (5 repetitions, medians), and every
   kernel against its plain version and against its HBM floor at the copy
   bandwidth measured in the same run (B1 also on its warp route and at
   the isin count's G = 1, B4 also at df.std's G = 1, without an index as
   df.std calls it, against torch.var_mean, B5 also at q6-sd's shape);
10. holds both routes of B6 (probe: a static search tree, wholly in
    shared memory on b6, its top levels there and the rest in global memory
    on b6-wide) against its plain version (searchsorted, gather, compare):
    int64 and float64 keys, M in {1, 15, 16, 17, 64, 500, 2048, MAX_KEYS,
    MAX_KEYS + 1, 50 000, b6's limit on 4-byte keys and that + 1,
    1 000 003} (an int set of 16 384 keys or more whose range is below
    2^32 on 4-byte keys, and the same sets spread past 2^32 on 8-byte
    keys), N in {0, 1, 1_000_003, 1e8}, rows that hit, miss, lie below the
    first and above the last key, and -0.0 and NaN among the floats; a set
    holding INT64_MIN and INT64_MAX, one holding +-inf, 0.0 and the largest
    float, and int sets spanning exactly 2^32 - 1 (4-byte keys) and 2^32
    (8-byte keys); exact, with the route and its launches asserted;
11. drives the set-based path through the public API on the H2O-shaped
    table WITHOUT categorize: df.count(selection=df.id6.isin(v)) and
    df[df.id6.isin(v)].groupby("id4", {"v1": sum, "v3": mean}) with v = 500
    ids drawn from seed 42, the same count with 50 000 ids (b6 on 4-byte
    keys), groupby over the raw id4 (dense
    grouper, B1) and
    the raw id6 (dense grouper, B3), the GroupBy (built first, then its
    agg: with agg= such a wide int key takes the one-sort plan) over
    k = id4 * 1_000_003 and
    k = (id6 % 2000) * 1_000_003 (set grouper: set build, then the ordinals
    through B6 at M = 100 and 2000, then B1 and B2) and k = id6 * 1_000_003
    (M = 1e6: b6-wide, then B3), df.id6.nunique() and df.id4.unique(),
    each checked against plain torch (isin, unique, bincount, index_add_),
    with B6's launch count and the probe route each pass recorded;
12. times those queries against plain PyTorch (the dense pre-pass included
    and, beside it, remembered), and B6 at the isin shapes (500 and 50 000
    ids: b6) and at the set grouper of k1e6 (b6-wide) against its plain
    version and torch.isin, on a tree built before the timing;
13. holds B3x (the min/max mode of the partitioned kernel: its direct and
    partition routes, grid_partition_extreme, and its resident route b3x-l2,
    grid_resident_extreme) against its plain version (scatter_reduce_ with a
    drop bin) at G in {1, 103, 10 609, 67 081, 1 000 003, 1 054 729} and N in
    {0, 1, 1_000_003, 1e8}: an int64 min, an f64 max with NaN, +-inf and
    -0.0, an f32 min, an f64 min and an int64 max under a validity mask, on
    each route and with count + int64 + f64 sums riding the same partition,
    and again at G = 1 000 003 on pre-sorted keys, on one key and on a
    Zipf(1.1) draw; extremes exact by value, int sums exact, float sums to
    the bound of phase 4;
14. drives the binned-statistics path through the public API: beside the
    H2O-shaped columns (id4 and id6 categorized) x, y float64 normal, v
    float64 uniform in [0, 100) with 1% NaN and t int64, made on the card
    from seed 42, 1e8 rows: limits(["x", "y"], "minmax"), limits("x",
    "99.7%"), count(binby=[x, y], shape=256), mean(v, binby=[x, y],
    shape=1024), max(v, binby=[x, y], shape=1024) (G = 1 054 729, b3x-l2)
    and shape=2000 (G = 4 012 009: 32 MB of keys, past L2: b3x), minmax(v,
    binby=x, shape=128) (b3x-direct), q7 on id6, groupby(id6, {sum v1, max
    v1, min v2}) (sums on b3-l2, extremes on b3x-l2), first(v, t, binby=id4)
    and first(v, t53, binby=id4) with int64 orders past 2^53 (compared as
    int64: the float64 answer differs), each checked against plain torch on
    the same tensors, with the route each pass recorded and each route of
    B3x launched; and first on a small card frame where a cell's only order
    is INT64_MAX;
15. times those queries against plain PyTorch, and each route of B3x at its
    query's shape against its plain version and scatter_reduce_: b3x-l2 at
    the 2-D max of shape 1024 and at q7's, b3x at the 2-D max of shape 2000,
    b3x-direct at minmax by x;
16. drives BASELINE config 2 through the public API: x, y float64 N(0, 1)
    (every 97th x NaN), z float64 U[0, 100), i int64 in 0..999, 1e8 rows
    made on the card from seed 42; the virtual columns r = sqrt(x**2 +
    y**2), phi = arctan2(y, x), w = log1p(z) * exp(-r), zc = clip(z, 10,
    90); the filter r < 2; select_circle("x", "y", 0.5, 0, 1); then as one
    pass mean, std, min and max of [r, phi, w, zc], mean([r, w],
    selection=[None, True]) and count(binby=phi, limits=[-pi, pi],
    shape=64, selection=True), checked against the same expressions written
    in torch (counts, min and max exact, means and stds within the bound of
    phase 4), with B1's launches (three a tile, lane route), B4's (one a
    tile, lane route) and the strategies asserted, and no other kernel
    launched; then the group timed against plain torch (5 repetitions,
    medians);
17. drives BASELINE config 3, the H2O groupby suite: the table of
    benchmarks/fixtures.py:28-40 at 1e8 rows made on the card from seed 42
    (id1, id2, id4, id5 int64 in 1..100, id3 and id6 in 1..1e6, v1 in 1..5,
    v2 in 1..15, v3 float64 in [0, 100)), raw and uncategorized, then q1-q10
    as benchmarks/groupbyh2o.py:25-45 writes them, each checked against
    plain torch (bincount / index_add_ over the dense cells, two stable
    sorts for q6's median and q8's top two, torch.unique over the stacked
    keys for q10; keys, ints, counts, min / max, top-k and medians exact,
    sums and means within the bound of phase 4, sd and r2 within it carried
    through their formulas), q10 on the one-sort route in its unpacked mode,
    with B1, B2, b3-l2, B5 and b3x-l2 launched; then each question timed
    against plain torch (5 repetitions, medians);
18. drives BASELINE config 4, a join with isin and value_counts, with the
    shapes of benchmarks/join_isin.py:28-37 made on the card from seed 42:
    first the join's edges at 1e6 x 1e5 rows against a plain torch join
    (sort, searchsorted left and right, repeat_interleave), exactly: every
    third dim key missing and every seventh doubled, int keys with masked
    left keys and float keys with NaN on both sides, how = left, inner and
    right with allow_duplication, each probing on b6-wide; then a fact table
    of 1e9 rows (key int64 uniform in [0, 1e7), x float64 U[0, 1)) and a dim
    table of 1e7 (key = arange, label int64 in [0, 100)): J1
    fact.join(dim, on="key") (its lookup an int32 CUDA tensor equal to plain
    torch's, B6 launched on b6-wide, under 20 ms of device-to-host copies),
    J2 joined.sum("label"), J3 joined.groupby("label", {sum x, count}), J4
    fact.count(selection=fact.key.isin(ids)) for 1000 and 10 ids, J5
    joined["label"].value_counts(), each checked against plain torch
    (counts, int sums, labels and value counts exact, x sums within the
    bound of phase 4), with B1 launched; then each timed against plain torch
    (a warm-up, then 5 repetitions, medians), and B6 alone at the join's
    shape against its plain version and the library calls;
19. drives the grids past B3's limits and the rest of the frame's row
    operations on a table of 1e8 rows made on the card from seed 42 (x, y,
    z uniform in [0, 1), v normal; u normal with 2% NaN, 0.5% +inf, 0.5%
    -inf and 10% of its rows masked): (a) count, mean and std of v over
    [x, y] at shape 12 000 (144.1M cells with the edges), max of v at 8192
    (67.2M), count over [x, y, z] at 512 (136.6M), each on the route
    "sort", and the std of x, y, z, v at 4096 (16.8M cells, twelve terms) on
    "b3×2", B3's partition in two calls, launched; each grid checked against
    a second computation that shares no code with the route (torch.bincount
    with f64 weights for counts and sums, a sort by value then by cell for
    the max): counts and maxima exact, empty max cells -inf, means and stds
    within the bound of phase 4 carried through their formulas; each query
    timed (median of 3, host clock) beside the second computation and its
    grid's copy to the host (the route alone against its bound and against
    a sort of the bins: scripts/sweep_grid_sort.py); (b) on the same frame
    dropna / dropnan / dropinf counts, fillna(0) then dropinf's sum of u,
    materialize of r = sqrt(x**2 + y**2) (its sum unchanged, the column a
    CUDA tensor), sample(n=1e6, random_state=42) and
    shuffle(random_state=42) against plain torch over numpy's draw,
    split_random([0.8, 0.2], random_state=1)'s lengths, evaluate("v", 0,
    1e6, selection="x > 0.5"), to_arrays of 1e5 rows, and vrange(0, 1e9)'s
    sum and count (exact); it prints its own JSON line of routes and times;
20. drives the frame's remaining statistics, the window operations and a
    uint64 column on a table of 1e8 rows made on the card from seed 42 (phase
    7's H2O columns, x and y N(0, 1), u the bits of v1 with the top bit set
    on half the rows, a uint64 column, and source_id uniform in [0, 12 *
    4^12 * 2^35)): nunique of id5 and of id6 per id4 (a groupby's agg=: the
    presence grid on B2, the sorted pairs) and of id6 binned by id4 over
    60 bins (the presence grid on b3), cov of v1, v2, v3 (alone and by id4),
    mode of v3 by id4, mutual_information(x, y) at 256^2, describe() of
    every column, healpix_count at level 8 (b3-l2), shift / diff / rolling
    sums and a rolling max of v3, sum / minmax / max by id4 / groupby /
    isin of u, and stat.mean(v3) / stat.std(v3) by id4 in one pass; each
    checked against plain torch on the same tensors (counts, nunique, mode
    centres, healpix counts and uint64 results exact, the rest within the
    bound of phase 4 carried through its formula), each route and B6's
    probe asserted from trace_log, B2, b3, b3-l2, B4 and B6 asserted
    launched, shift / rolling / diff asserted to leave their views over CUDA
    tensors; then each query timed against plain torch (5 repetitions,
    medians) with its peak memory above the table; it prints its own JSON
    line.
21. drives the host scope: (a) BASELINE config 3 on H2O's own string keys
    (benchmarks/fixtures.py:28-40 at 1e8 rows drawn on the host from seed
    42, id1 / id2 "id%03d" of 1..100 and id3 "id%010d" of 1..1e6 as plain
    arrow strings), staged by to_device (timed as the ingest), then q1,
    q2, q3 and q10, each checked against plain torch over the drawn codes
    (config 3's checks, the result's labels translated to the codes), B1,
    B2 and B3 asserted launched from their counters and the routes from
    trace_log, q10's string keys asserted dictionary columns on the card;
    (b) benchmarks/strings.py's seven cases at 1e8 rows on the staged frame
    and groupby_str_sum / isin_str_500 on the unstaged one at 1e7 rows,
    each against plain torch over the codes with the per-label result
    computed in Python; (c) four datetime queries at 1e7 rows through the
    host stage against plain torch over the int64 nanoseconds; then each
    query timed beside its plain version (5 repetitions, medians), q1-q3
    beside phase 17's int keys; it prints its own JSON line.
22. drives the executor's tail and uint64 inside expressions: (1) config
    2's frame (phase 16, 1e8 rows) with i categorized, through state_write
    and state_load onto a fresh frame over the same tensors, its statistics
    equal to the original's bit for bit (B1, B4 launched); (2) the 1e6-key
    set grouper (phase 11) and q10 (phase 17) twice under cache.memory()
    and under cache.off(): a card tensor has no exact key, so both runs
    build or sort, agree and are right, then a unique over the 1e6-key
    column's first 1e7 rows as a host array, whose set the second run
    takes from the device LRU; cache.clear() frees the LRU's bytes on the
    card; (3) config 1's groupby at 2^24-row
    tiles with a progress callback (fractions rising to 1.0) and one that
    cancels after two tiles (UserAbort, B1 launched twice), then right
    again; (4) at 1e7 rows (cut from 1e8: every row crosses to the host and
    back) a Python UDF column grouped (sum and std against plain torch),
    the same bits with multiprocessing=True, map_reduce of each tile's sum
    and count; (5) at 1e7 rows a staged frame with a virtual column, a
    filter and a category through pickle, back on the card with the same
    groupby; (6) phase 20's uint64 column at 1e8 rows: u // 3, u % 7 as a
    key, u & 0xFFFF, u >> 60, u + k, sqrt(u), each against numpy over the
    values copied to the host; B1, B4, B3 and B6 asserted launched; then
    each query timed with the cache off beside its plain version, and the
    cache's hits beside its misses; it prints its own JSON line.  Phases
    6-21 run with the result cache off: they check and time the passes
    themselves.
23. drives files and the streamed pass: (1) a 256 MiB host-to-card copy
    from page-locked and from pageable memory (median of 5); (2) BASELINE
    config 1 at 4e8 rows (bench.py's N; i1 int64 in 0..99, x float64, made
    on the card from seed 42) exported by the port to HDF5 (to Arrow IPC
    where h5py is not installed: the JSON line says so), opened, i1
    categorized; groupby(i1, {sum x, count}) ships i1 wide and builds its
    proof, then the groupby, std(x), count(binby=[i1, x], shape=[100,
    1000]) and the count of i1.isin(50 values) streamed, i1 asserted int32
    on the wire and x float64, each equal to the staged frame's answer
    (counts exact, sums and std within rtol 1e-9); (3) the groupby at 2^20-
    row tiles (382 through a ring of 3), then cancelled after 5 tiles
    (UserAbort, no stream thread left), then right; (4) a cached unique of
    i1 over the file hashes no byte, and a 1e6-row file rewritten with one
    key changed gives the new answer; (5) parquet and Arrow IPC at 1e8 rows
    (groupby and std streamed), CSV and JSON at 1e6, FITS and VOTable at
    1e5, each checked; every streamed query of (2), (3) and (5) counted
    alone, its own kernel (B1, B4, B2, B6) asserted launched on its tiles,
    the staged answers and the exports made before the counts are set to
    0; a pass over 30 float64 host columns at 2^25 rows, the ring
    clamped to STREAM_RING_BYTES and at twice that, each checked and its
    slots' bytes and peak resident set recorded, then timed; then (6) each
    query timed streamed, with the synchronous copy and staged (5 runs for
    the groupby, 3 for the others and for the groupby at 2^20-row tiles,
    medians), the wire's GB/s as a share of
    the page-locked link, and one cold groupby after the file's pages were
    dropped; it prints its own JSON line.  Its files go to the temporary
    directory and are removed.

24. drives multi-device execution over a mesh of four shards of cuda:0
    (vaex_tpu_torch.parallel): on config 1 (1e8 rows, i1 categorized) the
    groupby (B1 on each shard), df.std (B4), a 2-D count over (i1, x) at
    100 x 100 (B2) and an isin count of 500 ids (B6); on config 3's table
    (1e8 rows, raw) q2 (B2) and q6-sd (B5) on the sharded pass, q3 and q7
    through the all-to-all groupby (G = 1e6 past SHUFFLE_MIN_G: b3-l2 and
    b3x-l2 on the owners), q10 and q6 (its median) through the fused mesh
    groupby; config 4's join with the fact table cut to 1e8 rows (the
    buffers of slack 4) against the dim table of 1e7, J1 (B6 on each
    owner) and J3 (B1); each answer held to the single-device pass on the
    same tensors (keys, counts, int sums, min / max, medians and the
    join's rows exactly, float sums within the bound of phase 4, means and
    stds within it carried through their formulas), the routes and the
    exchange's bytes a shard (rows a shard x slack x row bytes) asserted
    from trace_log, a rerun of the sharded float groupby asserted to give
    the same bits; the launches counted around the sharded queries alone,
    each query's own kernel and each of B1, B2, B3 (a route), B3x (a
    route), B4, B5 and B6 asserted launched on shard tiles; then config 1's
    groupby over a NCCL process group of one process, and two processes of
    two shards each on the card over gloo with CUDA tensors (each of the
    port's collectives tried first, a refusal failing the phase); each
    query timed sharded and single-device
    (medians of 3, on the one card: no scaling); it prints its own JSON
    line.

25. serves a table on the card and answers requests through the port's
    server and accessors: 1e8 rows made on the card from seed 42 (key int64
    of 100 categories, categorized; x N(0, 1); ra, dec uniform on the
    sphere in degrees; parallax float64; g_mag float32), served by a
    Service with a token; through the ASGI app in this process GET /dataset
    and /dataset/sky, the 64-bin histogram of x alone and with the
    percent-encoded filter g_mag%20%3C%2015, the 128 x 128 heatmap of ra,
    dec, POST /heatmap with the token, a 401 without it and a 400 for a
    filter that leaves the expression language (no pass run); over its
    /websocket std(parallax) and groupby_agg(key, {s: sum x, n: count})
    with their msg_id echoed; a Client over DummyTransport with a virtual
    column r = sqrt(x**2 + parallax**2) and the selection g_mag < 15 sent
    as state: count(binby=r, shape=1000, selection=True), mean, minmax,
    correlation(x, parallax), a progress callback (fractions never
    decreasing, ending at 1.0), a cancelled call answered with an error
    reply and the call after it answered; GraphQL's where / count / mean /
    groupby; a GridModel histogram of x and a heatmap of ra, dec on one
    dispatcher, whose brush select("x > 1") regrids both in exactly one
    pass; eq2gal (l and b within 1e-12 rad of plain torch's formula, the
    count binned by l, b at 256 exact against a bincount of the port's own
    l and b) and an inside_polygon count; df.viz's grid; each checked
    against plain torch (names, schemas, counts, grids, limits and extremes
    exact, means, stds and sums within the bound of phase 4, the
    correlation within 1e-9), the served frame asserted still on the card,
    B1, B2 and B4 asserted launched; then each request timed served,
    called directly on the frame and in plain torch (medians of 3); the
    CLI's meta, stat and convert run at once as subprocesses on a 1e6-row
    Arrow IPC file; the tornado server and the drawings where tornado,
    websockets and matplotlib are installed (a missing one printed by
    name); it prints its own JSON line.

26. fits a machine-learning pipeline on the card (vaex_tpu_torch.ml): 1e8
    rows made on the card from seed 42 (x0..x7 float64 around 16 centres
    uniform in [-10, 10]^8, sd 1; key int64 of 100 categories,
    categorized; cat a string column of 8 labels held as int32 codes on the
    card; y = x0 + noise > 0; t linear in x0..x7 plus noise): a
    StandardScaler of the eight features (one pass), a PCA of the scaled
    columns (3 components), KMeans(16 clusters, n_init 3, max_iter 20, tol
    1e-4, random_state 42) and its predict over every row, MinMax, MaxAbs
    and Robust scalers and uniform and quantile KBinsDiscretizers of x0, x1,
    LabelEncoder of cat and key, OneHotEncoder and FrequencyEncoder of cat
    (each transformed column summed in one pass), BayesianTargetEncoder and
    WeightOfEvidenceEncoder of key by y, GroupByTransformer(key, mean x0)
    through its join, the metrics with the expression PCA_0 > 0 as the
    prediction and a linear expression against t, and the pipeline's state
    put on a second frame; each step against plain torch on the same
    tensors (counts, codes, labels, min / max exact; means, stds, cov,
    eigenvalues, inertia, encodings and metrics rtol 1e-9 and atol 1e-9;
    percentiles within one bin of the 16 384-cell grid against a sort;
    centroids within the sums' bound over the count against Lloyd's
    algorithm in plain torch from the same init rows; predict equal to the
    plain assignment but for rows whose two distances tie within 1e-12),
    B1, B2, B4 and B6 asserted launched; then each step timed against plain
    torch (medians of 3), KMeans's fits asserted bit-equal; the host-stage
    legs at 1e7 rows (KMeans's transform column counted by a groupby,
    RiverModel(OnlineSGDRegressor)'s predict) and sklearn's Predictor at
    1e6 where sklearn is installed (its absence printed by name); it
    prints its own JSON line, the phase's time and the whole script's time.
27. repairs of silent wrong answers at 1e8 rows made on the card: config
    1's key written through ``.data`` (no version bump) and its unique
    again under cache.memory(), right; the mean of x62 = 2^62 + [0, 8)
    (int64) on the frame, binned and per group; the std of x62 and of y =
    N(0, 1) + 1e8 on the frame and binned at G = 103 (B4), corr(y, z) per
    group of a key of 10 607 values (B5), cov([y, z]), each against plain
    torch over the centred data (means 1e-12, the rest 1e-6 relative), B4
    and B5 asserted launched; then in one call B4 (var, G = 103) and B5
    (corr, G = 10 609) shifted beside unshifted, and df.std(y), config 2's
    group and H2O q4 beside the old channels (no shift, an int mean's sum
    as int64), in turns; it prints its own JSON line.
28. BASELINE config 5 across processes: two worker processes on the card,
    joined over gloo (a file:// store; NCCL refuses two ranks on one GPU,
    so the port's collectives send the CUDA tensors through page-locked
    host memory), each driving two shards of cuda:0, a global mesh of four.
    Each first runs every collective of the port on the card's tensors,
    answers checked, then makes config 3's H2O table (1e8 rows) and config
    4's fact (1e8, cut from 1e9 as in phase 24) and dim (1e7) tables whole
    from seed 42 and answers q3, q7, q10, J1 (how="left" and "inner") and
    J3 on one device (rank 0 also times them there and over phase 24's
    four shards in one process), then keeps the rows whose row number
    hashes (murmur3's finalizer) to its rank, frees the whole tables, and
    answers the same over both processes: q3 and q7 through the all-to-all,
    q10 through the fused exchange, J1 through the hash join whose
    exchanges carry the label, J3 over the joined frame; each held to the
    single device's (groupbys as in phase 24, both processes the whole
    answer; each process's join rows equal to the whole-table join's at
    its own rows, row for row), each route asserted in trace_log with
    world 2 and no fall-back, B3 (a route) and B6 asserted launched in
    both; then each query timed as the slower process's wall (medians of
    3 after a warm-up); it prints its times and its own JSON line.

    python3 chip_smoke.py --profile 20 21 22 23

profiles the queries of those phases instead (scripts/profile_torch_groupby.py's
``profile``: the device's busy and idle share, the device time by kernel).

It exits non-zero on any failure.  The line before the last is a JSON
object with every kernel's (and each of B3x's routes') launches, error,
times, bound (the larger of the
bytes it must move over the card's published memory rate and its operations
over the published peak) and, where one exists, the time of the PyTorch
library call that computes the same function; the last line is
{"ok": true, "device": {...}}.
"""

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
K = 100
SEED = 42
MAIN_SIZES = (100_000_000, 400_000_000)
KERNEL_SIZES = (0, 1, 1_000_003, 100_000_000)
H2O_ROWS = 100_000_000
H2O_K = 100  # id4, id5 cardinality
H2O_K6 = H2O_ROWS // 100  # id6 cardinality
REPS = 5
RTOL = ATOL = 1e-9
ISIN_VALUES = 500
ISIN_WIDE_VALUES = 50_000  # past the probe's shared-memory kernel
WIDE_FACTOR = 1_000_003  # spreads a key's values over a range past 2^22
# set-grouper keys and their set sizes
SET_KEYS = {"k100": 100, "k2000": 2000, "k1e6": H2O_K6}
# NVIDIA's H100 SXM data sheet: HBM bytes/s; float32 operations/s outside the
# tensor cores.  Integer adds and compares are counted at the float32 rate,
# float64 operations at half of it.
# beside the keys every kernel has: the index_add_ alone for B4 and B5, B4
# at df.std's shape (G = 1) and B5 at q6-sd's (var, one window); for B1 the
# isin count's shape
# (G = 1, count alone) and the main path's shape on the warp route; for
# B6 torch.isin, its b6-wide route at the 1e6-key set grouper and b6 at the
# 50 000 ids; for B3 its resident route at the same shape and the
# partition's phases; for B3x's resident route q7's shape; for B1 and B4
# their launches in the config 2 phase; every kernel's launches in the
# config 3 and config 4 phases ("config3_launches", "config4_launches"); for
# B6 its time at config 4's join (the 1e9 fact keys among the 1e7 dim keys),
# J1's launches and the ms of J1's copies to the host
EXTRA_KEYS = ("phase21_l2_launches", "library_add_ms", "isin_ms", "wide_launches", "wide_ms", "wide_plain_ms",
              "config2_launches", "wide_library_ms", "wide_isin_ms", "wide_bound_ms", "wide_max_abs_err",
              "l2_launches", "l2_ms", "l2_plain_ms", "l2_max_abs_err", "count_ms",
              "scatter_ms", "sums_ms", "q7_ms", "q7_plain_ms", "q7_library_ms",
              "q7_bound_ms", "isin_wide_ms", "var_ms", "var_plain_ms", "var_bound_ms",
              "var_library_ms", "var_max_abs_err", "g1_ms", "g1_plain_ms", "g1_bound_ms",
              "g1_library_ms", "g1_max_abs_err", "warp_ms", "join_ms", "join_plain_ms",
              "join_library_ms", "join_bound_ms", "join_max_abs_err", "join_route",
              "j1_launches", "j1_dtoh_ms")
PEAK_BYTES = 3.35e12
PEAK_OPS = {"int": 67e12, "f64": 33.5e12}


def check(ok, message):
    if not ok:
        raise RuntimeError(f"check failed: {message}")


def within_sum_bound(got, want, abs_sums, counts):
    """True when every cell of two float64 sums of the same terms, added in
    orders neither side fixes (atomics, ``index_add_``), agrees within
    ``RTOL * |want| + ATOL + n_cell * 2^-52 * S_cell``: ``S_cell`` is the
    cell's sum of |term| and ``n_cell`` its row count.  Each side lies within
    (n_cell - 1) * 2^-53 * S_cell of the exact sum whatever its order, so
    the bound holds for any two correct sums, also in a cell whose terms
    cancel to near 0, where a relative tolerance does not; one term more or
    less exceeds it unless that term is below the rounding itself.  Equal
    values (infinities) and NaN on both sides agree."""
    bound = RTOL * want.abs() + ATOL + counts.to(torch.float64) * 2.0 ** -52 * abs_sums
    agree = ((got - want).abs() <= bound) | (got == want) | (torch.isnan(got) & torch.isnan(want))
    return bool(agree.all())


def additive_floats_ok(plain, idx, float_cols, G, got_f, want_f, counts):
    """B2 / B3 float sums against the plain version's, within the bound of
    :func:`within_sum_bound` (|term| summed by the same plain version)."""
    _, abs_sums = plain(idx, [], [c.abs() for c in float_cols], G, count=True)
    return within_sum_bound(got_f, want_f, abs_sums, counts)


def moment_sums_ok(plain, idx, bases, terms, G, got, want, shift=None):
    """B5's term sums against the plain version's, within the bound of
    :func:`within_sum_bound`: a term's |value| is its product of |base -
    shift|, so the plain version over those sums |term|; every float term of
    the var and corr sets counts the rows of the first count term."""
    from vaex_tpu_torch.ops.grid_moments import shift_values, shifted
    centred = [shifted(b, s).abs() for b, s in zip(bases, shift_values(bases, shift))]
    _, abs_sums = plain(idx, centred, terms, G)
    return within_sum_bound(got[1], want[1], abs_sums, want[0][0])


def first_valid(bases):
    """Each base's first finite value, as a pass's moment shift takes it."""
    return [b[torch.isfinite(b.to(torch.float64)).to(torch.uint8).argmax()] for b in bases]


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_s(fn, reps=REPS):
    """Median host-clock seconds of fn() ended by a synchronize, ``reps``
    runs."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def random_inputs(gen, n, G, nan=False):
    """idx with about 1/8 of the rows at idx >= G (they drop), int64 values
    from +-2^62 (sums wrap), float64 from N(0, 100)."""
    dev = torch.device("cuda")
    idx = torch.randint(0, G + G // 8 + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    ints = torch.randint(-(2 ** 62), 2 ** 62, (n,), generator=gen, device=dev,
                         dtype=torch.int64)
    floats = torch.randn(n, generator=gen, device=dev, dtype=torch.float64) * 100
    if nan:
        floats[::97] = float("nan")
    return idx, ints, floats


def same_sums(kernel, plain, idx, ints, floats, G, what, unordered=False):
    """Kernel against plain on one input; returns the float max abs error.
    The float sums of a kernel that adds in no fixed order (``unordered``)
    are held to :func:`within_sum_bound`, those of B1 to RTOL and ATOL."""
    got_i, got_f = kernel(idx, [ints], [floats], G, count=True)
    want_i, want_f = plain(idx, [ints], [floats], G, count=True)
    torch.cuda.synchronize()
    check(torch.equal(got_i, want_i), f"int64 sums and count, {what}")
    if unordered:
        check(additive_floats_ok(plain, idx, [floats], G, got_f, want_f, want_i[0]),
              f"f64 sums within the bound of unordered summation, {what}")
    else:
        check(torch.allclose(got_f, want_f, rtol=RTOL, atol=ATOL), f"f64 sums, {what}")
    return (got_f - want_f).abs().max().item() if idx.numel() else 0.0


def kernel_vs_plain(ga):
    """Phase 3; returns the largest G that fits and the worst float error."""
    g_max = ga.SMEM_BUDGET // (8 * 3) - ga.STAGE_ROWS  # count + one int + one float column
    check(ga.fits(g_max, 1, 1, True) and not ga.fits(g_max + 1, 1, 1, True), "G max")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for G in (1, 103, 512, g_max):
        for n in KERNEL_SIZES:
            err = same_sums(ga.grid_additive, ga.grid_additive_reference,
                            *random_inputs(gen, n, G), G, f"B1 G={G} N={n}")
            worst = max(worst, err)
            print(f"kernel vs plain G={G} N={n} ({ga.grid_additive.last_route} route): ints "
                  f"exact, f64 max abs err {err!r}", flush=True)
    return g_max, max(worst, route_edges_vs_plain(ga, gen))


def route_edges_vs_plain(ga, gen, n=1_000_003):
    """B1 at the edges of its two routes (G = 1: sums in registers; 2; the
    main path's 103; B1's last bin, 128; the count alone, f64, f32 with NaN,
    int64 + f64, two int64 + f64), on columns that start at row 0 and at an
    odd row of their storage; both routes where both fit, the planned one
    asserted.  Returns the worst float error."""
    worst = 0.0
    planned = ga.route
    for G in (1, 2, 103, 128):
        idx, ints, f64 = random_inputs(gen, n + 1, G, nan=True)
        f32 = torch.randn(n + 1, generator=gen, device="cuda", dtype=torch.float32)
        f32[::89] = float("nan")
        for name, int_cols, float_cols in (("count", [], []), ("count + f64", [], [f64]),
                                           ("count + f32", [], [f32]),
                                           ("count + int64 + f64", [ints], [f64]),
                                           ("count + 2 int64 + f64", [ints, ints], [f64])):
            for offset in (0, 1):
                args = (idx[offset:offset + n], [c[offset:offset + n] for c in int_cols],
                        [c[offset:offset + n] for c in float_cols], G)
                want = planned(G, len(int_cols), len(float_cols), True)
                for how in (ga.LANE, ga.WARP):
                    if how == ga.LANE and ga.lane_warp_bytes(
                            G, len(int_cols), len(float_cols), True) > ga.CLUSTER_SMEM:
                        continue
                    ga.route = lambda *a, how=how: how
                    try:
                        got_i, got_f = ga.grid_additive(*args, count=True)
                    finally:
                        ga.route = planned
                    want_i, want_f = ga.grid_additive_reference(*args, count=True)
                    torch.cuda.synchronize()
                    what = f"B1 {how} G={G} {name} offset {offset}"
                    check(torch.equal(got_i, want_i), f"ints and count, {what}")
                    check(torch.allclose(got_f, want_f, rtol=RTOL, atol=ATOL), f"floats, {what}")
                    err = (got_f - want_f).abs().max().item() if got_f.numel() else 0.0
                    worst = max(worst, err)
                    print(f"{what} N={n}{' (planned)' if how == want else ''} vs plain: ints "
                          f"exact, float max abs err {err!r}", flush=True)
                ga.grid_additive(*args, count=True)
                check(ga.grid_additive.last_route == want, f"B1's planned route at G={G}, {name}")
    return worst


def skewed_keys(kind, gen, n, G, drop_every=17):
    """idx [n] int32 over [0, G): ``sorted`` (uniform, ascending), ``single``
    (every row on one key) or ``zipf`` (rank k drawn with weight k^-1.1, the
    ranks spread over the grid by a permutation); every ``drop_every``-th row
    dropped."""
    if kind == "single":
        idx = torch.full((n,), G // 3, device="cuda", dtype=torch.int32)
    elif kind == "zipf":
        cdf = torch.cumsum(torch.arange(1, G + 1, device="cuda", dtype=torch.float64) ** -1.1, 0)
        u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64) * cdf[-1]
        rank = torch.searchsorted(cdf, u).clamp_(max=G - 1)
        idx = torch.randperm(G, generator=gen, device="cuda")[rank].to(torch.int32)
    else:
        idx = torch.sort(torch.randint(0, G, (n,), generator=gen, device="cuda",
                                       dtype=torch.int32)).values
    if drop_every:
        idx[::drop_every] = -1
    return idx


SKEWS = ("sorted", "single", "zipf")


def wide_kernels_vs_plain(plan, gw):
    """Phase 4: B2 and both routes of B3 against their plain versions;
    returns the worst float error of each."""
    C = 3  # count + one int + one float column
    b2_limit = plan.b2_max_windows(C) * gw.cluster_width(C, True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {plan.B2: 0.0, plan.B3: 0.0, plan.B3_L2: 0.0}
    for G in (plan.B1_MAX_G + 1, 10_609, b2_limit, b2_limit + 1, 100_003, 1_000_003,
              4_000_037):
        name = plan.strategy(max(KERNEL_SIZES), G, 1, 1, True)
        print(f"plan at G={G} (count + int64 + f64): {name}", flush=True)
        check(name in worst, f"a wide kernel at G={G}")
        routes = (name,) if name == plan.B2 else (plan.B3, plan.B3_L2)
        for n in KERNEL_SIZES:
            inputs = random_inputs(gen, n, G, nan=True)
            for route in routes:
                err = same_sums(plan.KERNELS[route], plan.PLAIN[route], *inputs, G,
                                f"{route} G={G} N={n}", unordered=True)
                worst[route] = max(worst[route], err)
                print(f"{route} vs plain G={G} N={n}: ints exact, f64 max abs err {err!r}",
                      flush=True)
    G = 1_000_003
    check(plan.strategy(max(KERNEL_SIZES), G, 1, 1, True) == plan.B3_L2, "the plan at 1e6 bins")
    check(plan.strategy(max(KERNEL_SIZES), G, 2, 1, True) == plan.B3, "the plan past L2")
    _, ints, floats = random_inputs(gen, max(KERNEL_SIZES), G, nan=True)
    for kind in SKEWS:
        idx = skewed_keys(kind, gen, max(KERNEL_SIZES), G)
        for route in (plan.B3, plan.B3_L2):
            err = same_sums(plan.KERNELS[route], plan.PLAIN[route], idx, ints, floats, G,
                            f"{route} {kind} keys G={G}", unordered=True)
            worst[route] = max(worst[route], err)
            print(f"{route} vs plain on {kind} keys G={G} N={idx.numel()}: ints exact, no "
                  f"other path, f64 max abs err {err!r}", flush=True)
        del idx
    worst[plan.B2] = max(worst[plan.B2], cluster_edges_vs_plain(gw, gen))
    return worst


def cluster_edges_vs_plain(gw, gen, n=1_000_003):
    """B2 against its plain version at the edges of its cluster: G = k * W
    and k * W + 1 for k = 1 .. MAX_CLUSTER windows of the widest window W,
    at C = 1 (count), 2 (+ int64), 3 (+ f64 with NaN) and 4 (+ f32); one
    window past the cluster the wrapper refuses.  Returns the worst float
    error."""
    worst = 0.0
    for C in (1, 2, 3, 4):
        idx0, ints, floats = random_inputs(gen, n, 1, nan=True)
        ints, floats = [ints] if C >= 2 else [], [floats] if C >= 3 else []
        if C == 4:
            floats.append(torch.randn(n, generator=gen, device="cuda", dtype=torch.float32))
        W = gw.cluster_width(C, True)
        for k in range(1, gw.MAX_CLUSTER + 1):
            for G in (k * W, k * W + 1):
                idx = torch.randint(-2, G + G // 8 + 1, (n,), generator=gen, device="cuda",
                                    dtype=torch.int32)
                idx[:4] = torch.tensor([0, W - 1, W, G - 1], dtype=torch.int32)
                if not gw.fits(G, C, True):
                    try:
                        gw.grid_window(idx, ints, floats, G, True)
                    except ValueError:
                        print(f"b2 C={C} G={G}: past the cluster, refused", flush=True)
                        continue
                    check(False, f"b2 takes G={G} at C={C}, past its cluster")
                got_i, got_f = gw.grid_window(idx, ints, floats, G, True)
                want_i, want_f = gw.grid_window_reference(idx, ints, floats, G, True)
                torch.cuda.synchronize()
                what = f"b2 C={C} G={G} windows={gw.cluster_windows(G, C, True)}"
                check(torch.equal(got_i, want_i), f"int64 sums and count, {what}")
                check(additive_floats_ok(gw.grid_window_reference, idx, floats, G, got_f, want_f,
                                         want_i[0]),
                      f"floats within the bound of unordered summation, {what}")
                err = (got_f - want_f).abs().max().item() if got_f.numel() else 0.0
                worst = max(worst, err)
                print(f"{what} N={n} vs plain: ints exact, float max abs err {err!r}",
                      flush=True)
    return worst


# (kind, G) where B5's parts change: a group of terms one bin past what
# fits splits, one window one bin past a float plane of 227 KiB
B5_EDGES = (("var", 11_622), ("var", 11_623), ("var", 29_056), ("var", 29_057),
            ("corr", 5_282), ("corr", 5_283), ("corr", 9_686), ("corr", 19_370),
            ("corr", 19_371), ("corr", 29_056), ("corr", 29_057), ("corr", 60_000))


def window_edges_vs_plain(gm, agg, gen, n=1_000_003):
    """B5 where its parts change (B5_EDGES), on columns that start at an odd
    row of their storage; at q9's G = 10 609 on f32 and int64 bases, on one
    key and on a Zipf(1.1) draw; the parts asserted.  Returns the worst
    float error."""
    worst = 0.0
    cases = [(label, G, "uniform", 1, (torch.float64, torch.int64)) for label, G in B5_EDGES]
    cases += [(label, 10_609, keys, 0, dtypes) for label in ("var", "corr")
              for keys in ("single", "zipf")
              for dtypes in ((torch.float64, torch.int64), (torch.float32, torch.float32))]
    for label, G, keys, offset, dtypes in cases:
        terms = agg.VAR_TERMS if label == "var" else agg.CORR_TERMS
        if keys == "uniform":
            idx = torch.randint(-2, G + G // 8 + 1, (n + offset,), generator=gen, device="cuda",
                                dtype=torch.int32)[offset:]
        else:
            idx = skewed_keys(keys, gen, n, G)
        bases = []
        for j, dtype in enumerate(dtypes[:len(terms) // 3]):
            if dtype == torch.int64:
                b = torch.randint(-1000, 1000, (n + offset,), generator=gen, device="cuda")
            else:
                b = torch.randn(n + offset, generator=gen, device="cuda", dtype=dtype) * 100
                b[j::97 - 8 * j] = float("nan")
            bases.append(b[offset:])
        got = gm.grid_moments_window(idx, bases, terms, G)
        want = gm.grid_moments_window_reference(idx, bases, terms, G)
        torch.cuda.synchronize()
        W, n_win, bounds = gm.part_plan(G, len(terms))
        what = (f"b5 {label} G={G} {keys} keys, bases {[str(b.dtype) for b in bases]}, offset "
                f"{offset}, {n_win} windows of {W} bins x term groups {bounds}")
        check(gm.grid_moments_window.last_parts == n_win * (len(bounds) - 1), f"parts, {what}")
        check(torch.equal(got[0], want[0]), f"counts, {what}")
        check(moment_sums_ok(gm.grid_moments_window_reference, idx, bases, terms, G, got, want),
              f"sums within the bound of unordered summation, {what}")
        err = (got[1] - want[1]).abs().max().item()
        worst = max(worst, err)
        print(f"{what} N={n} vs plain: counts exact, f64 max abs err {err!r}", flush=True)
    return worst


def moment_kernels_vs_plain(plan, gm, agg):
    """Phase 5: B4 and B5 against their plain versions; returns the worst
    float error of each."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {plan.B4: 0.0, plan.B5: 0.0}
    b4_limit = plan.b4_max_g(6)
    for label, terms in (("var", agg.VAR_TERMS), ("corr", agg.CORR_TERMS)):
        C = len(terms)
        b5_limit = max(G for G in range(b4_limit + 1, 400_000, 97)
                       if gm.n_parts(G, C) <= plan.B5_MAX_PARTS)
        for G in (1, 103, b4_limit, b4_limit + 1, 10_609, b5_limit):
            name = plan.moment_strategy(max(KERNEL_SIZES), G, C, 1,
                                        gm.compiled(len(terms) // 3, terms))
            print(f"plan at G={G} ({label}, {C} terms): {name}", flush=True)
            check(name in (plan.B4, plan.B5), f"a moment kernel at G={G}")
            for n in KERNEL_SIZES:
                idx = torch.randint(0, G + G // 8 + 1, (n,), generator=gen, device="cuda",
                                    dtype=torch.int32)
                x, y = (torch.randn(n, generator=gen, device="cuda", dtype=torch.float64) * 100
                        for _ in range(2))
                x[::97] = float("nan")
                y[::89] = float("nan")
                bases = [x] if label == "var" else [x, y]
                got = plan.MOMENT_KERNELS[name](idx, bases, terms, G)
                want = plan.MOMENT_PLAIN[name](idx, bases, terms, G)
                torch.cuda.synchronize()
                what = f"{name} {label} G={G} N={n}"
                check(torch.equal(got[0], want[0]), f"counts, {what}")
                if name == plan.B5:
                    check(moment_sums_ok(plan.MOMENT_PLAIN[name], idx, bases, terms, G, got,
                                         want),
                          f"sums within the bound of unordered summation, {what}")
                else:
                    check(torch.allclose(got[1], want[1], rtol=RTOL, atol=ATOL),
                          f"sums, {what}")
                err = (got[1] - want[1]).abs().max().item() if n else 0.0
                worst[name] = max(worst[name], err)
                print(f"{what} vs plain: counts exact, f64 max abs err {err!r}", flush=True)
                del idx, x, y, bases
    worst[plan.B5] = max(worst[plan.B5], window_edges_vs_plain(gm, agg, gen))
    worst[plan.B4] = max(worst[plan.B4], b4_routes_vs_plain(gm, agg, gen))
    for name, err in shifted_moments_vs_plain(plan, gm, agg, gen).items():
        worst[name] = max(worst[name], err)
    return worst


# shifted moments (phase 5): (base dtype, offset); an int64 offset "span"
# puts half the values near -2^62 and half near 2^62, a span past 2^63
SHIFT_CASES = ((torch.float64, 1e6), (torch.float64, 1e8), (torch.float32, 1e6),
               (torch.float32, 1e8), (torch.int64, 2 ** 62), (torch.int64, "span"))


def shifted_bases(nb, dtype, offset, n, gen):
    """(nb bases of ``dtype`` near ``offset``, NaN in every 97th row of a
    float one, and the shift of each: the offset, 2^62 for "span")."""
    bases, shift = [], []
    for j in range(nb):
        if dtype == torch.int64:
            b = torch.randint(-1000, 1000, (n,), generator=gen, device="cuda")
            if offset == "span":
                sign = torch.randint(0, 2, (n,), generator=gen, device="cuda") * 2 - 1
                b = b + sign * 2 ** 62
            else:
                b = b + offset
            shift.append(2 ** 62)
        else:
            b = (torch.randn(n, generator=gen, device="cuda", dtype=torch.float64) * (j + 1)
                 + offset).to(dtype)
            b[j::97] = float("nan")
            shift.append(offset)
        bases.append(b)
    return bases, shift


def shifted_moments_vs_plain(plan, gm, agg, gen, n=1_000_003):
    """Phase 5, shifted moments: B4 at G = 1 without an index and at 103,
    B5 at G = 10 609, var and corr, with a shift per base (in device
    memory) against their plain versions with the same shift, on f64 and
    f32 bases at offsets 1e6 and 1e8 and int64 bases near 2^62 and across
    a span past 2^63; counts exact, B4's floats to RTOL, B5's within the
    bound of unordered summation over |base - shift|.  Returns the worst
    float error per kernel."""
    worst = {plan.B4: 0.0, plan.B5: 0.0}
    idx = {G: torch.randint(-1, G + 2, (n,), generator=gen, device="cuda", dtype=torch.int32)
           for G in (103, 10_609)}
    for label, terms in (("var", agg.VAR_TERMS), ("corr", agg.CORR_TERMS)):
        nb = len(terms) // 3
        for dtype, offset in SHIFT_CASES:
            bases, shift = shifted_bases(nb, dtype, offset, n, gen)
            for name, G in ((plan.B4, 1), (plan.B4, 103), (plan.B5, 10_609)):
                rows = idx.get(G)
                got = plan.MOMENT_KERNELS[name](rows, bases, terms, G, shift)
                want = plan.MOMENT_PLAIN[name](rows, bases, terms, G, shift)
                torch.cuda.synchronize()
                what = f"shifted {name} {label} G={G} {dtype} at {offset}"
                check(torch.equal(got[0], want[0]), f"counts, {what}")
                if name == plan.B5:
                    check(moment_sums_ok(plan.MOMENT_PLAIN[name], rows, bases, terms, G, got,
                                         want, shift),
                          f"sums within the bound of unordered summation, {what}")
                else:
                    check(torch.allclose(got[1], want[1], rtol=RTOL, atol=ATOL), f"sums, {what}")
                err = (got[1] - want[1]).abs().max().item()
                worst[name] = max(worst[name], err)
                print(f"{what} N={n} vs plain: counts exact, f64 max abs err {err!r}",
                      flush=True)
            del bases
    return worst


def b4_routes_vs_plain(gm, agg, gen, n=1_000_003):
    """B4's lane route at G = 1 (terms held in registers), 103 (three warps
    of lane grids a CTA for var) and the last G where LANE_MIN_WARPS warps
    fit, on f64, f32 and int64 bases with NaN among the floats, on columns
    that start at an odd row; the route asserted and the floats bit-equal
    run to run.  Returns the worst float error."""
    worst = 0.0
    for label, terms in (("var", agg.VAR_TERMS), ("corr", agg.CORR_TERMS)):
        n_float = sum(a >= 0 for a, *_ in terms)
        compiled = gm.compiled(len(terms) // 3, terms)
        warps = gm.LANE_MIN_WARPS[compiled]
        edge = gm.CLUSTER_SMEM // (warps * gm.lane_warp_bytes(1, 1, n_float))
        for G in (1, 103, edge):
            if not gm.route(G, 1, n_float, compiled) == gm.LANE:
                continue
            for dtype in (torch.float64, torch.float32, torch.int64):
                idx = torch.randint(-2, G + G // 8 + 1, (n + 1,), generator=gen, device="cuda",
                                    dtype=torch.int32)[1:]
                bases = []
                for j in range(len(terms) // 3):
                    if dtype == torch.int64:
                        b = torch.randint(-1000, 1000, (n + 1,), generator=gen, device="cuda")
                    else:
                        b = torch.randn(n + 1, generator=gen, device="cuda", dtype=dtype) * 100
                        b[j::97 - 8 * j] = float("nan")
                    bases.append(b[1:])
                # at G = 1 also without an index (every row in bin 0), as
                # a statistic without binby or selection calls it
                for rows in (idx, None) if G == 1 else (idx,):
                    got = gm.grid_moments(rows, bases, terms, G)
                    check(gm.grid_moments.last_route == gm.LANE, f"B4's lane route at G={G}")
                    again = gm.grid_moments(rows, bases, terms, G)
                    want = gm.grid_moments_reference(rows, bases, terms, G)
                    torch.cuda.synchronize()
                    what = (f"b4 lane route {label} G={G} {dtype} bases at an odd row"
                            f"{', no idx' if rows is None else ''}")
                    check(torch.equal(got[0], want[0]), f"counts, {what}")
                    check(torch.allclose(got[1], want[1], rtol=RTOL, atol=ATOL), f"sums, {what}")
                    check(torch.equal(got[1], again[1]), f"floats bit-equal run to run, {what}")
                    err = (got[1] - want[1]).abs().max().item()
                    worst = max(worst, err)
                    print(f"{what} N={n} vs plain: counts exact, floats bit-equal run to run, "
                          f"f64 max abs err {err!r}", flush=True)
    return worst


def make_table(n, vt, device="cuda"):
    gen = torch.Generator(device=device).manual_seed(SEED)
    i1 = torch.randint(0, K, (n,), generator=gen, device=device, dtype=torch.int64)
    x = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    df = vt.from_dataset(vt.DatasetArrays({"i1": i1, "x": x}))
    return df.categorize("i1", labels=range(K)), i1, x


def run_query(df, vt):
    return df.groupby("i1", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)


def plain_query(i1, x):
    counts = torch.bincount(i1, minlength=K)
    sums = torch.zeros(K, dtype=torch.float64, device=i1.device).index_add_(0, i1, x)
    return counts, sums


def main_path(n, vt):
    """Phase 6 at one size: the query through the public API, checked."""
    from vaex_tpu_torch.ops import grid_additive as ga
    df, i1, x = make_table(n, vt)
    out = run_query(df, vt)
    torch.cuda.synchronize()
    routes = [(df.executor.trace_log[-1]["strategies"], ga.grid_additive.last_route)]
    want_c, want_s = plain_query(i1, x)
    got_c = torch.as_tensor(out["c"].tolist())
    got_s = torch.as_tensor(out["s"].tolist(), dtype=torch.float64)
    check(out.get_column_names() == ["i1", "s", "c"], f"columns {out.get_column_names()}")
    check(out["i1"].tolist() == list(range(K)), "group keys")
    check(torch.equal(got_c, want_c.cpu()), f"counts equal bincount at N={n}")
    check(int(got_c.sum()) == n, f"counts total N={n}")
    check(torch.allclose(got_s, want_s.cpu(), rtol=RTOL, atol=ATOL), f"sums at N={n}")
    total = float(df.sum("x"))
    check(abs(total - x.sum().item()) <= RTOL * abs(total), f"df.sum at N={n}")
    log = df.executor.trace_log[-1]
    routes.append((log["strategies"], ga.grid_additive.last_route))
    # the groupby (G = 103) and df.sum (G = 1) on B1's lane route
    check(routes == [([{"additive": "b1"}], ga.LANE)] * 2, f"B1's routes at N={n}: {routes}")
    print(f"main path N={n}: counts exact, sums and df.sum within rtol {RTOL}; "
          f"last pass: {log['tiles']} tiles of {log['tile_rows']} rows on {log['device']}, "
          f"strategies {log['strategies']}", flush=True)
    return df, i1, x


def copy_bandwidth(x):
    """Bytes/s of a device-to-device copy of x (read + write)."""
    y = torch.empty_like(x)
    copy_ms = cuda_ms(lambda: y.copy_(x), 10)
    return 2 * x.numel() * x.element_size() / (copy_ms * 1e-3), copy_ms


def bound(n_bytes, ops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``n_bytes`` (every input read once, every output written once) over
    PEAK_BYTES and the operations ``ops`` ({kind: count}) over PEAK_OPS."""
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    ops_ms = sum(count / PEAK_OPS[kind] for kind, count in ops.items()) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def additive_bound(n, G, n_int, n_float, count=True):
    """The bound of one additive grid call: int32 idx and 8-byte columns in,
    [C, G] 8-byte sums out; one add per row and column."""
    C = int(count) + n_int + n_float
    return bound(n * (4 + 8 * (n_int + n_float)) + 8 * C * G,
                 {"int": n * (int(count) + n_int), "f64": n * n_float})


def library_additive_ms(idx, int_cols, float_cols, G, reps=2):
    """The PyTorch library calls for an additive grid call: ``bincount`` for
    the count and one ``index_add_`` per column (idx within [0, G))."""
    idx = idx.to(torch.int64)

    def run():
        torch.bincount(idx, minlength=G)
        for col in (*int_cols, *float_cols):
            torch.zeros(G, dtype=col.dtype, device=col.device).index_add_(0, idx, col)
    return cuda_ms(run, reps)


def timings(n, df, i1, x, vt, ga, label):
    """Phase 9 at one main-path size: end-to-end query and B1 times, in turns."""
    port_s, plain_s = [], []
    for _ in range(REPS):
        for fn, times in ((lambda: plain_query(i1, x), plain_s),
                          (lambda: run_query(df, vt), port_s)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    idx = (i1 + 2).to(torch.int32)  # the main path's bin layout, G = K + 3
    G = K + 3
    kernel_ms = cuda_ms(lambda: ga.grid_additive(idx, [], [x], G, count=True), 10)
    plain_ms = cuda_ms(lambda: ga.grid_additive_reference(idx, [], [x], G, count=True), 10)
    from vaex_tpu_torch.ops.binners import BinnerOrdinal
    from vaex_tpu_torch.ops.nullable import NA
    binner = BinnerOrdinal("i1", 0, K)
    prolog_ms = cuda_ms(lambda: binner.to_bins(NA(i1)), 10)
    # the kernel's HBM floor: 12 bytes/row (int32 bin + float64 value) at the
    # bandwidth of a device-to-device copy of x measured here
    copy_bw, copy_ms = copy_bandwidth(x)
    floor_ms = n * 12 / copy_bw * 1e3
    got = ga.grid_additive(idx, [], [x], G, count=True)[1]
    want = ga.grid_additive_reference(idx, [], [x], G, count=True)[1]
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=RTOL, atol=ATOL), f"kernel at N={n}")
    port_rate = n / statistics.median(port_s)
    plain_rate = n / statistics.median(plain_s)
    print(f"[{label}] N={n} K={K}: groupby median {port_rate!r} rows/s (port) vs "
          f"{plain_rate!r} rows/s (plain torch bincount+index_add_), reps {REPS}; "
          f"port s {port_s}; plain s {plain_s}", flush=True)
    print(f"[{label}] N={n} G={G}: grid_additive kernel {kernel_ms!r} ms vs plain "
          f"{plain_ms!r} ms; binning prolog {prolog_ms!r} ms; kernel max abs err {err!r}",
          flush=True)
    print(f"[{label}] N={n}: copy bandwidth {copy_bw / 1e12!r} TB/s (read + write, "
          f"{copy_ms!r} ms); kernel HBM floor at 12 B/row {floor_ms!r} ms, kernel at "
          f"{floor_ms / kernel_ms!r} of it", flush=True)
    library_ms = library_additive_ms(idx, [], [x], G)
    bound_ms, bound_by = additive_bound(n, G, 0, 1)
    print(f"[{label}] N={n} G={G}: bincount + index_add_ (the library calls) {library_ms!r} "
          f"ms; bound {bound_ms!r} ms by {bound_by} at {PEAK_BYTES / 1e12} TB/s", flush=True)
    # the same shape on B1's warp route, beside the planned lane route
    planned = ga.route
    ga.route = lambda *a: ga.WARP
    try:
        warp_ms = cuda_ms(lambda: ga.grid_additive(idx, [], [x], G, count=True), 10)
    finally:
        ga.route = planned
    # the isin count's shape: G = 1, the count alone, the rows outside it at -1
    g1 = (i1 < K // 2).to(torch.int32) - 1
    g1_ms = cuda_ms(lambda: ga.grid_additive(g1, [], [], 1, count=True), 10)
    check(ga.grid_additive.last_route == ga.LANE, "the isin count's shape on the lane route")
    g1_plain_ms = cuda_ms(lambda: ga.grid_additive_reference(g1, [], [], 1, count=True), 10)
    got1 = ga.grid_additive(g1, [], [], 1, count=True)[0]
    want1 = ga.grid_additive_reference(g1, [], [], 1, count=True)[0]
    check(torch.equal(got1, want1), f"the count at G = 1, N={n}")
    g1_err = float((got1 - want1).abs().max())
    g1_library_ms = cuda_ms(lambda: torch.count_nonzero(g1 + 1), 10)
    g1_bound_ms, _ = additive_bound(n, 1, 0, 0)
    print(f"[{label}] N={n} G={G}: B1 warp route {warp_ms!r} ms (planned {planned(G, 0, 1, True)} "
          f"{kernel_ms!r}); the isin count's shape (G = 1, count alone): kernel {g1_ms!r} ms vs "
          f"plain {g1_plain_ms!r} ms, count_nonzero {g1_library_ms!r} ms, bound {g1_bound_ms!r} "
          f"ms", flush=True)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "warp_ms": warp_ms, "g1_ms": g1_ms,
            "g1_plain_ms": g1_plain_ms, "g1_bound_ms": g1_bound_ms,
            "g1_library_ms": g1_library_ms, "g1_max_abs_err": g1_err}


# ------------------------------------------------------- the H2O-shaped path
def make_h2o(vt):
    """The H2O groupby generator's shapes at H2O_ROWS rows, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def ints(low, high):
        return torch.randint(low, high + 1, (H2O_ROWS,), generator=gen, device="cuda",
                             dtype=torch.int64)
    cols = {"id4": ints(1, H2O_K), "id5": ints(1, H2O_K), "id6": ints(1, H2O_K6),
            "v1": ints(1, 5), "v2": ints(1, 5),
            "v3": torch.rand(H2O_ROWS, generator=gen, device="cuda",
                             dtype=torch.float64) * 100}
    df = vt.from_dataset(vt.DatasetArrays(cols))
    df = df.categorize("id4", min_value=1, labels=range(1, H2O_K + 1))
    df = df.categorize("id5", min_value=1, labels=range(1, H2O_K + 1))
    df = df.categorize("id6", min_value=1, labels=range(1, H2O_K6 + 1))
    return df, cols


def h2o_queries(vt):
    return {
        "q2": lambda df: df.groupby(["id4", "id5"], agg={"v1": "sum"}, sort=True),
        "binby": lambda df: df.count(binby=["id4", "id5"]),
        "q3": lambda df: df.groupby("id6", agg={"v1": "sum", "v3": "mean"}),
        "q5": lambda df: df.groupby("id6", agg={"v1": "sum", "v2": "sum", "v3": "sum"}),
        "q5 + count": lambda df: df.groupby("id6", agg={"v1": "sum", "v2": "sum", "v3": "sum",
                                                        "n": "count"}),
    }


# the kernel the last pass of each query must record and launch
H2O_EXPECT = {"q2": "b2", "binby": "b2", "q3": "b3-l2", "q5": "b3-l2", "q5 + count": "b3"}


def h2o_plain(cols):
    """The same five answers in plain torch: bincount and index_add_."""
    pair = (cols["id4"] - 1) * H2O_K + (cols["id5"] - 1)
    id6 = cols["id6"] - 1

    def per(keys, size, v):
        out = torch.zeros(size, dtype=v.dtype, device=v.device)
        return out.index_add_(0, keys, v)
    return {
        "q2": lambda: (torch.bincount(pair, minlength=H2O_K ** 2),
                       per(pair, H2O_K ** 2, cols["v1"])),
        "binby": lambda: torch.bincount(pair, minlength=H2O_K ** 2),
        "q3": lambda: (torch.bincount(id6, minlength=H2O_K6), per(id6, H2O_K6, cols["v1"]),
                       per(id6, H2O_K6, cols["v3"])),
        "q5": lambda: (per(id6, H2O_K6, cols["v1"]), per(id6, H2O_K6, cols["v2"]),
                       per(id6, H2O_K6, cols["v3"])),
        "q5 + count": lambda: (per(id6, H2O_K6, cols["v1"]), per(id6, H2O_K6, cols["v2"]),
                               per(id6, H2O_K6, cols["v3"]),
                               torch.bincount(id6, minlength=H2O_K6)),
    }


def h2o_check(name, out, want):
    """One query's result against its plain torch answer."""
    host = lambda t: t.cpu().numpy()  # noqa: E731
    if name == "q2":
        counts, v1 = want
        keep = (counts > 0).cpu()
        check(out.get_column_names() == ["id4", "id5", "v1"], "q2 columns")
        cells = torch.nonzero(keep).squeeze(1)
        check(out["id4"].tolist() == (cells // H2O_K + 1).tolist(), "q2 id4 keys in order")
        check(out["id5"].tolist() == (cells % H2O_K + 1).tolist(), "q2 id5 keys in order")
        check(out["v1"].tolist() == host(v1)[keep.numpy()].tolist(), "q2 v1 sums exact")
    elif name == "binby":
        check((out == host(want).reshape(H2O_K, H2O_K)).all(), "binby counts exact")
    else:
        check(torch.equal(torch.as_tensor(out.evaluate("id6")),
                          torch.arange(1, H2O_K6 + 1)), f"{name} id6 keys in order")
        if name == "q3":
            counts, v1, v3 = want
            check((out.evaluate("v1") == host(v1)).all(), "q3 v1 sums exact")
            mean = torch.where(counts > 0, v3 / counts, torch.nan)
            check(torch.allclose(torch.as_tensor(out.evaluate("v3")), mean.cpu(), rtol=RTOL,
                                 atol=ATOL, equal_nan=True), "q3 v3 means")
        else:
            v1, v2, v3 = want[:3]
            check((out.evaluate("v1") == host(v1)).all(), f"{name} v1 sums exact")
            check((out.evaluate("v2") == host(v2)).all(), f"{name} v2 sums exact")
            check(torch.allclose(torch.as_tensor(out.evaluate("v3")), v3.cpu(), rtol=RTOL,
                                 atol=ATOL), f"{name} v3 sums")
            if len(want) > 3:
                check((out.evaluate("n") == host(want[3])).all(), f"{name} counts exact")


def h2o_path(vt, plan):
    """Phase 7: the five queries once, checked; returns the table and the
    launches of each kernel during them."""
    df, cols = make_h2o(vt)
    plain = h2o_plain(cols)
    for kernel in plan.KERNELS.values():
        kernel.launches = 0
    outs = {}
    for name, query in h2o_queries(vt).items():
        before = plan.KERNELS[H2O_EXPECT[name]].launches
        outs[name] = query(df)
        strategies = df.executor.trace_log[-1]["strategies"]
        print(f"H2O {name} N={H2O_ROWS}: pass strategies {strategies}", flush=True)
        check(strategies == [{"additive": H2O_EXPECT[name]}],
              f"{name}: strategies {strategies}, expected {H2O_EXPECT[name]}")
        check(plan.KERNELS[H2O_EXPECT[name]].launches > before,
              f"{name}: launches of {H2O_EXPECT[name]}")
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, kernel in plan.KERNELS.items()}
    for name, out in outs.items():
        h2o_check(name, out, plain[name]())
        print(f"H2O {name}: checked against plain torch (ints exact, floats rtol {RTOL})",
              flush=True)
    print(f"launches during the H2O path: {launches}", flush=True)
    return df, cols, launches


def stats_queries(vt):
    a = vt.agg
    return {
        "q6-sd": lambda df: df.groupby(["id4", "id5"], agg={"sd_v3": a.std("v3", ddof=1)},
                                       sort=True),
        "q9": lambda df: df.groupby(["id4", "id5"], agg={"r2": a.corr("v1", "v2")}),
        "q7": lambda df: df.groupby("id6", agg={"max_v1": a.max("v1"), "min_v2": a.min("v2")}),
        "df.std": lambda df: df.std("v3"),
        "std by id4": lambda df: df.std("v3", binby=["id4"]),
    }


def stats_plain(cols):
    """The five statistics in plain torch: index_add_ of the formed moments
    and the same formulas, scatter_reduce for q7."""
    f64 = torch.float64
    pair = (cols["id4"] - 1) * H2O_K + (cols["id5"] - 1)
    id4, id6 = cols["id4"] - 1, cols["id6"] - 1
    v1, v2, v3 = cols["v1"].to(f64), cols["v2"].to(f64), cols["v3"]

    def per(keys, size, v):
        return torch.zeros(size, dtype=f64, device=v.device).index_add_(0, keys, v)

    def std(keys, size, ddof):
        n = per(keys, size, torch.ones_like(v3))
        mean = per(keys, size, v3) / n
        var = torch.clamp(per(keys, size, v3 * v3) / n - mean ** 2, min=0.0)
        return n, torch.sqrt(var * n / (n - ddof))

    def corr():
        n = per(pair, H2O_K ** 2, torch.ones_like(v3))
        ex, ey = per(pair, H2O_K ** 2, v1) / n, per(pair, H2O_K ** 2, v2) / n
        cov = per(pair, H2O_K ** 2, v1 * v2) / n - ex * ey
        vx = per(pair, H2O_K ** 2, v1 * v1) / n - ex ** 2
        vy = per(pair, H2O_K ** 2, v2 * v2) / n - ey ** 2
        return n, cov / torch.sqrt(vx * vy)

    def extremes():
        out = []
        for v, mode, fill in ((cols["v1"], "amax", -(2 ** 63)), (cols["v2"], "amin", 2 ** 63 - 1)):
            grid = torch.full((H2O_K6,), fill, dtype=torch.int64, device=v.device)
            out.append(grid.scatter_reduce_(0, id6, v, mode, include_self=True))
        return out
    return {
        "q6-sd": lambda: std(pair, H2O_K ** 2, 1),
        "q9": corr,
        "q7": extremes,
        "df.std": lambda: torch.std(v3, correction=0),
        "std by id4": lambda: std(id4, H2O_K, 0)[1],
    }


def stats_check(name, out, want):
    """One statistic against its plain torch answer."""
    host = lambda t: t.cpu().numpy()  # noqa: E731
    close = lambda got, w, what: check(torch.allclose(  # noqa: E731
        torch.as_tensor(got, dtype=torch.float64), w.cpu(), rtol=RTOL, atol=ATOL), what)
    if name in ("q6-sd", "q9"):
        n, value = want
        keep = (n > 0).cpu()
        cells = torch.nonzero(keep).squeeze(1)
        check(out["id4"].tolist() == (cells // H2O_K + 1).tolist(), f"{name} id4 keys")
        check(out["id5"].tolist() == (cells % H2O_K + 1).tolist(), f"{name} id5 keys")
        column = "sd_v3" if name == "q6-sd" else "r2"
        close(out.evaluate(column), value.cpu()[keep], f"{name} {column}")
    elif name == "q7":
        vmax, vmin = want
        check((out.evaluate("max_v1") == host(vmax)).all(), "q7 max_v1 exact")
        check((out.evaluate("min_v2") == host(vmin)).all(), "q7 min_v2 exact")
        check(out.evaluate("max_v1").dtype.name == "int64", "q7 keeps int64")
    else:
        close(out, want, name)


# the moment kernel of each statistic's last pass and, for B5, its parts
# (q6-sd: var at G = 10 609, one part; q9: corr, one window of three term
# groups)
STATS_EXPECT = {"q6-sd": ("b5", 1), "q9": ("b5", 3), "q7": (None, None),
                "df.std": ("b4", None), "std by id4": ("b4", None)}


def stats_path(vt, plan, df, cols):
    """Phase 8: the statistics once, checked; returns the launches of each
    kernel during them."""
    plain = stats_plain(cols)
    kernels = {**plan.KERNELS, **plan.MOMENT_KERNELS}
    for kernel in kernels.values():
        kernel.launches = 0
    window = plan.MOMENT_KERNELS[plan.B5]
    outs = {}
    for name, query in stats_queries(vt).items():
        window.last_parts = None
        outs[name] = query(df)
        strategies = df.executor.trace_log[-1]["strategies"]
        print(f"stats {name} N={H2O_ROWS}: pass strategies {strategies}, B5 parts "
              f"{window.last_parts}", flush=True)
        kernel, parts = STATS_EXPECT[name]
        moments = [s.get("moments") for s in strategies]
        check(moments == [kernel], f"{name}: moment kernels {moments}, expected {kernel}")
        check(window.last_parts == parts, f"{name}: B5's parts {window.last_parts}, expected "
                                          f"{parts}")
        if kernel == plan.B4:
            route = plan.MOMENT_KERNELS[plan.B4].last_route
            check(route == "lane", f"{name}: B4's route {route}, expected its lane route")
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    for name, out in outs.items():
        stats_check(name, out, plain[name]())
        print(f"stats {name}: checked against plain torch (ints exact, floats rtol {RTOL})",
              flush=True)
    print(f"launches during the statistics path: {launches}", flush=True)
    return launches


def library_moments_ms(idx, bases, terms, G, gm):
    """The PyTorch library call for a moment kernel: the terms formed as an
    [N, A] float64 matrix (what the TPU kernels are handed), then one
    ``index_add_``.  Returns the time of both and of the ``index_add_``
    alone."""
    idx = idx.to(torch.int64)

    def formed():
        count_cols, float_cols = gm.form_terms(idx, bases, terms)
        return torch.stack([c.to(torch.float64) for c in count_cols] + float_cols, dim=1)

    def add(matrix):
        out = torch.zeros(G, len(terms), dtype=torch.float64, device=idx.device)
        return out.index_add_(0, idx, matrix)
    matrix = formed()
    add_ms = cuda_ms(lambda: add(matrix), 2)
    del matrix
    return cuda_ms(lambda: add(formed()), 2), add_ms


def stats_timings(df, cols, vt, plan, agg, gm, label):
    """Phase 9 for the statistics: query medians and B4/B5 kernel times at
    the shapes of std by id4 (G = 103, v3) and q9 (G = 10 609, v1 and v2),
    each base shifted by its first valid value as a pass shifts it."""
    plain = stats_plain(cols)
    for name, query in stats_queries(vt).items():
        plain_med, plain_s = median_s(plain[name])
        port_med, port_s = median_s(lambda: query(df))
        print(f"[{label}] stats {name} N={H2O_ROWS}: median {port_med!r} s (port) vs "
              f"{plain_med!r} s (plain torch), reps {REPS}; port s {port_s}; "
              f"plain s {plain_s}", flush=True)
    copy_bw, _ = copy_bandwidth(cols["v3"])
    G2 = (H2O_K + 3) ** 2
    shapes = {
        plan.B4: ((cols["id4"] + 1).to(torch.int32), H2O_K + 3, [cols["v3"]], agg.VAR_TERMS,
                  12, "idx 4 + v3 8"),
        plan.B5: (((cols["id4"] + 1) * (H2O_K + 3) + cols["id5"] + 1).to(torch.int32), G2,
                  [cols["v1"], cols["v2"]], agg.CORR_TERMS, 20, "idx 4 + v1 8 + v2 8"),
        # q6-sd's shape: var of v3 over the same grid, one window
        "b5 var": (((cols["id4"] + 1) * (H2O_K + 3) + cols["id5"] + 1).to(torch.int32), G2,
                   [cols["v3"]], agg.VAR_TERMS, 12, "idx 4 + v3 8"),
        # df.std's shape: var of v3 over one cell, no index (every row in bin 0)
        "b4 g1": (None, 1, [cols["v3"]], agg.VAR_TERMS, 8, "v3 8"),
    }
    results = {}
    for label, (idx, G, bases, terms, bytes_per_row, bytes_note) in shapes.items():
        name = label.split()[0]
        check(plan.moment_strategy(H2O_ROWS, G, len(terms), 1, gm.compiled(len(bases), terms))
              == name, f"{name} at G={G}")
        args = (idx, bases, terms, G, first_valid(bases))
        kernel_ms = cuda_ms(lambda: plan.MOMENT_KERNELS[name](*args), 5)
        plain_ms = cuda_ms(lambda: plan.MOMENT_PLAIN[name](*args), 2)
        got = plan.MOMENT_KERNELS[name](*args)
        want = plan.MOMENT_PLAIN[name](*args)
        check(torch.equal(got[0], want[0]), f"{name} counts at the query shape")
        if name == plan.B5:
            check(moment_sums_ok(plan.MOMENT_PLAIN[name], *args[:4], got, want, args[4]),
                  f"{name} sums within the bound of unordered summation")
        else:
            check(torch.allclose(got[1], want[1], rtol=RTOL, atol=ATOL), f"{name} sums")
        err = (got[1] - want[1]).abs().max().item()
        floor_ms = H2O_ROWS * bytes_per_row / copy_bw * 1e3
        form = f", {gm.grid_moments_window.last_parts} parts" if name == plan.B5 else ""
        print(f"[{label}] {name} N={H2O_ROWS} G={G} ({len(terms)} terms{form}): kernel "
              f"{kernel_ms!r} ms vs plain {plain_ms!r} ms; HBM floor at {bytes_per_row} B/row "
              f"({bytes_note}) {floor_ms!r} ms, kernel at {floor_ms / kernel_ms!r} of it; max "
              f"abs err {err!r}", flush=True)
        # in: idx and the base columns; out: one 8-byte row of G per term;
        # a multiply and an add per float term, an add per count term
        n_float = sum(a >= 0 for a, *_ in terms)
        bound_ms, bound_by = bound(
            H2O_ROWS * bytes_per_row + 8 * len(terms) * G,
            {"f64": 2 * H2O_ROWS * n_float, "int": H2O_ROWS * (len(terms) - n_float)})
        if G == 1:  # one call computes the same function over one cell
            library_ms, add_ms = cuda_ms(lambda: torch.var_mean(bases[0]), 5), None
            print(f"[{label}] {name} at G = 1: bound {bound_ms!r} ms by {bound_by}; "
                  f"torch.var_mean (the library call) {library_ms!r} ms", flush=True)
        else:
            library_ms, add_ms = library_moments_ms(idx, bases, terms, G, gm)
            print(f"[{label}] {name}: bound {bound_ms!r} ms by {bound_by} at "
                  f"{PEAK_BYTES / 1e12} TB/s; formed terms + one index_add_ of the [N, "
                  f"{len(terms)}] float64 matrix (the library call) {library_ms!r} ms, the "
                  f"index_add_ alone {add_ms!r} ms", flush=True)
        results[label] = {"ms": kernel_ms, "plain_ms": plain_ms, "err": err,
                          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                          "library_add_ms": add_ms}
        del idx
    # one entry of the kernels line for B5: q9's shape, q6-sd's beside it;
    # for B4 std by id4's, df.std's beside it
    var = results.pop("b5 var")
    results[plan.B5].update(var_ms=var["ms"], var_plain_ms=var["plain_ms"],
                            var_bound_ms=var["bound_ms"], var_library_ms=var["library_ms"],
                            var_max_abs_err=var["err"])
    g1 = results.pop("b4 g1")
    results[plan.B4].update(g1_ms=g1["ms"], g1_plain_ms=g1["plain_ms"],
                            g1_bound_ms=g1["bound_ms"], g1_library_ms=g1["library_ms"],
                            g1_max_abs_err=g1["err"])
    return results


def h2o_timings(df, cols, vt, plan, label):
    """Phase 9 for the wide path: query medians and the times of B2 and of
    both routes of B3 at the shape of q3."""
    plain = h2o_plain(cols)
    for name, query in h2o_queries(vt).items():
        plain_med, plain_s = median_s(plain[name])
        port_med, port_s = median_s(lambda: query(df))
        print(f"[{label}] H2O {name} N={H2O_ROWS}: median {port_med!r} s (port) vs "
              f"{plain_med!r} s (plain torch), reps {REPS}; port s {port_s}; "
              f"plain s {plain_s}", flush=True)
    copy_bw, copy_ms = copy_bandwidth(cols["v3"])
    print(f"[{label}] copy bandwidth {copy_bw / 1e12!r} TB/s (read + write, {copy_ms!r} ms)",
          flush=True)
    # kernel shapes of the queries, count + v1 (int64) + v3 (f64): the
    # fused bin layout of BinnerOrdinal (code + 2, +3 edges per key)
    G2, G3 = (H2O_K + 3) ** 2, H2O_K6 + 3
    shapes = {
        plan.B2: (((cols["id4"] + 1) * (H2O_K + 3) + cols["id5"] + 1).to(torch.int32), G2,
                  20, "idx 4 + v1 8 + v3 8, read once from HBM"),
        plan.B3: ((cols["id6"] + 1).to(torch.int32), G3, 12 + 3 * 16,
                  "phase 1a idx 4; 1b idx 4 + values 16 + low bits 2 + values 16; "
                  "2 low bits 2 + values 16"),
        plan.B3_L2: ((cols["id6"] + 1).to(torch.int32), G3, 20,
                     "idx 4 + v1 8 + v3 8, read once from HBM; the grid stays in L2"),
    }
    results = {}
    for name, (idx, G, bytes_per_row, bytes_note) in shapes.items():
        args = (idx, [cols["v1"]], [cols["v3"]], G)
        kernel_ms = cuda_ms(lambda: plan.KERNELS[name](*args, count=True), 5)
        plain_ms = cuda_ms(lambda: plan.PLAIN[name](*args, count=True), 2)
        got = plan.KERNELS[name](*args, count=True)
        want = plan.PLAIN[name](*args, count=True)
        check(torch.equal(got[0], want[0]), f"{name} ints at the query shape")
        check(additive_floats_ok(plan.PLAIN[name], idx, [cols["v3"]], G, got[1], want[1],
                                 want[0][0]),
              f"{name} floats within the bound of unordered summation")
        err = (got[1] - want[1]).abs().max().item()
        floor_ms = H2O_ROWS * bytes_per_row / copy_bw * 1e3
        print(f"[{label}] {name} N={H2O_ROWS} G={G} (count + v1 + v3): kernel {kernel_ms!r} "
              f"ms vs plain {plain_ms!r} ms; HBM floor at {bytes_per_row} B/row "
              f"({bytes_note}) {floor_ms!r} ms, kernel at {floor_ms / kernel_ms!r} of it; "
              f"max abs err {err!r}", flush=True)
        library_ms = library_additive_ms(idx, [cols["v1"]], [cols["v3"]], G)
        bound_ms, bound_by = additive_bound(H2O_ROWS, G, 1, 1)
        print(f"[{label}] {name}: bincount + 2 index_add_ (the library calls) {library_ms!r} "
              f"ms; bound {bound_ms!r} ms by {bound_by} (idx 4 + v1 8 + v3 8 B/row in, "
              f"3 x G x 8 B out) at {PEAK_BYTES / 1e12} TB/s", flush=True)
        results[name] = {"ms": kernel_ms, "plain_ms": plain_ms, "err": err,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        if name == plan.B3:
            results[name].update(partition_phases(idx, [cols["v1"]], [cols["v3"]], G, label))
        del idx
    # one entry of the kernels line for B3: the partition route, the
    # resident route at the same shape beside it
    resident = results.pop(plan.B3_L2)
    results[plan.B3].update(l2_ms=resident["ms"], l2_plain_ms=resident["plain_ms"],
                            l2_max_abs_err=resident["err"])
    return results


def partition_phases(idx, ints, floats, G, label):
    """ms of B3's count, of its offsets and scatter, and of its phase 2."""
    from vaex_tpu_torch.ops import grid_partition as gp
    lib = gp._library()
    n = idx.shape[0]
    sh = gp.shape(n, G, 1 + len(ints) + len(floats), gp._sm_count(idx.device))
    stream = torch.cuda.current_stream().cuda_stream
    rows_ms = cuda_ms(lambda: gp._partition_rows(lib, idx, G, sh, ints + floats, stream), 5)
    counts = torch.empty((sh.P, sh.n_seg), dtype=torch.int32, device="cuda")
    count_ms = cuda_ms(lambda: lib.grid_partition_count(
        idx.data_ptr(), n, G, sh.shift, sh.P, sh.seg_rows, sh.n_seg, gp.COUNT_THREADS,
        counts.data_ptr(), stream), 5)
    lo, bucket_start, moved = gp._partition_rows(lib, idx, G, sh, ints + floats, stream)
    launches = gp.grid_partition.launches
    sums_ms = cuda_ms(lambda: gp._bucket_sums(lib, lo, bucket_start, n, G, sh,
                                              moved[:len(ints)], moved[len(ints):], True,
                                              stream), 5)
    gp.grid_partition.launches = launches  # timing the phase alone is not a call of B3
    print(f"[{label}] b3 N={n} G={G} shape {tuple(sh)}: count {count_ms!r} ms, offsets + "
          f"scatter {rows_ms - count_ms!r} ms, phase 2 {sums_ms!r} ms", flush=True)
    return {"count_ms": count_ms, "scatter_ms": rows_ms - count_ms, "sums_ms": sums_ms}

# ------------------------------------------------------- the set-based path
def probe_inputs(gen, n, M, float_keys, spread=1):
    """M sorted unique keys (over a range of about 4M, times ``spread``) and
    n rows: hits, misses, rows below the first and above the last key and,
    for floats, -0.0 and NaN."""
    keys = (torch.randperm(4 * M, generator=gen, device="cuda")[:M].sort().values - M) * spread
    x = torch.randint(-M - 5, 3 * M + 6, (n,), generator=gen, device="cuda",
                      dtype=torch.int64) * spread
    if float_keys:
        keys, x = keys.to(torch.float64) * 0.5, x.to(torch.float64) * 0.5
        x[::7] = -0.0
        x[3::11] = float("nan")
    return keys, x


I64 = torch.iinfo(torch.int64)


def probe_edge_sets(gen, n):
    """(label, keys, rows): a set holding the int64 extremes, one holding
    +-inf, 0.0 and the largest finite float (rows with -0.0 and NaN), and
    int sets spanning exactly 2^32 - 1 (4-byte keys) and 2^32 (8-byte)."""
    ints = torch.tensor([I64.min, I64.min + 1, -5, 0, 7, I64.max - 1, I64.max], device="cuda")
    floats = torch.tensor([-float("inf"), -1.5, 0.0, 2.0, torch.finfo(torch.float64).max,
                           float("inf")], device="cuda", dtype=torch.float64)
    pick = lambda cands: cands[torch.randint(0, cands.numel(), (n,), generator=gen,  # noqa
                                             device="cuda")]
    int_rows = pick(torch.cat([ints, torch.tensor([I64.min + 2, 3, I64.max - 2],
                                                  device="cuda")]))
    float_rows = pick(torch.cat([floats, torch.tensor([-0.0, float("nan"), 1.0],
                                                      dtype=torch.float64, device="cuda")]))
    out = [("int64 extremes", ints, int_rows), ("float extremes", floats, float_rows)]
    lo = -(2 ** 40)
    for span in (2 ** 32 - 1, 2 ** 32):
        inner = torch.randperm(2 ** 20, generator=gen, device="cuda")[:60_000] * 4093 + 1
        keys = torch.cat([torch.tensor([0, span], device="cuda"), inner]).unique() + lo
        rows = torch.cat([keys, keys + 1, keys - 1, torch.tensor(
            [lo + 2 ** 32, lo - 2 ** 32, lo + 2 ** 33], device="cuda")])
        out.append((f"int64 span {span}", keys, pick(rows)))
    return out


def probe_vs_plain(probe):
    """Phase 10: both routes of B6 against the plain version, exact; returns
    the largest difference of any ordinal (0 when every check passed)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = 0

    def one(keys, x, what, narrow=None):
        nonlocal worst
        tree = probe.build_tree(keys, probe.compare_dtype(keys, x))
        check(tree.route == probe.probe_route(keys.numel(), tree.key_bytes),
              f"the route of the set's size, {what}")
        if narrow is not None:
            check((tree.kind == probe.KIND_NARROW) == narrow, f"4-byte keys {narrow}, {what}")
        before = probe.probe.wide_launches
        got = probe.probe(keys, x, tree)
        want = probe.probe_reference(keys, x)
        torch.cuda.synchronize()
        what = f"{tree.route} kind {tree.kind} {keys.dtype} {what}"
        check(probe.probe.wide_launches - before == int(tree.route == probe.B6_WIDE),
              f"launches of the route, {what}")
        worst = max(worst, int((got - want).abs().max()) if x.numel() else 0)
        check(got.dtype == torch.int32 and torch.equal(got, want), f"ordinals, {what}")
        if keys.is_floating_point() and x.numel() > 11:
            check(bool((got[torch.isnan(x)] == -1).all()), f"NaN rows give -1, {what}")
            zero = torch.nonzero(keys == 0)
            if zero.numel():
                check(bool((got[torch.signbit(x) & (x == 0)] == int(zero[0])).all()),
                      f"-0.0 rows find the key 0.0, {what}")
        print(f"{what} vs plain: exact, {int((got >= 0).sum())} rows hit", flush=True)
        return tree

    sizes = (1, 15, 16, 17, 64, 500, 2048, probe.MAX_KEYS, probe.MAX_KEYS + 1, 50_000,
             probe.NARROW_MAX_KEYS, probe.NARROW_MAX_KEYS + 1, 1_000_003)
    for float_keys in (False, True):
        for M in sizes:
            for n in KERNEL_SIZES:
                keys, x = probe_inputs(gen, n, M, float_keys)
                one(keys, x, f"M={M} N={n}")
                if not float_keys and M > probe.MAX_KEYS and n in (1, 1_000_003):
                    # the same set spread past 2^32: 8-byte keys
                    keys, x = probe_inputs(gen, n, M, False, spread=WIDE_FACTOR)
                    one(keys, x, f"spread M={M} N={n}", narrow=False)
                del keys, x
    for label, keys, x in probe_edge_sets(gen, 1_000_003):
        narrow = {"int64 span 4294967295": True, "int64 span 4294967296": False}.get(label)
        tree = one(keys, x, f"{label} M={keys.numel()}", narrow)
        if narrow is not None:  # the same sets forced onto 4-byte keys, where allowed
            forced = probe.build_tree(keys, narrow=True)
            check((forced.kind == probe.KIND_NARROW) == narrow, f"forced narrow, {label}")
            check(torch.equal(probe.probe(keys, x, forced), probe.probe_reference(keys, x)),
                  f"ordinals, {label} forced narrow")
    return worst


def make_sets_table(vt, cols):
    """The H2O-shaped columns WITHOUT categorize, plus two keys whose range
    is past 2^22 (so they take the set grouper), and the isin values."""
    cols = dict(cols)
    cols["k100"] = cols["id4"] * WIDE_FACTOR
    cols["k2000"] = (cols["id6"] % SET_KEYS["k2000"]) * WIDE_FACTOR
    cols["k1e6"] = cols["id6"] * WIDE_FACTOR
    ids = torch.randperm(H2O_K6, generator=torch.Generator().manual_seed(SEED)) + 1
    values = {"isin": ids[:ISIN_VALUES].numpy(), "isin wide": ids[:ISIN_WIDE_VALUES].numpy()}
    return vt.from_dataset(vt.DatasetArrays(cols)), cols, values


def sets_queries(vt, values):
    agg = {"v1": "sum", "v3": "mean"}
    return {
        "isin count": lambda df: df.count(selection=df.id6.isin(values["isin"])),
        "isin wide count": lambda df: df.count(selection=df.id6.isin(values["isin wide"])),
        "isin groupby": lambda df: df[df.id6.isin(values["isin"])].groupby("id4", agg=agg),
        "raw id4": lambda df: df.groupby("id4", agg=agg),
        "raw id6": lambda df: df.groupby("id6", agg=agg),
        # the GroupBy built first, then its agg: groupby(k, agg=...) over such
        # a wide int key takes the one-sort plan, which builds no set
        "set k100": lambda df: df.groupby("k100").agg({"v1": "sum"}),
        "set k2000": lambda df: df.groupby("k2000").agg({"v1": "sum"}),
        "set k1e6": lambda df: df.groupby("k1e6").agg({"v1": "sum"}),
        "nunique id6": lambda df: df.id6.nunique(),
        "unique id4": lambda df: df.id4.unique(),
    }


def sort_forms():
    """groupby(k, agg=...) over each set grouper's key: the one-sort plan,
    the twin of sets_queries' "set k" (the GroupBy built first)."""
    def form(key):
        return lambda df: df.groupby(key, agg={"v1": "sum"})
    return {key: form(key) for key in SET_KEYS}


# what each query's last pass must record: the probe route, and the kernel
# of its additive aggregation (None: the last pass is a set build)
SETS_EXPECT = {"isin count": ("b6", "b1"), "isin wide count": ("b6", "b1"),
               "isin groupby": ("b6", "b2"), "raw id4": (None, "b2"),
               "raw id6": (None, "b3"),
               "set k100": ("b6", "b1"), "set k2000": ("b6", "b2"),
               "set k1e6": ("b6-wide", "b3-l2"),
               "nunique id6": (None, None), "unique id4": (None, None)}


def sets_plain(cols, values):
    """The same answers in plain torch: isin, unique, aminmax, bincount and
    index_add_.  A groupby gives (keys, counts, v1 sums[, v3 sums])."""
    values = {name: torch.as_tensor(v, device="cuda") for name, v in values.items()}

    def grouped(key, keep=None, v3=True):
        k, v1 = cols[key], cols["v1"]
        if keep is not None:
            k, v1 = k[keep], v1[keep]
        lo, hi = (int(v) for v in torch.aminmax(k))
        size, k = hi - lo + 1, k - lo
        out = [torch.arange(lo, hi + 1, device="cuda"), torch.bincount(k, minlength=size),
               torch.zeros(size, dtype=torch.int64, device="cuda").index_add_(0, k, v1)]
        if v3:
            w = cols["v3"] if keep is None else cols["v3"][keep]
            out.append(torch.zeros(size, dtype=torch.float64, device="cuda").index_add_(0, k, w))
        return out

    def by_set(key):
        keys, inverse, counts = torch.unique(cols[key], return_inverse=True, return_counts=True)
        sums = torch.zeros(keys.numel(), dtype=torch.int64, device="cuda")
        return keys, counts, sums.index_add_(0, inverse, cols["v1"])
    return {
        "isin count": lambda: torch.isin(cols["id6"], values["isin"]).sum(),
        "isin wide count": lambda: torch.isin(cols["id6"], values["isin wide"]).sum(),
        "isin groupby": lambda: grouped("id4", torch.isin(cols["id6"], values["isin"])),
        "raw id4": lambda: grouped("id4"),
        "raw id6": lambda: grouped("id6"),
        "set k100": lambda: by_set("k100"),
        "set k2000": lambda: by_set("k2000"),
        "set k1e6": lambda: by_set("k1e6"),
        "nunique id6": lambda: torch.unique(cols["id6"]).numel(),
        "unique id4": lambda: torch.unique(cols["id4"]),
    }


def sets_check(name, out, want):
    """One set-based query's result against its plain torch answer."""
    if name in ("isin count", "isin wide count"):
        check(int(out) == int(want), f"{name} {int(out)} equals torch.isin's {int(want)}")
    elif name == "nunique id6":
        check(out == want, f"nunique {out} equals torch.unique's {want}")
    elif name == "unique id4":
        check(out == want.tolist(), "unique id4 in order")
    else:
        key = out.get_column_names()[0]
        keys, counts, v1, *v3 = (t.cpu() for t in want)
        keep = counts > 0
        check(out.get_column_names() == [key, "v1"] + ["v3"] * len(v3), f"{name} columns")
        check(torch.equal(torch.as_tensor(out.evaluate(key)), keys[keep]),
              f"{name} keys in order")
        check(torch.equal(torch.as_tensor(out.evaluate("v1")), v1[keep]), f"{name} v1 sums exact")
        if v3:
            check(torch.allclose(torch.as_tensor(out.evaluate("v3")), (v3[0] / counts)[keep],
                                 rtol=RTOL, atol=ATOL), f"{name} v3 means")


def sets_path(vt, plan, probe, cols):
    """Phase 11: the set-based queries once, checked; returns the table, the
    isin values and the launches of each kernel during them."""
    df, cols, values = make_sets_table(vt, cols)
    plain = sets_plain(cols, values)
    kernels = {**plan.KERNELS, "b6": probe.probe}
    for kernel in kernels.values():
        kernel.launches = 0
    probe.probe.wide_launches = 0
    outs = {}
    for name, query in sets_queries(vt, values).items():
        before, before_wide = probe.probe.launches, probe.probe.wide_launches
        route, kernel = SETS_EXPECT[name]
        before_additive = plan.KERNELS[kernel].launches if kernel else 0
        outs[name] = query(df)
        log = df.executor.trace_log[-1]
        additive = [s.get("additive") for s in log["strategies"]]
        print(f"sets {name} N={H2O_ROWS}: last pass probe {log['probe']}, strategies "
              f"{log['strategies']}, B6 launches {probe.probe.launches - before}", flush=True)
        check(log["probe"] == route, f"{name}: probe route {log['probe']}, expected {route}")
        check(additive == ([kernel] if kernel else []), f"{name}: additive kernels {additive}")
        check(not kernel or plan.KERNELS[kernel].launches > before_additive,
              f"{name}: launches of {kernel}")
        check((probe.probe.launches > before) == (route is not None), f"{name}: B6 launches")
        check((probe.probe.wide_launches > before_wide) == (route == "b6-wide"),
              f"{name}: launches of B6's b6-wide route")
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, kernel in kernels.items()}
    launches["b6-wide"] = probe.probe.wide_launches
    for name, out in outs.items():
        sets_check(name, out, plain[name]())
        print(f"sets {name}: checked against plain torch (ints and keys exact, floats rtol "
              f"{RTOL})", flush=True)
    print(f"launches during the set-based path: {launches}", flush=True)
    return df, cols, values, launches


def sets_timings(df, cols, values, vt, probe, label):
    """Phase 12: query medians (a groupby over a raw key with its pre-pass,
    and with the pre-pass remembered) and B6 at the isin shape."""
    plain = sets_plain(cols, values)

    def fresh(query):
        def run():
            df.dataset.remembered.clear()
            return query(df)
        return run
    queries = sets_queries(vt, values)
    medians = {}
    for name, query in queries.items():
        plain_med, plain_s = median_s(plain[name])
        port_med, port_s = median_s(fresh(query))
        again_med, _ = median_s(lambda: query(df))
        medians[name] = port_med
        print(f"[{label}] sets {name} N={H2O_ROWS}: median {port_med!r} s (port; {again_med!r} "
              f"s with the dense pre-pass remembered) vs {plain_med!r} s (plain torch), reps "
              f"{REPS}; port s {port_s}; plain s {plain_s}", flush=True)
    for key, query in sort_forms().items():
        got = query(df)
        entry = df.executor.trace_log[-1]
        check(entry.get("groupby") == "one-sort", f"groupby({key}, agg=...): {entry}")
        want = queries[f"set {key}"](df)
        for column in (key, "v1"):
            check(torch.equal(torch.as_tensor(got.evaluate(column)),
                              torch.as_tensor(want.evaluate(column))),
                  f"groupby({key}, agg=...) {column} equals the set path's")
        sort_med, sort_s = median_s(fresh(query))
        print(f"[{label}] sets one-sort {key} N={H2O_ROWS}: median {sort_med!r} s "
              f"(groupby({key}, agg=...), the one-sort plan) vs {medians[f'set {key}']!r} s "
              f"(groupby({key}).agg(...), the set path), reps {REPS}; one-sort s {sort_s}",
              flush=True)
    copy_bw, _ = copy_bandwidth(cols["v3"])
    x = cols["id6"]

    def library_probe(keys, x):
        # the PyTorch calls that compute the kernel's function
        idx = torch.searchsorted(keys, x).clamp_(max=keys.numel() - 1)
        return torch.where(keys[idx] == x, idx, -1).to(torch.int32)
    results = {}
    shapes = {name: (torch.as_tensor(ids, device="cuda").sort().values, x)
              for name, ids in values.items()}
    shapes["set k1e6"] = (torch.unique(cols["k1e6"]), cols["k1e6"])
    for name, (keys, x) in shapes.items():
        M = keys.numel()
        tree = probe.build_tree(keys)
        kernel_ms = cuda_ms(lambda: probe.probe(keys, x, tree), 5)
        plain_ms = cuda_ms(lambda: probe.probe_reference(keys, x), 2)
        library_ms = cuda_ms(lambda: library_probe(keys, x), 2)
        isin_ms = cuda_ms(lambda: torch.isin(x, keys), 2)
        got, want = probe.probe(keys, x, tree), probe.probe_reference(keys, x)
        check(torch.equal(got, want), f"b6 at the {name} shape")
        check(torch.equal(got, library_probe(keys, x)), f"b6 equals the library calls, {name}")
        check(torch.equal(got >= 0, torch.isin(x, keys)), "b6 membership equals torch.isin")
        err = float((got - want).abs().max())
        # in: the rows and the keys; out: an int32 per row; a compare per level
        # of a binary search and one for equality
        bound_ms, bound_by = bound(H2O_ROWS * 12 + 8 * M,
                                   {"int": H2O_ROWS * (M.bit_length() + 1)})
        floor_ms = H2O_ROWS * 12 / copy_bw * 1e3
        print(f"[{label}] {tree.route} N={H2O_ROWS} M={M} ({name}; {tree.key_bytes}-byte keys, "
              f"levels {tree.counts}): kernel {kernel_ms!r} ms vs plain (searchsorted + "
              f"gather + compare) {plain_ms!r} ms, the same as library calls {library_ms!r} ms, "
              f"torch.isin (membership only) {isin_ms!r} ms; HBM floor at 12 B/row (x 8 + out "
              f"4) {floor_ms!r} ms at the copy bandwidth, kernel at {floor_ms / kernel_ms!r} of "
              f"it; bound {bound_ms!r} ms by {bound_by} at {PEAK_BYTES / 1e12} TB/s; max abs "
              f"err {err!r}", flush=True)
        results[name] = {"ms": kernel_ms, "plain_ms": plain_ms, "err": err,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                         "isin_ms": isin_ms, "route": tree.route}
        del keys, got, want, tree
    for key, M_set in SET_KEYS.items():
        set_keys = torch.unique(cols[key])
        check(set_keys.numel() == M_set, f"{key} has {M_set} distinct values")
        tree = probe.build_tree(set_keys)
        ms = cuda_ms(lambda: probe.probe(set_keys, cols[key], tree), 5)
        p_ms = cuda_ms(lambda: probe.probe_reference(set_keys, cols[key]), 2)
        print(f"[{label}] {tree.route} N={H2O_ROWS} M={M_set} (the set grouper of {key}): "
              f"kernel {ms!r} ms vs plain {p_ms!r} ms", flush=True)
    # the entry of the kernels line: b6 at the isin shape, b6-wide at the
    # set grouper of k1e6 beside it (the 50 000 ids take b6 on 4-byte keys)
    check(results["isin"]["route"] == probe.B6 and results["isin wide"]["route"] == probe.B6
          and results["set k1e6"]["route"] == probe.B6_WIDE, "the routes of the timed sets")
    wide = results["set k1e6"]
    return {**results["isin"], "wide_ms": wide["ms"], "wide_plain_ms": wide["plain_ms"],
            "wide_library_ms": wide["library_ms"], "wide_isin_ms": wide["isin_ms"],
            "wide_bound_ms": wide["bound_ms"], "wide_max_abs_err": wide["err"],
            "isin_wide_ms": results["isin wide"]["ms"]}


# ------------------------------------------------- the binned-statistics path
EXTREME_GS = (1, 103, 10_609, 67_081, 1_000_003, 1_054_729)
BINBY_EXPECT = {  # what the last pass of each query must record
    "mean 2-D 1024": {"additive": "b3-l2"},
    "max 2-D 1024": {"extremes": "b3x-l2"},
    "max 2-D 2000": {"extremes": "b3x"},  # 32 MB of keys: past the resident route
    "minmax by x 128": {"extremes": "b3x-direct"},
    "q7": {"extremes": "b3x-l2"},
    "sum max min by id6": {"additive": "b3-l2", "extremes": "b3x-l2"},
    "first by id4": {"first": "b3x-direct"},
    "first by id4 past 2^53": {"first": "b3x-direct"},
}


def extreme_kernel_vs_plain(gp, ge):
    """Phase 13: B3x against its plain version, alone and with sums riding
    the partition; returns the worst float error of the sums (the extremes
    are exact or the phase fails)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    modes = ["min", "max", "min", "min", "max"]
    worst = 0.0
    for n in KERNEL_SIZES:
        ints = torch.randint(-(2 ** 62), 2 ** 62, (n,), generator=gen, device="cuda",
                             dtype=torch.int64)
        f64 = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64) * 100
        f64[::7] = float("nan")
        f64[1::11] = float("inf")
        f64[2::11] = float("-inf")
        f64[3::5] = 0.0
        f64[4::5] = -0.0
        f32 = torch.randn(n, generator=gen, device="cuda", dtype=torch.float32)
        valid = torch.rand(n, generator=gen, device="cuda") < 0.8
        summed = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64) * 100
        cols = [ints, f64, f32, f64, ints]
        valids = [None, None, None, valid, valid]
        keys = [(G, "uniform") for G in EXTREME_GS]
        if n == max(KERNEL_SIZES):
            keys += [(1_000_003, kind) for kind in SKEWS]
        for G, kind in keys:
            if kind == "uniform":
                idx = torch.randint(-2, G + G // 8 + 1, (n,), generator=gen, device="cuda",
                                    dtype=torch.int32)
            else:
                idx = skewed_keys(kind, gen, n, G)
            want = ge.grid_extreme_batch(idx, cols, modes, valids, G)
            got, _, _ = gp.grid_partition_extreme(idx, cols, modes, valids, G)
            resident = gp.grid_resident_extreme(idx, cols, modes, valids, G)
            both, int_sums, float_sums = gp.grid_partition_extreme(
                idx, cols, modes, valids, G, [ints], [summed], True)
            want_i, want_f = gp.grid_partition_reference(idx, [ints], [summed], G, True)
            torch.cuda.synchronize()
            what = f"b3x G={G} N={n} {kind} keys"
            for k, (a, r, b, w) in enumerate(zip(got, resident, both, want)):
                check(a.dtype == w.dtype and torch.equal(a, w),
                      f"{modes[k]} of {w.dtype} column {k} alone, {what}")
                check(r.dtype == w.dtype and torch.equal(r, w),
                      f"{modes[k]} of {w.dtype} column {k} on b3x-l2, {what}")
                check(b.dtype == w.dtype and torch.equal(b, w),
                      f"{modes[k]} of {w.dtype} column {k} beside sums, {what}")
            check(torch.equal(int_sums, want_i), f"int sums beside extremes, {what}")
            check(additive_floats_ok(gp.grid_partition_reference, idx, [summed], G, float_sums,
                                     want_f, want_i[0]),
                  f"f64 sums beside extremes within the bound of unordered summation, {what}")
            err = (float_sums - want_f).abs().max().item() if n else 0.0
            worst = max(worst, err)
            route = "b3x-direct" if gp.extreme_direct_fits(G, len(cols)) else "b3x"
            print(f"{what} vs plain: five extremes exact alone ({route}), on b3x-l2 and "
                  f"beside sums (b3x), int sums exact, f64 sums max abs err {err!r}", flush=True)
            del idx, want, got, resident, both
    return worst


def make_binby(vt, cols):
    """The H2O-shaped columns (id4, id6 categorized) beside continuous axes
    x, y, a value v with 1% NaN and an order column t, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = H2O_ROWS
    new = {"x": torch.randn(n, generator=gen, device="cuda", dtype=torch.float64),
           "y": torch.randn(n, generator=gen, device="cuda", dtype=torch.float64),
           "v": torch.rand(n, generator=gen, device="cuda", dtype=torch.float64) * 100,
           "t": torch.randint(0, 2 ** 62, (n,), generator=gen, device="cuda", dtype=torch.int64),
           # nanosecond-like orders past 2^53, where float64 ties neighbours
           "t53": 2 ** 60 + torch.randint(0, 2 ** 28, (n,), generator=gen, device="cuda",
                                          dtype=torch.int64)}
    new["v"][torch.rand(n, generator=gen, device="cuda") < 0.01] = float("nan")
    cols = {**{k: cols[k] for k in ("id4", "id6", "v1", "v2")}, **new}
    df = vt.from_dataset(vt.DatasetArrays(cols))
    df = df.categorize("id4", min_value=1, labels=range(1, H2O_K + 1))
    df = df.categorize("id6", min_value=1, labels=range(1, H2O_K6 + 1))
    return df, cols


def binby_queries(vt):
    a = vt.agg
    return {
        "limits minmax": lambda df: df.limits(["x", "y"], "minmax"),
        "limits 99.7%": lambda df: df.limits("x", "99.7%"),
        "count 2-D 256": lambda df: df.count(binby=["x", "y"], shape=256),
        "mean 2-D 1024": lambda df: df.mean("v", binby=["x", "y"], shape=1024),
        "max 2-D 1024": lambda df: df.max("v", binby=["x", "y"], shape=1024),
        "max 2-D 2000": lambda df: df.max("v", binby=["x", "y"], shape=2000),
        "minmax by x 128": lambda df: df.minmax("v", binby="x", shape=128),
        "q7": lambda df: df.groupby("id6", agg={"max_v1": a.max("v1"), "min_v2": a.min("v2")}),
        "sum max min by id6": lambda df: df.groupby(
            "id6", agg={"s": a.sum("v1"), "hi": a.max("v1"), "lo": a.min("v2")}),
        "first by id4": lambda df: df.first("v", "t", binby="id4"),
        "first by id4 past 2^53": lambda df: df.first("v", "t53", binby="id4"),
    }


def binby_plain(cols):
    """The same answers in plain torch: aminmax, bincount, index_add_ and
    scatter_reduce_ over bins computed with the binner's formula."""
    x, y, v, t = cols["x"], cols["y"], cols["v"], cols["t"]
    id4, id6 = cols["id4"] - 1, cols["id6"] - 1
    f64 = torch.float64

    def limits(c):
        lo, hi = torch.aminmax(c)
        return float(lo), float(hi)

    def axis(c, bins):
        """(bin, inside) of a continuous axis over its own min and max."""
        lo, hi = limits(c)
        # the binner's product with (1 / span) * bins, as XLA folds the reference's
        b = torch.floor((c - lo) * (1.0 / (hi - lo) * bins)).to(torch.int64)
        return b, (c >= lo) & (c < hi) & (b < bins)

    def cells(bins):
        bx, inx = axis(x, bins)
        by, iny = axis(y, bins)
        keep = inx & iny
        return (bx * bins + by)[keep], keep

    def percent():
        lo, hi = limits(x)
        b, inside = axis(x, 1024)
        counts = torch.bincount(b[inside], minlength=1024).cpu().numpy()
        return lo, hi, counts

    def mean(bins):
        cell, keep = cells(bins)
        w = v[keep]
        ok = ~torch.isnan(w)
        n = torch.bincount(cell[ok], minlength=bins * bins)
        s = torch.zeros(bins * bins, dtype=f64, device="cuda").index_add_(0, cell[ok], w[ok])
        return torch.where(n > 0, s / n, torch.nan).reshape(bins, bins)

    def extreme(cell, w, size, mode):
        ok = ~torch.isnan(w) if w.is_floating_point() else torch.ones_like(w, dtype=torch.bool)
        if w.is_floating_point():
            fill = float("-inf") if mode == "amax" else float("inf")
        else:
            fill = -(2 ** 63) if mode == "amax" else 2 ** 63 - 1
        out = torch.full((size,), fill, dtype=w.dtype, device="cuda")
        return out.scatter_reduce_(0, cell[ok], w[ok], mode, include_self=True)

    def max2d(bins):
        cell, keep = cells(bins)
        return extreme(cell, v[keep], bins * bins, "amax").reshape(bins, bins)

    def minmax1d(bins):
        b, inside = axis(x, bins)
        return torch.stack([extreme(b[inside], v[inside], bins, "amin"),
                            extreme(b[inside], v[inside], bins, "amax")], dim=-1)

    def first(order):
        """The value of the row with the smallest order per id4, the earliest
        among equal orders; an int64 order compares as int64 (a float64
        one as float64)."""
        ok = ~torch.isnan(v)
        top = I64.max if order.dtype == torch.int64 else float("inf")
        best = torch.full((H2O_K,), top, dtype=order.dtype, device="cuda")
        best.scatter_reduce_(0, id4[ok], order[ok], "amin", include_self=True)
        winner = ok & (order == best[id4])
        rows = torch.arange(v.numel(), device="cuda")
        row = torch.full((H2O_K,), v.numel(), dtype=torch.int64, device="cuda")
        row.scatter_reduce_(0, id4[winner], rows[winner], "amin", include_self=True)
        return v[row]
    return {
        "limits minmax": lambda: [limits(x), limits(y)],
        "limits 99.7%": percent,
        "count 2-D 256": lambda: torch.bincount(cells(256)[0], minlength=256 * 256),
        "mean 2-D 1024": lambda: mean(1024),
        "max 2-D 1024": lambda: max2d(1024),
        "max 2-D 2000": lambda: max2d(2000),
        "minmax by x 128": lambda: minmax1d(128),
        "q7": lambda: (extreme(id6, cols["v1"], H2O_K6, "amax"),
                       extreme(id6, cols["v2"], H2O_K6, "amin")),
        "sum max min by id6": lambda: (
            torch.zeros(H2O_K6, dtype=torch.int64, device="cuda").index_add_(0, id6, cols["v1"]),
            extreme(id6, cols["v1"], H2O_K6, "amax"), extreme(id6, cols["v2"], H2O_K6, "amin")),
        "first by id4": lambda: first(t),
        "first by id4 past 2^53": lambda: first(cols["t53"]),
        "first by id4 past 2^53 as float64": lambda: first(cols["t53"].to(f64)),
    }


def binby_check(name, out, want):
    """One binned statistic against its plain torch answer."""
    same = lambda got, w, what: check(  # noqa: E731
        torch.equal(torch.as_tensor(np.asarray(got)), w.cpu()), what)
    if name == "limits minmax":
        check([tuple(pair) for pair in out] == want, f"limits {out} equal aminmax's {want}")
    elif name == "limits 99.7%":
        lo, hi, counts = want
        cumulative = np.concatenate([[0], np.cumsum(counts) / counts.sum()])
        edges = np.linspace(lo, hi, 1025)
        expect = [np.interp(q, cumulative, edges) for q in (0.0015, 0.9985)]
        check(np.allclose(out, expect, rtol=RTOL, atol=ATOL), f"limits {out} against {expect}")
    elif name == "count 2-D 256":
        same(out, want.reshape(256, 256), "2-D counts exact")
    elif name == "mean 2-D 1024":
        check(torch.allclose(torch.as_tensor(out), want.cpu(), rtol=RTOL, atol=ATOL,
                             equal_nan=True), "2-D means")
    elif name in ("max 2-D 1024", "max 2-D 2000", "minmax by x 128", "first by id4",
                  "first by id4 past 2^53"):
        same(out, want, f"{name} exact")
    else:
        names = ["max_v1", "min_v2"] if name == "q7" else ["s", "hi", "lo"]
        for column, w in zip(names, want):
            same(out.evaluate(column), w, f"{name} {column} exact")
        check(out.evaluate(names[0]).dtype.name == "int64", f"{name} keeps int64")


def launch_counts(plan, gp):
    """The launches of every grid kernel, B3x by route."""
    counts = {name: kernel.launches
              for name, kernel in {**plan.KERNELS, **plan.MOMENT_KERNELS}.items()}
    direct = gp.grid_partition_extreme.direct_launches
    counts.update({plan.B3X: gp.grid_partition_extreme.launches - direct,
                   plan.B3X_DIRECT: direct, plan.B3X_L2: gp.grid_resident_extreme.launches})
    return counts


def zero_launches(plan, gp):
    for kernel in (*plan.KERNELS.values(), *plan.MOMENT_KERNELS.values(),
                   gp.grid_partition_extreme, gp.grid_resident_extreme):
        kernel.launches = 0
    gp.grid_partition_extreme.direct_launches = 0


def binby_path(vt, plan, gp, cols):
    """Phase 14: the binned statistics once, checked; returns the table and
    the launches of each kernel during them."""
    df, cols = make_binby(vt, cols)
    plain = binby_plain(cols)
    zero_launches(plan, gp)
    outs = {}
    for name, query in binby_queries(vt).items():
        before = launch_counts(plan, gp)
        outs[name] = query(df)
        strategies = df.executor.trace_log[-1]["strategies"]
        after = launch_counts(plan, gp)
        print(f"binby {name} N={H2O_ROWS}: pass strategies {strategies}, B3x launches "
              f"{ {r: after[r] - before[r] for r in (plan.B3X_DIRECT, plan.B3X_L2, plan.B3X)} }",
              flush=True)
        if name in BINBY_EXPECT:
            check(strategies == [BINBY_EXPECT[name]],
                  f"{name}: strategies {strategies}, expected {BINBY_EXPECT[name]}")
            # every route the pass names launched its kernel
            for route in BINBY_EXPECT[name].values():
                check(route not in after or after[route] > before[route],
                      f"{name}: launches of {route}")
    outs["first of an int64 max order"] = first_at_int64_max(vt)
    torch.cuda.synchronize()
    launches = launch_counts(plan, gp)
    for name, out in outs.items():
        if name == "first of an int64 max order":
            continue  # checked where it ran
        binby_check(name, out, plain[name]())
        print(f"binby {name}: checked against plain torch (counts, extremes and first exact, "
              f"floats rtol {RTOL})", flush=True)
    as_float = plain["first by id4 past 2^53 as float64"]().cpu()
    check(not torch.equal(torch.as_tensor(outs["first by id4 past 2^53"]), as_float),
          "orders past 2^53 compared as float64 give another first")
    print(f"launches during the binned-statistics path: {launches}", flush=True)
    return df, cols, launches


def first_at_int64_max(vt):
    """``first`` on the card where a cell's only order is the int64 maximum
    (B3x's image of it is its empty-cell mark) and two orders past 2^53
    differ by 1: numpy's argmin-based answer."""
    k = np.array([0, 0, 1, 1, 2, 3, 3], np.int64)
    o = np.array([2 ** 60 + 1, 2 ** 60, 5, 4, I64.max, I64.max, I64.max - 1], np.int64)
    v = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0])
    df = vt.from_arrays(k=k, o=o, v=v).to_device("cuda")
    df = df.categorize("k", labels=list(range(5)))
    out = df.first("v", "o", binby="k")
    want = [2.0, 4.0, 5.0, 7.0, 0.0]
    check(np.asarray(out).tolist() == want, f"first at the int64 max order: {out}, want {want}")
    route = df.executor.trace_log[-1]["strategies"]
    check(route == [{"first": "b3x-direct"}], f"first at the int64 max order took {route}")
    print(f"binby first of an int64 max order on the card: {want}, route {route}", flush=True)
    return out


def extreme_timing(kernel, args, label, what, ge):
    """One B3x route at one shape: its time against its plain version and
    scatter_reduce_ alone (the library call; the NaN rows sent to a drop
    bin), checked exactly, and its bound."""
    idx, cols, modes, valids, G = args
    kernel_ms = cuda_ms(lambda: kernel(*args), 5)
    plain_ms = cuda_ms(lambda: ge.grid_extreme_batch(*args), 2)
    got, want = kernel(*args), ge.grid_extreme_batch(*args)
    for g, w in zip(got, want):
        check(torch.equal(g, w), f"{what} at the query shape")
    bins = ge.extreme_bins(idx, G)
    dropped = [bins.masked_fill(torch.isnan(c), G) if c.is_floating_point() else bins
               for c in cols]

    def library():
        outs = []
        for c, m, b in zip(cols, modes, dropped):
            out = torch.full((G + 1,), ge.identity(c.dtype, m), dtype=c.dtype, device="cuda")
            outs.append(out.scatter_reduce_(0, b, c, ge.MODES[m], include_self=True)[:G])
        return outs
    library_ms = cuda_ms(library, 2)
    for g, w in zip(library(), want):
        check(torch.equal(g, w), f"{what} equals scatter_reduce_")
    # in: idx 4 B and 8 B a column per row; out: the grids; a compare per
    # row and column
    n, E = idx.shape[0], len(cols)
    bound_ms, bound_by = bound(n * (4 + 8 * E) + 8 * E * G, {"f64": n * E})
    print(f"[{label}] {what} N={n} G={G} E={E}: kernel {kernel_ms!r} ms vs plain {plain_ms!r} "
          f"ms, scatter_reduce_ alone (the library call) {library_ms!r} ms; bound "
          f"{bound_ms!r} ms by {bound_by} at {PEAK_BYTES / 1e12} TB/s", flush=True)
    err = max(float((g.double() - w.double()).masked_fill(g == w, 0.0).abs().max())
              for g, w in zip(got, want))
    return {"ms": kernel_ms, "plain_ms": plain_ms, "err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def binby_timings(df, cols, vt, gp, ge, plan, label):
    """Phase 15: query medians, and each route of B3x at its query's shape
    against its plain version and scatter_reduce_ alone: b3x-l2 at the 2-D
    max (G = 1 054 729, one f64 column with NaN) and at q7's (two int64
    columns over id6), b3x over a partition at the 2-D max of shape 2000 (G =
    4 012 009) and b3x-direct at minmax by x."""
    from vaex_tpu_torch.ops.binners import BinnerScalar, fuse_bins
    from vaex_tpu_torch.ops.nullable import NA
    plain = binby_plain(cols)
    for name, query in binby_queries(vt).items():
        plain_med, plain_s = median_s(plain[name])
        port_med, port_s = median_s(lambda: query(df))
        print(f"[{label}] binby {name} N={H2O_ROWS}: median {port_med!r} s (port) vs "
              f"{plain_med!r} s (plain torch), reps {REPS}; port s {port_s}; "
              f"plain s {plain_s}", flush=True)
    results = {}
    for shape, route, kernel in ((1024, plan.B3X_L2, gp.grid_resident_extreme),
                                 (2000, plan.B3X, lambda *a: gp.grid_partition_extreme(*a)[0])):
        binners = [BinnerScalar(c, *(float(m) for m in torch.aminmax(cols[c])), shape)
                   for c in ("x", "y")]
        idx = fuse_bins(binners, [b.to_bins(NA(cols[b.expression])) for b in binners])
        G = binners[0].shape * binners[1].shape
        check(plan.extreme_strategy(H2O_ROWS, G, 1) == route, f"{route} at G={G}")
        if shape == 1024:
            prolog_ms = cuda_ms(lambda: fuse_bins(binners, [b.to_bins(NA(cols[b.expression]))
                                                            for b in binners]), 3)
            print(f"[{label}] the two scalar binners and the fuse (eager torch) at shape 1024: "
                  f"{prolog_ms!r} ms", flush=True)
        results[route] = extreme_timing(kernel, (idx, [cols["v"]], ["max"], [None], G), label,
                                        f"{route} (max of v over the 2-D grid of shape {shape})",
                                        ge)
        del idx
    # b3x-l2 at q7's shape: max of v1 and min of v2 over id6's fused bins
    G7 = H2O_K6 + 3
    q7 = ((cols["id6"] + 1).to(torch.int32), [cols["v1"], cols["v2"]], ["max", "min"],
          [None, None], G7)
    check(plan.extreme_strategy(H2O_ROWS, G7, 2) == plan.B3X_L2, "q7's shape takes b3x-l2")
    at_q7 = extreme_timing(gp.grid_resident_extreme, q7, label, "b3x-l2 (q7)", ge)
    results[plan.B3X_L2].update({f"q7_{k}": at_q7[k] for k in ("ms", "plain_ms", "bound_ms",
                                                                 "library_ms")})
    del q7
    # the route over the raw rows at the shape of minmax(v, binby=x, shape=128)
    axis = BinnerScalar("x", *(float(m) for m in torch.aminmax(cols["x"])), 128)
    direct = (axis.to_bins(NA(cols["x"])), [cols["v"]], ["max"], [None], axis.shape)
    check(gp.extreme_direct_fits(axis.shape, 1), "the 1-D grid takes the direct route")
    results[plan.B3X_DIRECT] = extreme_timing(lambda *a: gp.grid_partition_extreme(*a)[0],
                                              direct, label, "b3x-direct (max of v by x)", ge)
    return results


# BASELINE config 2: filtered multi-agg (mean / std / min / max) over float64
# virtual-column expressions
CONFIG2_ROWS = 100_000_000
CONFIG2_VIRTUAL = (("r", "sqrt(x**2 + y**2)"), ("phi", "arctan2(y, x)"),
                   ("w", "log1p(z) * exp(-r)"), ("zc", "clip(z, 10, 90)"))
CONFIG2_NAMES = [name for name, _ in CONFIG2_VIRTUAL]
CONFIG2_CIRCLE = ("x", "y", 0.5, 0, 1)  # x, y, centre, radius
CONFIG2_BINS = 64


def config2_columns(n, device, seed=SEED):
    """x, y float64 N(0, 1) (every 97th x NaN), z float64 U[0, 100), i int64
    in 0..999, made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    y = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    x[::97] = float("nan")
    z = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * 100
    i = torch.randint(0, 1000, (n,), generator=gen, device=device, dtype=torch.int64)
    return {"x": x, "y": y, "z": z, "i": i}


def config2_frame(vt, cols):
    """The frame of config 2: the four virtual columns, the filter r < 2 and
    the circle of CONFIG2_CIRCLE as the selection "default"."""
    df = vt.from_dataset(vt.DatasetArrays(cols))
    for name, expression in CONFIG2_VIRTUAL:
        df[name] = expression
    df = df.filter("r < 2")
    df.select_circle(*CONFIG2_CIRCLE)
    return df


def config2_group(df):
    """Config 2's query group through the public API, as one pass: mean,
    std, min and max of each virtual column, the mean of r and w without
    and with the selection, and the selection's count of phi in 64 bins
    over [-pi, pi)."""
    pending = {stat: getattr(df, stat)(CONFIG2_NAMES, delay=True)
               for stat in ("mean", "std", "min", "max")}
    pending["mean by selection"] = df.mean(["r", "w"], selection=[None, True], delay=True)
    pending["count phi"] = df.count(binby="phi", limits=[-math.pi, math.pi],
                                    shape=CONFIG2_BINS, selection=True, delay=True)
    df.execute()
    return {name: np.asarray(p.get()) for name, p in pending.items()}


def config2_plain(cols):
    """The same answers written directly in torch on the same tensors, the
    rows the filter drops and NaN left out as vaex leaves them out; per
    statistic also what the checks need: each mean's row count and sums of
    |value| and |value|^2."""
    x, y, z = cols["x"], cols["y"], cols["z"]
    values = {"r": torch.sqrt(x ** 2 + y ** 2), "phi": torch.atan2(y, x)}
    values["w"] = torch.log1p(z) * torch.exp(-values["r"])
    values["zc"] = torch.clamp(z, 10, 90)
    keep = values["r"] < 2
    xc, yc, radius = CONFIG2_CIRCLE[2:]
    circle = keep & (((x - xc) ** 2 + (y - yc) ** 2) <= radius ** 2)
    out = {key: [] for key in ("mean", "std", "min", "max", "n", "abs1", "abs2")}
    for name in CONFIG2_NAMES:
        v = values[name][keep & ~torch.isnan(values[name])]
        n = v.numel()
        mean = v.sum() / n
        var = torch.clamp((v * v).sum() / n - mean ** 2, min=0)
        lo, hi = torch.aminmax(v)
        for key, value in (("mean", mean), ("std", torch.sqrt(var)), ("min", lo), ("max", hi),
                           ("n", n), ("abs1", v.abs().sum()), ("abs2", (v * v).sum())):
            out[key].append(float(value))
    sel = []
    for name in ("r", "w"):
        per = []
        for rows in (keep, circle):
            v = values[name][rows & ~torch.isnan(values[name])]
            per.append((float(v.sum() / v.numel()), v.numel(), float(v.abs().sum())))
        sel.append(per)
    out["mean by selection"] = sel
    phi = values["phi"][circle]
    b = torch.floor((phi + math.pi) / (2 * math.pi) * CONFIG2_BINS).to(torch.int64)
    inside = (phi >= -math.pi) & (phi < math.pi) & (b < CONFIG2_BINS)
    out["count phi"] = torch.bincount(b[inside], minlength=CONFIG2_BINS).cpu().numpy()
    return out


def config2_check(got, want):
    """Counts, min and max exact; each mean within the bound of float64
    summation in any order (:func:`within_sum_bound`, over the mean: S / n
    and n); each std within that bound carried through var = E[v^2] -
    E[v]^2."""
    f64 = torch.float64
    for stat in ("min", "max"):
        check(np.array_equal(got[stat], np.asarray(want[stat])), f"config 2 {stat}")
    n = torch.tensor(want["n"], dtype=f64)
    mean_want = torch.tensor(want["mean"], dtype=f64)
    s1, s2 = torch.tensor(want["abs1"], dtype=f64), torch.tensor(want["abs2"], dtype=f64)
    check(within_sum_bound(torch.as_tensor(got["mean"], dtype=f64), mean_want, s1 / n, n),
          f"config 2 means {got['mean']} against {want['mean']}")
    e1, e2 = 2.0 ** -52 * s1, 2.0 ** -52 * s2  # the bounds of E[v] and E[v^2]
    std_got = torch.as_tensor(got["std"], dtype=f64)
    std_want = torch.tensor(want["std"], dtype=f64)
    dvar = e2 + 2 * mean_want.abs() * e1 + e1 ** 2
    bound = RTOL * std_want + ATOL + dvar / (std_got + std_want)
    check(bool(((std_got - std_want).abs() <= bound).all()),
          f"config 2 stds {got['std']} against {want['std']}")
    for e, per in enumerate(want["mean by selection"]):
        for k, (mean, count, abs_sum) in enumerate(per):
            check(within_sum_bound(torch.tensor([got["mean by selection"][e][k]], dtype=f64),
                                   torch.tensor([mean], dtype=f64),
                                   torch.tensor([abs_sum / count], dtype=f64),
                                   torch.tensor([count])),
                  f"config 2 mean of {['r', 'w'][e]} by selection {k}")
    check(got["count phi"].dtype == np.int64
          and np.array_equal(got["count phi"], want["count phi"]), "config 2 count of phi")


def config2_path(vt, plan, ga, gm, gp, label):
    """The config 2 phase: the group on the card, checked against plain
    torch, with B1's and B4's launches and routes asserted, then timed
    against plain torch.  Returns (launches per kernel, timings)."""
    n = CONFIG2_ROWS
    cols = config2_columns(n, "cuda")
    df = config2_frame(vt, cols)
    zero_launches(plan, gp)
    torch.cuda.reset_peak_memory_stats()
    got = config2_group(df)
    peak = torch.cuda.max_memory_allocated()
    launches = {name: kernel.launches for name, kernel in plan.KERNELS.items()}
    launches.update({name: kernel.launches for name, kernel in plan.MOMENT_KERNELS.items()})
    launches[plan.B3X] = gp.grid_partition_extreme.launches
    launches[plan.B3X_L2] = gp.grid_resident_extreme.launches
    entry = df.executor.trace_log[-1]
    tiles = entry["tiles"]
    want_strategies = [{"additive": plan.B1, "moments": plan.B4, "extremes": "reduce"},
                       {"additive": plan.B1}, {"additive": plan.B1}]
    check(entry["strategies"] == want_strategies,
          f"config 2 strategies {entry['strategies']} against {want_strategies}")
    # one B1 call a tile for each of the three aggregation tasks (no
    # selection, the selection, the selection binned by phi), one B4 call a
    # tile for the four std (4 bases, 12 terms: one batch)
    check(launches[plan.B1] == 3 * tiles, f"B1 launches in config 2: {launches[plan.B1]}")
    check(launches[plan.B4] == tiles, f"B4 launches in config 2: {launches[plan.B4]}")
    check(ga.grid_additive.last_route == ga.LANE, "B1's lane route in config 2")
    check(gm.grid_moments.last_route == gm.LANE, "B4's lane route in config 2")
    check(all(launches[k] == 0 for k in launches if k not in (plan.B1, plan.B4)),
          f"config 2 launched no other kernel: {launches}")
    want = config2_plain(cols)
    config2_check(got, want)
    print(f"config 2 N={n}: {tiles} tiles, strategies {entry['strategies']}, launches "
          f"{launches}, peak device memory {peak / 2 ** 30!r} GiB; results match plain "
          f"torch (counts, min, max exact; means and stds within the summation bound): "
          f"{ {k: v.tolist() for k, v in got.items()} }", flush=True)
    port_med, port_s = median_s(lambda: config2_group(df))
    plain_med, plain_s = median_s(lambda: config2_plain(cols))
    print(f"[{label}] config 2 group N={n}: median {port_med!r} s (port) vs {plain_med!r} s "
          f"(plain torch), reps {REPS}; port s {port_s}; plain s {plain_s}", flush=True)
    return launches, {"port_s": port_med, "plain_s": plain_med}


# BASELINE config 3: the H2O groupby suite, its ten questions on the raw
# (uncategorized) table
CONFIG3_ROWS = 100_000_000
CONFIG3_K = 100
CONFIG3_KEYS = ("id1", "id2", "id3", "id4", "id5", "id6")
# the kernels the phase must launch: B1 (q1, q4), B2 (q2, q9's count grid),
# b3-l2 (q3, q5), B5 (q6's sd, q9's corr), b3x-l2 (q7)
CONFIG3_KERNELS = ("b1", "b2", "b3-l2", "b5", "b3x-l2")


def config3_span(key, n):
    """The values of a key are 1 .. span."""
    return max(n // CONFIG3_K, 1) if key in ("id3", "id6") else CONFIG3_K


def config3_columns(n, device, seed=SEED):
    """The H2O groupby table as benchmarks/fixtures.py:28-40 draws it: id1,
    id2, id4, id5 int64 in 1..100, id3 and id6 in 1..n/100, v1 in 1..5, v2 in
    1..15, v3 float64 in [0, 100); made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(high):
        return torch.randint(1, high + 1, (n,), generator=gen, device=device, dtype=torch.int64)
    cols = {key: ints(config3_span(key, n)) for key in CONFIG3_KEYS}
    cols["v1"], cols["v2"] = ints(5), ints(15)
    cols["v3"] = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * 100
    return cols


def config3_questions(vt):
    """q1-q10 exactly as benchmarks/groupbyh2o.py:25-45 writes them."""
    a = vt.agg
    return {
        "q1": lambda df: df.groupby(["id1"], agg={"v1": "sum"}),
        "q2": lambda df: df.groupby(["id1", "id2"], agg={"v1": "sum"}),
        "q3": lambda df: df.groupby(["id3"], agg={"v1": "sum", "v3": a.mean("v3")}),
        "q4": lambda df: df.groupby(["id4"], agg={"v1": a.mean("v1"), "v2": a.mean("v2"),
                                                  "v3": a.mean("v3")}),
        "q5": lambda df: df.groupby(["id6"], agg={"v1": "sum", "v2": "sum", "v3": "sum"}),
        "q6": lambda df: df.groupby(["id4", "id5"],
                                    agg={"median_v3": a.median_approx("v3"),
                                         "sd_v3": a.std("v3", ddof=1)}),
        "q7": lambda df: df.groupby(["id3"], agg={"max_v1": a.max("v1"),
                                                  "min_v2": a.min("v2")}),
        "q8": lambda df: df.groupby(["id6"],
                                    agg={"largest1_v3": a.nth_largest("v3", 0),
                                         "largest2_v3": a.nth_largest("v3", 1)}),
        "q9": lambda df: df.groupby(["id2", "id4"], agg={"r2": a.corr("v1", "v2")}),
        "q10": lambda df: df.groupby(["id1", "id2", "id3", "id4", "id5", "id6"],
                                     agg={"v3": "sum", "v1": "count"}),
    }


def _config3_cells(cols, keys, n):
    """(each row's cell, the observed cells, their row counts, the key
    columns of the observed cells) for dense keys in 1 .. span."""
    spans = [config3_span(key, n) for key in keys]
    cell = None
    for key, span in zip(keys, spans):
        cell = cols[key] - 1 if cell is None else cell * span + (cols[key] - 1)
    counts = torch.bincount(cell, minlength=math.prod(spans))
    observed = torch.nonzero(counts).squeeze(1)
    values, rem = {}, observed
    for key, span in zip(keys[::-1], spans[::-1]):
        values[key] = rem % span + 1
        rem = rem // span
    return cell, observed, counts[observed], {key: values[key] for key in keys}


def _per_cell(cell, observed, v):
    size = int(observed[-1]) + 1 if observed.numel() else 0
    return torch.zeros(size, dtype=v.dtype, device=v.device).index_add_(0, cell, v)[observed]


def _sorted_in_cells(cell, v, descending=False):
    """The values sorted by (cell, value): two stable sorts."""
    order = torch.argsort(v, descending=descending, stable=True)
    order = order[torch.argsort(cell[order], stable=True)]
    return v[order]


def config3_plain(cols, n):
    """Each question answered in plain torch on the same tensors: bincount
    and index_add_ over the dense cells, two stable sorts for the median
    and the top two, torch.unique over the stacked keys for q10.  Returns
    per question {column: (kind, want, extra)}: kind "exact", "sum"
    (extra: the cell's row count and sum of |term|), "mean" (the same),
    "std" (count, sum of v, sum of v^2) or "corr" (count and the five sums
    of |term|)."""
    f64 = torch.float64
    v1, v2, v3 = cols["v1"], cols["v2"], cols["v3"]

    def keyed(keys):
        cell, observed, counts, values = _config3_cells(cols, keys, n)
        return cell, observed, counts, {k: ("exact", v, None) for k, v in values.items()}

    def q_sums(keys, names):
        cell, observed, counts, out = keyed(keys)
        for name in names:
            v = cols[name]
            s = _per_cell(cell, observed, v)
            out[name] = ("exact", s, None) if not v.is_floating_point() else (
                "sum", s, (counts, s))  # every v3 >= 0: its sum of |v3| is its sum
        return out

    def q_means(keys, names, out=None):
        cell, observed, counts, keys_out = keyed(keys)
        out = keys_out if out is None else out
        for name in names:
            s = _per_cell(cell, observed, cols[name].to(f64))
            out[name] = ("mean", s / counts, (counts, s))
        return out

    def q3():
        out = q_sums(["id3"], ["v1"])
        return q_means(["id3"], ["v3"], out)

    def q6():
        cell, observed, counts, out = keyed(["id4", "id5"])
        sv = _sorted_in_cells(cell, v3)
        starts = (torch.cumsum(counts, 0) - counts)
        c = counts.to(f64)
        p = 0.5 * (c - 1)
        lo, hi = torch.floor(p), torch.ceil(p)
        a, b = sv[starts + lo.to(torch.int64)], sv[starts + hi.to(torch.int64)]
        out["median_v3"] = ("exact", torch.where(a == b, a, a + (p - lo) * (b - a)), None)
        s1, s2 = _per_cell(cell, observed, v3), _per_cell(cell, observed, v3 * v3)
        mean = s1 / c
        var = torch.clamp(s2 / c - mean ** 2, min=0.0) * c / (c - 1)
        sd = torch.where(c > 1, torch.sqrt(var), torch.nan)
        out["sd_v3"] = ("std", sd, (c, s1, s2, 1))
        return out

    def q7():
        cell, observed, counts, out = keyed(["id3"])
        size = int(observed[-1]) + 1
        for name, v, mode, fill in (("max_v1", v1, "amax", -(2 ** 63)),
                                    ("min_v2", v2, "amin", 2 ** 63 - 1)):
            grid = torch.full((size,), fill, dtype=torch.int64, device=v.device)
            out[name] = ("exact", grid.scatter_reduce_(0, cell, v, mode)[observed], None)
        return out

    def q8():
        cell, observed, counts, out = keyed(["id6"])
        sv = _sorted_in_cells(cell, v3, descending=True)
        starts = torch.cumsum(counts, 0) - counts
        out["largest1_v3"] = ("exact", sv[starts], None)
        second = sv[torch.clamp(starts + 1, max=sv.numel() - 1)]
        out["largest2_v3"] = ("exact", torch.where(counts > 1, second, torch.nan), None)
        return out

    def q9():
        cell, observed, counts, out = keyed(["id2", "id4"])
        x, y = v1.to(f64), v2.to(f64)
        sums = [_per_cell(cell, observed, t) for t in (x * y, x, y, x * x, y * y)]
        c = counts.to(f64)
        exy, ex, ey, exx, eyy = (s / c for s in sums)
        r = (exy - ex * ey) / torch.sqrt((exx - ex ** 2) * (eyy - ey ** 2))
        out["r2"] = ("corr", torch.where(torch.isfinite(r), r, torch.nan), (c, *sums))
        return out

    def q10():
        keys = torch.stack([cols[k] for k in CONFIG3_KEYS], dim=1)
        unique, inverse = torch.unique(keys, dim=0, return_inverse=True)
        counts = torch.bincount(inverse)
        out = {k: ("exact", unique[:, i], None) for i, k in enumerate(CONFIG3_KEYS)}
        s = torch.zeros(unique.shape[0], dtype=f64, device=v3.device).index_add_(0, inverse, v3)
        out["v3"] = ("sum", s, (counts, s))
        out["v1"] = ("exact", counts, None)
        return out

    return {
        "q1": lambda: q_sums(["id1"], ["v1"]),
        "q2": lambda: q_sums(["id1", "id2"], ["v1"]),
        "q3": q3,
        "q4": lambda: q_means(["id4"], ["v1", "v2", "v3"]),
        "q5": lambda: q_sums(["id6"], ["v1", "v2", "v3"]),
        "q6": q6, "q7": q7, "q8": q8, "q9": q9, "q10": q10,
    }


def _column(df, name, device):
    col = df.dataset[name]
    return col.to(device) if isinstance(col, torch.Tensor) else torch.as_tensor(
        np.asarray(col), device=device)


def config3_check(question, out, want, device):
    """One question's frame against its plain answer: keys, ints, counts,
    min / max, top-k values and medians exact; sums and means within
    :func:`within_sum_bound`; sd and r2 within that bound carried through
    their formulas from the bound of each mean they are made of."""
    f64 = torch.float64
    check(out.get_column_names() == list(want), f"{question} columns {out.get_column_names()} "
                                                f"against {list(want)}")
    eps = 2.0 ** -52
    for name, (kind, value, extra) in want.items():
        got = _column(out, name, device)
        check(got.shape == value.shape, f"{question} {name}: shape {tuple(got.shape)} against "
                                        f"{tuple(value.shape)}")
        what = f"{question} {name} ({kind})"
        if kind == "exact":
            same = (got == value) | (got.is_floating_point() & torch.isnan(got)
                                     & torch.isnan(value))
            check(bool(same.all()), what)
        elif kind == "sum":
            counts, abs_sums = extra
            check(within_sum_bound(got.to(f64), value, abs_sums, counts), what)
        elif kind == "mean":
            counts, abs_sums = extra
            check(within_sum_bound(got.to(f64), value, abs_sums / counts, counts), what)
        elif kind == "std":
            c, s1, s2, ddof = extra
            e1, e2 = eps * s1, eps * s2  # the bounds of E[v] and E[v^2] (v >= 0)
            dvar = (e2 + 2 * (s1 / c) * e1 + e1 ** 2) * c / (c - ddof)
            bound = RTOL * value + ATOL + dvar / (got + value)
            same = ((got - value).abs() <= bound) | (torch.isnan(got) & torch.isnan(value))
            check(bool(same.all()), what)
        else:  # corr = cov / sqrt(vx vy) from the five means, first order
            c, *abs_sums = extra
            exy, ex, ey, exx, eyy = (s / c for s in abs_sums)  # every term >= 0
            e = [eps * s for s in abs_sums]
            vx, vy = exx - ex ** 2, eyy - ey ** 2
            dc = e[0] + ey * e[1] + ex * e[2]
            dvx, dvy = e[3] + 2 * ex * e[1], e[4] + 2 * ey * e[2]
            bound = (RTOL * value.abs() + ATOL + dc / torch.sqrt(vx * vy)
                     + value.abs() / 2 * (dvx / vx + dvy / vy))
            same = ((got - value).abs() <= bound) | (torch.isnan(got) & torch.isnan(value))
            check(bool(same.all()), what)


def config3_drive(vt, df, n, device):
    """Each question once through the public API, checked against plain
    torch; q10 on the one-sort route, unpacked where the keys' span product
    passes 2^62 (at 1e8 rows: 1e20).  Returns each question's route (the
    last pass's strategies, or the one-sort pass's record)."""
    cols = {name: df.dataset[name] for name in df.dataset}
    outs, routes = {}, {}
    for q, query in config3_questions(vt).items():
        outs[q] = query(df)
        entry = df.executor.trace_log[-1]
        routes[q] = ({k: entry[k] for k in ("groupby", "mode", "words", "groups")}
                     if "groupby" in entry else entry["strategies"])
        print(f"config 3 {q} N={n}: {routes[q]}", flush=True)
    unpacked = math.prod(config3_span(key, n) for key in CONFIG3_KEYS) >= 2 ** 62
    check(routes["q10"].get("groupby") == "one-sort"
          and routes["q10"]["mode"] == ("unpacked" if unpacked else "packed"),
          f"q10 took the one-sort route ({'unpacked' if unpacked else 'packed'}): "
          f"{routes['q10']}")
    plain = config3_plain(cols, n)
    for q, out in outs.items():
        config3_check(q, out, plain[q](), device)
        print(f"config 3 {q}: {len(out)} groups, checked against plain torch", flush=True)
    return routes


def config3_path(vt, plan, gp, probe, label, n=CONFIG3_ROWS):
    """The config 3 phase on the card: the ten questions driven once with
    every kernel count set to 0 (:func:`config3_drive`), the hand-written
    kernels of their classic passes asserted launched, then each question
    timed against plain torch.  Returns (launches per kernel during the
    drive, B6's too, per question (port s, plain s))."""
    df = vt.from_dataset(vt.DatasetArrays(config3_columns(n, "cuda")))
    zero_launches(plan, gp)
    probe.probe.launches = 0
    config3_drive(vt, df, n, "cuda")
    launches = {**launch_counts(plan, gp), "b6": probe.probe.launches}
    print(f"launches during config 3: {launches}", flush=True)
    for name in CONFIG3_KERNELS:
        check(launches[name] > 0, f"{name} was not launched during config 3: {launches}")
    plain = config3_plain({name: df.dataset[name] for name in df.dataset}, n)
    times = {}
    for q, query in config3_questions(vt).items():
        port_med, port_s = median_s(lambda: query(df))
        plain_med, plain_s = median_s(plain[q])
        times[q] = (port_med, plain_med)
        print(f"[{label}] config 3 {q} N={n}: median {port_med!r} s (port) vs {plain_med!r} s "
              f"(plain torch), reps {REPS}; port s {port_s}; plain s {plain_s}", flush=True)
    return launches, times


# BASELINE config 4 (BASELINE.json configs[3]): a join of a fact table of
# 1e9 rows against a dim table of 1e7, then isin and value_counts, with the
# shapes of benchmarks/join_isin.py:28-37
CONFIG4_FACT = 1_000_000_000
CONFIG4_DIM = 10_000_000
CONFIG4_LABELS = 100
CONFIG4_ISIN = (1000, 10)
CONFIG4_EDGE = (1_000_000, 100_000)  # the edge check's fact and dim rows
CHUNK = 1 << 26  # rows per chunk of the plain versions at config 4's size


def config4_tables(n_fact, n_dim, device, seed=SEED):
    """fact: key int64 uniform in [0, n_dim), x float64 U[0, 1); dim: key =
    arange(n_dim), label int64 uniform in [0, 100); the isin ids: 1000
    distinct dim keys and their first 10; made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fact = {"key": torch.randint(0, n_dim, (n_fact,), generator=gen, device=device,
                                 dtype=torch.int64),
            "x": torch.rand(n_fact, generator=gen, device=device, dtype=torch.float64)}
    dim = {"key": torch.arange(n_dim, device=device, dtype=torch.int64),
           "label": torch.randint(0, CONFIG4_LABELS, (n_dim,), generator=gen, device=device,
                                  dtype=torch.int64)}
    ids = torch.randperm(n_dim, generator=gen, device=device)[:max(CONFIG4_ISIN)].cpu().numpy()
    return fact, dim, {n: ids[:n] for n in CONFIG4_ISIN}


def config4_queries(vt, ids):
    """J2-J5 on the joined frame, J4 on the fact frame (J1 is the join)."""
    return {
        "J2 sum(label)": lambda fact, joined: joined.sum("label"),
        "J3 groupby(label)": lambda fact, joined: joined.groupby(
            "label", agg={"x": "sum", "n": "count"}),
        **{f"J4 isin {n}": (lambda v: lambda fact, joined: fact.count(
            selection=fact.key.isin(v)))(ids[n]) for n in CONFIG4_ISIN},
        "J5 value_counts(label)": lambda fact, joined: joined["label"].value_counts(),
    }


def plain_lookup(fact_key, dim_key):
    """J1 in plain torch: the dim keys sorted, each chunk of fact keys through
    searchsorted, a gather and a compare; the first dim row of each fact
    row, -1 where none."""
    sorted_keys, order = torch.sort(dim_key, stable=True)
    order = order.to(torch.int32)
    out = torch.empty(fact_key.shape[0], dtype=torch.int32, device=fact_key.device)
    last = sorted_keys.numel() - 1
    for i in range(0, fact_key.shape[0], CHUNK):
        x = fact_key[i:i + CHUNK]
        idx = torch.searchsorted(sorted_keys, x).clamp_(max=last)
        out[i:i + CHUNK] = torch.where(sorted_keys[idx] == x, order[idx], -1)
    return out


def config4_plain(fact, dim, lookup, ids):
    """J2-J5 in plain torch over the plain lookup, chunk by chunk: a gather
    of label, then a sum, index_add_ and bincount, torch.isin, torch.unique
    with counts.  Returns per query a function of no arguments."""
    label, x = dim["label"], fact["x"]

    def labels(i):
        look = lookup[i:i + CHUNK]
        keep = look >= 0
        return label.index_select(0, look.clamp(min=0)), keep

    def j2():
        total = torch.zeros((), dtype=torch.int64, device=label.device)
        for i in range(0, lookup.shape[0], CHUNK):
            lab, keep = labels(i)
            total += torch.where(keep, lab, 0).sum()
        return int(total)

    def j3():
        sums = torch.zeros(CONFIG4_LABELS, dtype=torch.float64, device=label.device)
        counts = torch.zeros(CONFIG4_LABELS, dtype=torch.int64, device=label.device)
        for i in range(0, lookup.shape[0], CHUNK):
            lab, keep = labels(i)
            lab, xs = lab[keep], x[i:i + CHUNK][keep]
            sums.index_add_(0, lab, xs)
            counts += torch.bincount(lab, minlength=CONFIG4_LABELS)
        groups = torch.nonzero(counts).squeeze(1)
        return groups, sums[groups], counts[groups]

    def j4(v):
        values = torch.as_tensor(v, device=label.device)
        total = torch.zeros((), dtype=torch.int64, device=label.device)
        for i in range(0, lookup.shape[0], CHUNK):
            total += torch.isin(fact["key"][i:i + CHUNK], values).sum()
        return int(total)

    def j5():
        keys, counts = [], []
        for i in range(0, lookup.shape[0], CHUNK):
            lab, keep = labels(i)
            k, c = torch.unique(lab[keep], return_counts=True)
            keys.append(k)
            counts.append(c)
        keys, inverse = torch.unique(torch.cat(keys), return_inverse=True)
        return keys, torch.zeros_like(keys).index_add_(0, inverse, torch.cat(counts))
    return {"J2 sum(label)": j2, "J3 groupby(label)": j3,
            **{f"J4 isin {n}": (lambda v: lambda: j4(v))(ids[n]) for n in CONFIG4_ISIN},
            "J5 value_counts(label)": j5}


def config4_check(name, got, want):
    """Counts, int sums, labels and value counts exact; the x sums of J3
    within the bound of phase 4 (x >= 0: each cell's sum of |x| is its
    sum)."""
    if name.startswith(("J2", "J4")):
        check(int(got) == want, f"config 4 {name}: {got} != {want}")
    elif name.startswith("J3"):
        groups, sums, counts = want
        dev = sums.device
        order = torch.as_tensor(np.argsort(got.evaluate("label"), kind="stable"), device=dev)
        check(torch.equal(torch.as_tensor(got.evaluate("label"), device=dev)[order], groups)
              and torch.equal(torch.as_tensor(got.evaluate("n"), device=dev)[order], counts),
              f"config 4 {name}: labels and counts")
        got_sums = torch.as_tensor(got.evaluate("x"), device=dev)[order]
        check(within_sum_bound(got_sums, sums, sums, counts), f"config 4 {name}: x sums")
    else:
        keys, counts = want
        check(dict(zip(got.index.tolist(), got.tolist()))
              == dict(zip(keys.tolist(), counts.tolist())), f"config 4 {name}")


def no_copy_to_host(fn):
    """Runs fn() under torch.profiler and returns (its result, the ms of
    device-to-host copies it made): 4 bytes a row of a lookup crossing to the
    host would take tens of ms at config 4's size."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        out = fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(device, "torch.profiler saw no device activity during the join")
    dtoh = sum(e.time_range.end - e.time_range.start for e in device if "DtoH" in e.name)
    return out, dtoh / 1e3


def plain_join(lk, lmask, rk, rmask):
    """A left join in plain torch, independent of the port's index: the
    valid right rows sorted stably, searchsorted left and right, the first
    match, then the further matches through repeat_interleave.  Returns
    (left row, right row or -1) of every joined row in the port's order."""
    rvalid = ~rmask if rmask is not None else torch.ones_like(rk, dtype=torch.bool)
    if rk.is_floating_point():
        rvalid &= ~torch.isnan(rk)
    rrows = torch.nonzero(rvalid).squeeze(1)
    sorted_keys, order = torch.sort(rk[rrows], stable=True)
    srows = rrows[order]
    lo = torch.searchsorted(sorted_keys, lk, side="left")
    hi = torch.searchsorted(sorted_keys, lk, side="right")
    cnt = hi - lo
    if lmask is not None:
        cnt[lmask] = 0
    if lk.is_floating_point():
        cnt[torch.isnan(lk)] = 0
    n = lk.shape[0]
    first = torch.where(cnt > 0, srows[lo.clamp(max=max(srows.numel() - 1, 0))], -1)
    extra = (cnt - 1).clamp(min=0)
    total = int(extra.sum())
    left_extra = torch.repeat_interleave(torch.arange(n, device=lk.device), extra)
    within = (torch.arange(total, device=lk.device)
              - torch.repeat_interleave(torch.cumsum(extra, 0) - extra, extra))
    right_extra = srows[torch.repeat_interleave(lo + 1, extra) + within]
    return (torch.cat([torch.arange(n, device=lk.device), left_extra]),
            torch.cat([first, right_extra]))


def config4_edges(vt, device, n=CONFIG4_EDGE[0], m=CONFIG4_EDGE[1]):
    """The join's edges on ``device`` against :func:`plain_join`, exactly:
    every third dim key missing and every seventh doubled; int keys with
    masked left keys, then float keys with NaN on both sides; how = left,
    inner and right, with allow_duplication.  Returns the probe routes."""
    from vaex_tpu_torch.column import ColumnMasked
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    base = torch.arange(m * 3 // 2, device=dev)
    base = base[base % 3 != 0][:m]
    rk = torch.cat([base, base[base % 7 == 1]])
    rk = rk[torch.randperm(rk.numel(), generator=gen, device=dev)]
    lk = torch.randint(-5, int(base[-1]) + 5, (n,), generator=gen, device=dev)
    lmask = torch.rand(n, generator=gen, device=dev) < 0.05
    routes = set()
    for kind in ("int", "float"):
        if kind == "int":
            lkey, rkey, rmask = ColumnMasked(lk, lmask), rk, None
            lplain, lm = lk, lmask
        else:
            lplain, rkey = lk.to(torch.float64) / 2, rk.to(torch.float64) / 2
            lplain[::61] = float("nan")
            rkey[::50] = float("nan")
            lkey, lm, rmask = lplain, None, None
        left = vt.from_dataset(vt.DatasetArrays({"key": lkey, "i": torch.arange(n, device=dev)}))
        right = vt.from_dataset(vt.DatasetArrays({"key": rkey,
                                                  "r": torch.arange(rk.numel(), device=dev)}))
        for how in ("left", "inner", "right"):
            joined = left.join(right, on="key", how=how, allow_duplication=True)
            routes.add(joined.executor.trace_log[-1]["probe"])
            if how == "right":
                rows, other = plain_join(rkey, rmask, lplain, lm)
                names = ("r", "i")
            else:
                rows, other = plain_join(lplain, lm, rkey, rmask)
                names = ("i", "r")
                if how == "inner":
                    keep = other >= 0
                    rows, other = rows[keep], other[keep]
            got_rows, got_other = (joined.evaluate(name) for name in names)
            check(len(joined) == rows.numel()
                  and np.array_equal(np.ma.getdata(got_rows), rows.cpu().numpy())
                  and np.array_equal(np.ma.getmaskarray(got_other), (other < 0).cpu().numpy())
                  and np.array_equal(np.ma.getdata(got_other)[other.cpu().numpy() >= 0],
                                     other[other >= 0].cpu().numpy()),
                  f"the {how} join of {kind} keys at {n} x {rk.numel()} rows equals plain torch's")
            print(f"config 4 edges: {how} join of {kind} keys, {len(joined)} rows, equal to plain "
                  f"torch's; probe {routes}", flush=True)
    return routes


def config4_drive(vt, fact, dim, ids, device):
    """J1-J5 once through the public API on ``device``, each checked against
    plain torch.  Returns (the joined frame, the plain lookup, J1's probe
    route, the ms of J1's device-to-host copies (on the card), B6's launches
    during J1: 0 on the CPU, where its wrapper takes its plain version)."""
    from vaex_tpu_torch.column import ColumnIndexed
    from vaex_tpu_torch.ops import probe
    probe.probe.launches = 0
    on_card = torch.device(device).type == "cuda"
    if on_card:
        joined, dtoh_ms = no_copy_to_host(lambda: fact.join(dim, on="key"))
    else:
        joined, dtoh_ms = fact.join(dim, on="key"), None
    j1_launches = probe.probe.launches
    route = joined.executor.trace_log[-1]["probe"]
    lookup = joined.dataset["label"]
    plain = plain_lookup(fact.dataset["key"], dim.dataset["key"])
    check(isinstance(lookup, ColumnIndexed) and lookup.mask is None
          and lookup.index.device.type == torch.device(device).type
          and lookup.index.dtype == torch.int32 and lookup.source is dim.dataset["label"],
          f"J1's lookup is an int32 tensor on {device}")
    check(torch.equal(lookup.index, plain), "J1's lookup equals plain torch's")
    check(joined.dataset["x"] is fact.dataset["x"], "J1 leaves the fact columns as they are")
    if on_card:
        check(j1_launches > 0, f"B6 launched during J1: {j1_launches}")
        check(dtoh_ms < 20, f"J1's lookup stays on the card: {dtoh_ms!r} ms of copies to the "
                            f"host")
    print(f"config 4 J1 join N={fact.dataset.row_count} M={dim.dataset.row_count}: probe "
          f"{route}, B6 launches {j1_launches}, lookup {tuple(lookup.index.shape)} "
          f"{lookup.index.dtype} on {lookup.index.device}, device-to-host copies "
          f"{dtoh_ms!r} ms; equal to plain torch's", flush=True)
    want = config4_plain(fact.dataset, dim.dataset, plain, ids)
    for name, query in config4_queries(vt, ids).items():
        got = query(fact, joined)
        config4_check(name, got, want[name]())
        print(f"config 4 {name}: checked against plain torch; probe "
              f"{fact.executor.trace_log[-1]['probe'] if name.startswith('J4') else None}",
              flush=True)
    return joined, plain, route, dtoh_ms, j1_launches


def config4_path(vt, plan, gp, probe, label, n_fact=CONFIG4_FACT, n_dim=CONFIG4_DIM):
    """The config 4 phase on the card: the edges at 1e6 x 1e5, then J1-J5
    driven once with every kernel count set to 0, B6 asserted launched in
    J1 and on b6-wide, then each query timed against plain torch (a warm-up,
    then the median of 5), and B6 alone at the join's shape.  Returns
    (launches per kernel during the drive, per query (port s, plain s), B6's
    entry at the join's shape)."""
    edge_routes = config4_edges(vt, "cuda")
    check(edge_routes == {probe.B6_WIDE}, f"the edges' joins probe on b6-wide: {edge_routes}")
    fact_cols, dim_cols, ids = config4_tables(n_fact, n_dim, "cuda")
    fact = vt.from_dataset(vt.DatasetArrays(fact_cols))
    dim = vt.from_dataset(vt.DatasetArrays(dim_cols))
    zero_launches(plan, gp)
    probe.probe.launches = probe.probe.wide_launches = 0
    joined, plain, route, dtoh_ms, j1_launches = config4_drive(vt, fact, dim, ids, "cuda")
    launches = {**launch_counts(plan, gp), "b6": probe.probe.launches,
                "b6-wide": probe.probe.wide_launches}
    print(f"launches during config 4: {launches}", flush=True)
    check(route == probe.B6_WIDE, f"J1 probes 1e7 keys on b6-wide: {route}")
    check(launches["b1"] > 0, f"B1 was not launched during config 4: {launches}")
    times = {}
    port = {"J1 join": lambda: fact.join(dim, on="key"),
            **{name: (lambda q: lambda: q(fact, joined))(query)
               for name, query in config4_queries(vt, ids).items()}}
    want = config4_plain(fact.dataset, dim.dataset, plain, ids)
    want["J1 join"] = lambda: plain_lookup(fact.dataset["key"], dim.dataset["key"])
    for name, run in port.items():
        run()
        port_med, port_s = median_s(run)
        want[name]()
        plain_med, plain_s = median_s(want[name])
        times[name] = (port_med, plain_med)
        print(f"[{label}] config 4 {name} N={n_fact} M={n_dim}: median {port_med!r} s (port) vs "
              f"{plain_med!r} s (plain torch), reps {REPS}; port s {port_s}; plain s {plain_s}",
              flush=True)
    del joined, plain
    b6 = config4_probe_timing(probe, fact_cols["key"], dim_cols["key"], label)
    return launches, times, {**b6, "j1_launches": j1_launches, "j1_dtoh_ms": dtoh_ms}


def config4_probe_timing(probe, fact_key, dim_key, label):
    """B6 alone at the join's shape (the fact keys among the 1e7 dim keys,
    the tree built before the timing) against its plain version, chunk by
    chunk, and the library calls (searchsorted, gather, compare)."""
    keys = torch.unique(dim_key)
    tree = probe.build_tree(keys)
    n, M = fact_key.numel(), keys.numel()

    def plain():
        for i in range(0, n, CHUNK):
            probe.probe_reference(keys, fact_key[i:i + CHUNK])

    def library():
        for i in range(0, n, CHUNK):
            x = fact_key[i:i + CHUNK]
            idx = torch.searchsorted(keys, x).clamp_(max=M - 1)
            torch.where(keys[idx] == x, idx, -1).to(torch.int32)
    kernel_ms = cuda_ms(lambda: probe.probe(keys, fact_key, tree), 3)
    plain_ms = cuda_ms(plain, 1)
    library_ms = cuda_ms(library, 1)
    err = 0
    for i in range(0, n, CHUNK):
        x = fact_key[i:i + CHUNK]
        got, want = probe.probe(keys, x, tree), probe.probe_reference(keys, x)
        check(torch.equal(got, want), "b6 at the join's shape equals its plain version")
        err = max(err, int((got - want).abs().max()))
    # in: the rows and the keys; out: an int32 per row; a compare per level
    # of a binary search and one for equality
    bound_ms, bound_by = bound(n * 12 + 8 * M, {"int": n * (M.bit_length() + 1)})
    print(f"[{label}] {tree.route} N={n} M={M} (config 4's join; {tree.key_bytes}-byte keys, "
          f"levels {tree.counts}): kernel {kernel_ms!r} ms vs plain {plain_ms!r} ms, library "
          f"calls (searchsorted + gather + compare) {library_ms!r} ms; bound {bound_ms!r} ms by "
          f"{bound_by}; max abs err {err}", flush=True)
    return {"join_ms": kernel_ms, "join_plain_ms": plain_ms, "join_library_ms": library_ms,
            "join_bound_ms": bound_ms, "join_max_abs_err": err, "join_route": tree.route}


PHASE19_ROWS = 100_000_000
# name: (statistic, expression, axes, shape, the route the plan must take,
# the kind of aggregator it is recorded under in trace_log)
PHASE19_GRIDS = {
    "count 12000^2": ("count", None, ("x", "y"), 12_000, "sort", "additive"),
    "mean 12000^2": ("mean", "v", ("x", "y"), 12_000, "sort", "additive"),
    "std 12000^2": ("std", "v", ("x", "y"), 12_000, "sort", "moments"),
    "max 8192^2": ("max", "v", ("x", "y"), 8192, "sort", "extremes"),
    "count 512^3": ("count", None, ("x", "y", "z"), 512, "sort", "additive"),
    "std of four 4096^2": ("std", ["x", "y", "z", "v"], ("x", "y"), 4096, "b3×2", "moments"),
}


def phase19_columns(n, device, seed=SEED):
    """x, y, z uniform in [0, 1), v normal, and u normal with 2% NaN, 0.5%
    +inf, 0.5% -inf, as float64 tensors on ``device``, and u's mask (10% of
    the rows missing)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    cols = {c: torch.rand(n, generator=gen, device=device, dtype=torch.float64)
            for c in "xyz"}
    cols["v"] = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    u = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    draw = torch.rand(n, generator=gen, device=device)
    u[draw < 0.02] = float("nan")
    u[(draw >= 0.02) & (draw < 0.025)] = float("inf")
    u[(draw >= 0.025) & (draw < 0.03)] = float("-inf")
    cols["u"] = u
    cols["u_mask"] = torch.rand(n, generator=gen, device=device) < 0.1
    return cols


def phase19_frame(vt, cols):
    from vaex_tpu_torch.column import ColumnMasked
    data = {c: cols[c] for c in "xyzv"}
    data["u"] = ColumnMasked(cols["u"], cols["u_mask"])
    return vt.from_dataset(vt.DatasetArrays(data))


def phase19_query(df, name, shape=None):
    stat, expr, axes, default, _, _ = PHASE19_GRIDS[name]
    kw = dict(binby=list(axes), shape=shape or default)
    return getattr(df, stat)(**kw) if expr is None else getattr(df, stat)(expr, **kw)


def phase19_cells(cols, axes, bins):
    """(cell, keep): each row's flat cell among bins^d over each axis's own
    min and max, by the binner's formula (floor((c - lo) * ((1 / span) *
    bins)), C9), and whether it lands inside (the edges are stripped)."""
    cell, keep = None, None
    for a in axes:
        c = cols[a]
        lo, hi = (float(t) for t in torch.aminmax(c))
        b = torch.floor((c - lo) * (1.0 / (hi - lo) * bins)).to(torch.int64)
        inside = (c >= lo) & (c < hi) & (b < bins)
        cell = b if cell is None else cell * bins + b
        keep = inside if keep is None else keep & inside
    return torch.where(keep, cell, 0), keep


def phase19_plain(cols, name, shape=None):
    """The second computation of one grid, sharing no code with the route:
    torch.bincount (with f64 weights for sums) for counts, sums and the
    sums of |value| the bound needs; for the max a sort by value, then a
    stable sort by cell, and the last row of each cell's run."""
    stat, expr, axes, default, _, _ = PHASE19_GRIDS[name]
    bins = shape or default
    size = bins ** len(axes)
    cell, keep = phase19_cells(cols, axes, bins)
    out_shape = (bins,) * len(axes)

    def sums(values):
        ok = keep & ~torch.isnan(values)
        w = torch.where(ok, values, 0.0)
        return [torch.bincount(cell, weights=x, minlength=size).reshape(out_shape)
                for x in (ok.to(torch.float64), w, w.abs(), w * w)]
    if stat == "count":
        return torch.bincount(cell[keep], minlength=size).reshape(out_shape)
    if stat == "max":
        v = cols[expr]
        ok = keep & ~torch.isnan(v)
        by_value = torch.argsort(torch.where(ok, v, float("-inf")))
        cells = torch.where(ok, cell, size)[by_value]
        sorted_cells, by_cell = torch.sort(cells, stable=True)
        last = torch.ones_like(sorted_cells, dtype=torch.bool)
        last[:-1] = sorted_cells[:-1] != sorted_cells[1:]
        last &= sorted_cells < size
        out = torch.full((size,), float("-inf"), dtype=torch.float64, device=v.device)
        out[sorted_cells[last]] = v[by_value][by_cell][last]
        return out.reshape(out_shape)
    if stat == "mean":
        return sums(cols[expr])
    return [sums(cols[e]) for e in ([expr] if isinstance(expr, str) else expr)]


def _bound(total, abs_total, n):
    return RTOL * total.abs() + ATOL + n * 2.0 ** -52 * abs_total


def _mean_ok(got, n, s, a):
    """A mean against the plain count and sums: NaN where a cell is empty,
    elsewhere within the bound of its sum over its count."""
    empty = n == 0
    got = torch.as_tensor(np.asarray(got), device=n.device)
    if not bool(torch.isnan(got[empty]).all()):
        return False
    full = ~empty
    return bool(((got[full] * n[full] - s[full]).abs() <= _bound(s, a, n)[full]).all())


def _std_ok(got, n, s, a, s2):
    """A std (ddof 0) against the plain count and sums: NaN where a cell is
    empty; elsewhere its square within the variance's bound, carried from
    the sums' (within_sum_bound's) through var = s2 / n - (s / n)^2."""
    got = torch.as_tensor(np.asarray(got), device=n.device)
    empty = n == 0
    if not bool(torch.isnan(got[empty]).all()):
        return False
    full = ~empty
    n, s, a, s2, got = n[full], s[full], a[full], s2[full], got[full]
    b1, b2 = _bound(s, a, n), _bound(s2, s2, n)
    var = torch.clamp(s2 / n - (s / n) ** 2, min=0)
    bound = b2 / n + (2 * s.abs() * b1 + b1 * b1) / (n * n) + 8 * 2.0 ** -52 * (
        s2 / n + (s / n) ** 2) + ATOL
    return bool(((got * got - var).abs() <= bound).all())


def phase19_check(name, got, want):
    """One grid of phase 19 against its second computation (raises)."""
    stat = PHASE19_GRIDS[name][0]
    if stat in ("count", "max"):
        got = torch.as_tensor(np.asarray(got))
        check(torch.equal(got, want.cpu()), f"phase 19 {name}: exact")
        if stat == "max":
            check(bool((got[(want == float("-inf")).cpu()] == float("-inf")).all()),
                  f"phase 19 {name}: empty cells hold -inf")
    elif stat == "mean":
        n, s, a, _ = want
        check(_mean_ok(got, n, s, a), f"phase 19 {name}: within the bound of phase 4")
    else:
        for k, (g, (n, s, a, s2)) in enumerate(zip(got if len(want) > 1 else [got], want)):
            check(_std_ok(g, n, s, a, s2), f"phase 19 {name} ({k}): within the bound")


def phase19_grids(vt, df, cols, shapes=None):
    """(a) once: each grid through the public API, its route asserted from
    trace_log and the grid checked against its second computation.  Returns
    {name: route}."""
    routes = {}
    for name, (_, _, _, _, route, kind) in PHASE19_GRIDS.items():
        shape = (shapes or {}).get(name)
        got = phase19_query(df, name, shape)
        strategies = df.executor.trace_log[-1]["strategies"]
        routes[name] = strategies[0].get(kind)
        check(routes[name] == route, f"phase 19 {name}: the route {routes[name]!r}, "
                                     f"not {route!r} ({strategies})")
        phase19_check(name, got, phase19_plain(cols, name, shape))
        print(f"phase 19 {name}: route {routes[name]}, checked against its second "
              f"computation", flush=True)
    return routes


def phase19_rows(vt, df, cols, n_sample=10 ** 6, n_eval=10 ** 6, n_arrays=10 ** 5,
                 n_range=10 ** 9):
    """(b) once: the rest of the frame's row operations on the table,
    each checked against plain torch.  Returns {check: seconds}."""
    x, y, v, u, mask = cols["x"], cols["y"], cols["v"], cols["u"], cols["u_mask"]
    N = x.shape[0]
    nan = torch.isnan(u)
    times = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        if x.is_cuda:
            torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        return out

    def same_sum(got, want_values, what):
        n = torch.tensor(float(want_values.numel()), dtype=torch.float64)
        ok = within_sum_bound(torch.tensor([float(got)], dtype=torch.float64),
                              want_values.sum().cpu().reshape(1), want_values.abs().sum().cpu()
                              .reshape(1), n.reshape(1))
        check(ok, f"phase 19 {what}: {got!r} against plain torch's {float(want_values.sum())!r}")
    check(timed("dropna count", lambda: int(df.dropna().count()))
          == int(((~mask) & ~nan).sum()), "phase 19 dropna().count()")
    check(timed("dropnan count", lambda: int(df.dropnan().count()))
          == int((~(nan & ~mask)).sum()), "phase 19 dropnan().count()")
    check(timed("dropinf count", lambda: int(df.dropinf().count()))
          == int((~torch.isinf(u) & ~mask).sum()), "phase 19 dropinf().count()")
    filled = torch.where(mask | nan, 0.0, u)
    got = timed("fillna sum", lambda: df.fillna(0).dropinf().sum("u"))
    same_sum(got, filled[~torch.isinf(filled)], "fillna(0).dropinf().sum('u')")
    check(int(df.fillna(0).count("u")) == N, "phase 19 fillna(0) leaves no missing u")
    df = df.copy()
    df["r"] = "sqrt(x**2 + y**2)"
    before = df.sum("r")
    mat = timed("materialize", lambda: df.materialize("r"))
    col = mat.dataset["r"]
    check(isinstance(col, torch.Tensor) and col.device == x.device and "r" not in
          mat.virtual_columns, f"phase 19 materialize leaves a tensor on {x.device}")
    after = mat.sum("r")
    check(float(after) == float(before), f"phase 19 sum(r) unchanged: {after!r}, {before!r}")
    same_sum(after, torch.sqrt(x ** 2 + y ** 2), "sum(r)")
    del mat, col
    rows = torch.from_numpy(np.random.default_rng(42).choice(N, n_sample, replace=False))
    got = timed("sample sum", lambda: df.sample(n=n_sample, random_state=42).sum("v"))
    same_sum(got, v[rows.to(v.device)], "sample(n, random_state=42).sum('v')")
    got = timed("shuffle sum", lambda: df.shuffle(random_state=42).sum("v"))
    same_sum(got, v, "shuffle(random_state=42).sum('v')")
    parts = timed("split_random", lambda: df.split_random([0.8, 0.2], random_state=1))
    check([len(p) for p in parts] == [round(0.8 * N), N - round(0.8 * N)],
          f"phase 19 split_random lengths {[len(p) for p in parts]}")
    del parts
    got = timed("evaluate selection", lambda: df.evaluate("v", 0, n_eval, selection="x > 0.5"))
    want = v[:n_eval][x[:n_eval] > 0.5].cpu().numpy()
    check(np.array_equal(got, want), "phase 19 evaluate(v, 0, n, selection='x > 0.5')")
    arrays = timed("to_arrays", lambda: df[:n_arrays].to_arrays(["x", "y", "z", "v", "u"]))
    for a, name in zip(arrays, "xyzv"):
        check(np.array_equal(a, cols[name][:n_arrays].cpu().numpy()), f"to_arrays {name}")
    m = mask[:n_arrays].cpu().numpy()
    check(np.array_equal(np.ma.getmaskarray(arrays[4]), m) and np.array_equal(
        np.ma.getdata(arrays[4])[~m], u[:n_arrays].cpu().numpy()[~m], equal_nan=True),
        "to_arrays u")
    big = vt.vrange(0, n_range).to_device(x.device)
    total, count = timed("vrange sum count", lambda: (big.sum("x"), big.count("x")))
    check(int(total) == n_range * (n_range - 1) // 2 and int(count) == n_range,
          f"phase 19 vrange(0, {n_range}): sum {total!r}, count {count!r}")
    print(f"phase 19 row operations checked against plain torch: {sorted(times)}", flush=True)
    return times


def median_ms(fn):
    """Median host-clock ms of fn() over 3 runs, after a warm-up."""
    fn()
    return median_s(fn, 3)[0] * 1e3


def phase19_path(vt, plan, gp, probe, label, n=PHASE19_ROWS):
    """Phase 19 on the card: (a) and (b) once with every kernel count set
    to 0 (B3's partition asserted launched by the split), then each grid
    query timed (a warm-up, then the median of 3) beside its second
    computation and its grid's copy to the host.  Returns (launches, the
    phase's JSON record)."""
    cols = phase19_columns(n, "cuda")
    df = phase19_frame(vt, cols)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(plan, gp)
    probe.probe.launches = probe.probe.wide_launches = 0
    routes = phase19_grids(vt, df, cols)
    row_times = phase19_rows(vt, df, cols)
    launches = {**launch_counts(plan, gp), "b6": probe.probe.launches,
                "b6-wide": probe.probe.wide_launches}
    print(f"launches during phase 19: {launches}", flush=True)
    check(launches[plan.B3] > 0, f"B3's partition was not launched by the split: {launches}")
    record = {"card": label, "rows": n, "grids": {}, "row_operations_s": row_times,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    for name, (stat, expr, axes, shape, _, _) in PHASE19_GRIDS.items():
        gc.collect()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        port_ms = median_ms(lambda: phase19_query(df, name))
        port_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        plain_ms = median_ms(lambda: phase19_plain(cols, name))
        # the finished grids' copy to the host, which a query returns
        grids = torch.empty((len(expr) if isinstance(expr, list) else 1,
                             (shape + 3) ** len(axes)),
                            dtype=torch.int64 if stat == "count" else torch.float64,
                            device="cuda")
        copy_ms = median_ms(lambda: grids.cpu())
        del grids
        entry = {"route": routes[name], "ms": port_ms, "plain_ms": plain_ms,
                 "host_copy_ms": copy_ms, "port_peak_gb": port_gb}
        record["grids"][name] = entry
        print(f"[{label}] phase 19 {name} N={n}: route {routes[name]}, median {port_ms!r} ms "
              f"(port; {port_gb!r} GB above the table at its peak; the grid's copy to the "
              f"host alone {copy_ms!r} ms) vs {plain_ms!r} ms (second computation, on the "
              f"card), reps 3", flush=True)
        torch.cuda.empty_cache()
    del df, cols
    torch.cuda.empty_cache()
    return launches, record



PHASE20_ROWS = 100_000_000
PHASE20_K6 = 1_000_000  # id6 in 1..1e6
# Gaia's source_id: a nested healpix index at level 12 times 2^35
SOURCE_ID_SPAN = 12 * 4 ** 12 * 2 ** 35
HEALPIX_LEVEL = 8
TOP_BIT = -(1 << 63)  # the top bit of an int64
U_ISIN = [1 | (1 << 63), 3, 5 | (1 << 63), 9]  # uint64 values; 9 is in no row
# per query the kinds and routes the last pass must record on the card
PHASE20_EXPECT = {
    "nunique id5 by id4": {"presence": "b2"},
    "nunique id6 by id4": {"nunique": "sort"},
    "nunique id6 binby id4": {"presence": "b3"},
    "mode": {"additive": "b2"},
    "mutual information": {"additive": "b2"},
    "healpix": {"additive": "b3-l2"},
    "shift sum": {"additive": "b1"},
    "diff sum": {"additive": "b1"},
    "rolling sum": {"additive": "b1"},
    "rolling max": {"extremes": "reduce"},
    "u sum": {"additive": "b1"},
    "u minmax": {"extremes": "reduce"},
    "u max by id4": {"extremes": "b3x-direct"},
}
# per query the probe route of its last pass (id6's set of 1e6 keys is past
# the tree that fits shared memory)
PHASE20_PROBES = {"u groupby count": "b6", "u isin": "b6", "nunique id5 by id4": "b6",
                  "nunique id6 by id4": "b6-wide", "nunique id6 binby id4": "b6-wide"}


def phase20_columns(n, device, seed=SEED, k6=PHASE20_K6):
    """Phase 7's H2O columns made again at ``n`` rows from ``seed`` (id4,
    id5 in 1..100, id6 in 1..k6, v1, v2 in 1..5, v3 in [0, 100)), x and y
    N(0, 1), u the int64 bits of a uint64 column (v1 with the top bit set
    on half the rows) and source_id int64 uniform in [0, 12 * 4^12 *
    2^35), as tensors on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(low, high):
        return torch.randint(low, high + 1, (n,), generator=gen, device=device,
                             dtype=torch.int64)
    cols = {"id4": ints(1, H2O_K), "id5": ints(1, H2O_K), "id6": ints(1, k6),
            "v1": ints(1, 5), "v2": ints(1, 5),
            "v3": torch.rand(n, generator=gen, device=device, dtype=torch.float64) * 100,
            "x": torch.randn(n, generator=gen, device=device, dtype=torch.float64),
            "y": torch.randn(n, generator=gen, device=device, dtype=torch.float64)}
    top = torch.rand(n, generator=gen, device=device) < 0.5
    cols["u"] = torch.where(top, cols["v1"] | TOP_BIT, cols["v1"])
    cols["source_id"] = torch.randint(0, SOURCE_ID_SPAN, (n,), generator=gen, device=device,
                                      dtype=torch.int64)
    return cols


def phase20_frame(vt, cols):
    """The columns as a frame; u is a uint64 column (``dataset.logical``)."""
    return vt.from_dataset(vt.DatasetArrays(dict(cols), logical={"u": np.dtype("uint64")}))


def phase20_queries(vt):
    by_id4 = {"binby": "id4", "limits": [0.5, 100.5], "shape": 100}
    ratio = vt.stat.mean("v3") / vt.stat.std("v3")
    return {
        "nunique id5 by id4": lambda df: df.groupby("id4", agg={"id5": "nunique"}, sort=True),
        "nunique id6 by id4": lambda df: df.groupby("id4", agg={"id6": "nunique"}, sort=True),
        "nunique id6 binby id4": lambda df: df.nunique("id6", binby="id4", limits=[0.5, 60.5],
                                                        shape=60),
        "cov": lambda df: df.cov(["v1", "v2", "v3"]),
        "cov by id4": lambda df: df.cov(["v1", "v2", "v3"], **by_id4),
        "mode": lambda df: df.mode("v3", mode_shape=64, **by_id4),
        "mutual information": lambda df: df.mutual_information("x", "y", mi_shape=256),
        "describe": lambda df: df.describe(),
        "healpix": lambda df: df.healpix_count(healpix_expression="source_id/34359738368",
                                               healpix_level=HEALPIX_LEVEL),
        "shift sum": lambda df: df.shift(1, "v3").sum("v3"),
        "diff sum": lambda df: df.diff(1, "v3").sum("v3"),
        "rolling sum": lambda df: df.rolling(5, column="v3").sum().sum("v3"),
        "rolling max": lambda df: df.rolling(5, column="v3").max().max("v3"),
        "u sum": lambda df: df.sum("u"),
        "u minmax": lambda df: df.minmax("u"),
        "u max by id4": lambda df: df.max("u", **by_id4),
        "u groupby count": lambda df: df.groupby("u", agg="count", sort=True),
        "u isin": lambda df: df.u.isin(U_ISIN).sum(),
        "stat mean/std by id4": lambda df: ratio.calculate(df, **by_id4),
    }


def phase20_answer(name, out):
    """A query's output as host arrays and numbers: a groupby frame as
    {"keys", "values"}, describe's frame as {row: [per column]}."""
    if name.startswith("nunique id") and "by id4" in name and "binby" not in name:
        value = name.split()[1]
        return {"keys": np.asarray(out.evaluate("id4")), "values": np.asarray(out.evaluate(value))}
    if name == "u groupby count":
        return {"keys": np.asarray(out.evaluate("u")), "values": np.asarray(out.evaluate("count"))}
    if name == "describe":
        return {"columns": list(out.columns),
                **{row: list(out.loc[row]) for row in ("count", "NA", "mean", "std", "min", "max")}}
    return np.asarray(out) if isinstance(out, np.ndarray) or np.ndim(out) else out


def _sums(cell, size, values):
    """Per cell: rows, sum, sum of |value| and sum of squares (float64);
    of one cell plain sums (``bincount`` would add every row at one
    address)."""
    w = values.to(torch.float64)
    terms = (torch.ones_like(w), w, w.abs(), w * w)
    if size == 1:
        return [t.sum().reshape(1) for t in terms]
    return [torch.bincount(cell, weights=t, minlength=size) for t in terms]


def _unsigned(bits):
    """int64 bits as the Python int of their uint64."""
    return int(bits) % 2 ** 64


def phase20_plain(cols, name, k6=PHASE20_K6):
    """One query's answer computed in plain torch on the same tensors,
    sharing no code with the port: bincount, unique, scatter_reduce, sums
    of shifted slices."""
    c = cols
    n = c["v3"].shape[0]
    id4 = c["id4"] - 1
    if name == "nunique id5 by id4":
        present = torch.bincount(id4 * H2O_K + c["id5"] - 1, minlength=H2O_K ** 2) > 0
        return present.reshape(H2O_K, H2O_K).sum(1)
    if name == "nunique id6 by id4":
        pairs = torch.unique(id4 * k6 + c["id6"] - 1)
        return torch.bincount(pairs // k6, minlength=H2O_K)
    if name == "nunique id6 binby id4":
        keep = c["id4"] <= 60
        pairs = torch.unique((id4 * k6 + c["id6"] - 1)[keep])
        return torch.bincount(pairs // k6, minlength=60)
    if name in ("cov", "cov by id4"):
        cell = id4 if name == "cov by id4" else torch.zeros_like(id4)
        size = H2O_K if name == "cov by id4" else 1
        names = ["v1", "v2", "v3"]
        means = [_sums(cell, size, c[e]) for e in names]
        cross = {(i, j): _sums(cell, size, c[names[i]] * c[names[j]])
                 for i in range(3) for j in range(i, 3)}
        return means, cross
    if name in ("mode", "mutual information"):
        axes = [("v3", 64)] if name == "mode" else [("x", 256), ("y", 256)]
        cell = id4 if name == "mode" else torch.zeros_like(id4)
        keep = torch.ones_like(c["v3"], dtype=torch.bool)
        limits = []
        for e, bins in axes:
            lo, hi = (float(t) for t in torch.aminmax(c[e]))
            b = torch.floor((c[e] - lo) * (1.0 / (hi - lo) * bins)).to(torch.int64)
            keep &= (c[e] >= lo) & (c[e] < hi) & (b < bins)
            cell = cell * bins + torch.where(keep, b, 0)
            limits.append((lo, hi))
        size = (H2O_K * 64) if name == "mode" else 256 * 256
        counts = torch.bincount(cell[keep], minlength=size).cpu().numpy()
        if name == "mode":
            lo, hi = limits[0]
            centers = np.linspace(lo, hi, 65)[:-1] + (hi - lo) / 64 / 2
            return centers[np.argmax(counts.reshape(H2O_K, 64), axis=-1)]
        pxy = counts.reshape(256, 256) / counts.sum()
        px, py = pxy.sum(axis=1, keepdims=True), pxy.sum(axis=0, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.nansum(pxy * np.log(pxy / (px * py))))
    if name == "describe":
        out = {}
        for e, t in c.items():
            if e == "u":
                image = t ^ TOP_BIT
                lo, hi = (_unsigned(v ^ TOP_BIT) for v in torch.aminmax(image))
                w = torch.where(t < 0, t.to(torch.float64) + 2.0 ** 64, t.to(torch.float64))
            else:
                lo, hi = (v.item() for v in torch.aminmax(t))
                w = t.to(torch.float64)
            out[e] = {"count": n, "abs": float(w.abs().sum()),
                      "sum": float(w.sum()), "squares": float((w * w).sum()), "min": lo,
                      "max": hi}
        return out
    if name == "healpix":
        pixel = (c["source_id"].to(torch.float64) / 2.0 ** 35).to(torch.int64)
        pixel = pixel // 4 ** (12 - HEALPIX_LEVEL)
        return torch.bincount(pixel, minlength=12 * 4 ** HEALPIX_LEVEL)
    v3 = c["v3"]
    if name == "shift sum":
        return v3[:-1]
    if name == "diff sum":
        return v3[1:] - v3[:-1]
    if name in ("rolling sum", "rolling max"):
        if name == "rolling max":
            return v3.max().item()  # every row lies in a full window of 5
        pad = torch.cat([torch.zeros(4, dtype=v3.dtype, device=v3.device), v3])
        return pad[0:n] + pad[1:n + 1] + pad[2:n + 2] + pad[3:n + 3] + pad[4:n + 4]
    u = c["u"]
    if name == "u sum":
        return _unsigned(u.sum())
    if name == "u minmax":
        return [_unsigned(v ^ TOP_BIT) for v in torch.aminmax(u ^ TOP_BIT)]
    if name == "u max by id4":
        image = torch.full((H2O_K,), TOP_BIT, dtype=torch.int64, device=u.device)
        image.scatter_reduce_(0, id4, u ^ TOP_BIT, "amax")
        return [_unsigned(v) for v in (image ^ TOP_BIT).tolist()]
    if name == "u groupby count":
        image, counts = torch.unique(u ^ TOP_BIT, return_counts=True)
        return [_unsigned(v) for v in (image ^ TOP_BIT).tolist()], counts
    if name == "u isin":
        wanted = torch.tensor([v - 2 ** 64 if v >= 2 ** 63 else v for v in U_ISIN],
                              dtype=torch.int64, device=u.device)
        return int(torch.isin(u, wanted).sum())
    if name == "stat mean/std by id4":
        return _sums(id4, H2O_K, v3)
    raise KeyError(name)


def _close(got, want, bound):
    return bool(np.all(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
                       <= np.asarray(bound, np.float64)))


def _mean_error(n, s, a):
    """The bound of a mean's error: its sum's (within_sum_bound) over n."""
    return (RTOL * abs(s) + ATOL + n * 2.0 ** -52 * a) / n


def _std_error(n, s, a, s2):
    """The bound of a std's error where the std is d: d^2's, from the
    sums' through var = s2 / n - (s / n)^2, over 2 d."""
    b1, b2 = RTOL * abs(s) + ATOL + n * 2.0 ** -52 * a, RTOL * s2 + ATOL + n * 2.0 ** -52 * s2
    var = max(s2 / n - (s / n) ** 2, 0.0)
    var_bound = (b2 / n + (2 * abs(s) * b1 + b1 * b1) / (n * n)
                 + 8 * 2.0 ** -52 * (s2 / n + (s / n) ** 2) + ATOL)
    return var, var_bound


def phase20_check(name, got, want):
    """One query's answer (:func:`phase20_answer`) against its plain
    computation; raises where they disagree.  Counts, int sums, uint64 sums
    / min / max, nunique, mode centres and healpix counts exact; cov,
    mutual information, describe's mean / std, the stat ratio and the
    rolling / shifted sums within the bound of phase 4."""
    host = lambda t: t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)  # noqa: E731
    what = f"phase 20 {name}"
    if name in ("nunique id5 by id4", "nunique id6 by id4"):
        check(np.array_equal(got["keys"], np.arange(1, H2O_K + 1)), f"{what}: keys")
        check(np.array_equal(got["values"], host(want)), f"{what}: exact")
    elif name in ("nunique id6 binby id4", "healpix"):
        check(np.array_equal(got, host(want)), f"{what}: exact")
    elif name in ("cov", "cov by id4"):
        means, cross = want
        m = [(host(n_), host(s), host(a)) for n_, s, a, _ in means]
        errors = [_mean_error(n_, s, a) for n_, s, a in m]
        got = got.reshape(-1, 3, 3)
        for (i, j), (n_, s, a, _) in cross.items():
            n_, s, a = host(n_), host(s), host(a)
            mi, mj = m[i][1] / m[i][0], m[j][1] / m[j][0]
            mij = s / n_
            want_ij = mij - mi * mj
            bound = (_mean_error(n_, s, a) + np.abs(mi) * errors[j] + np.abs(mj) * errors[i]
                     + errors[i] * errors[j] + 4 * 2.0 ** -52 * (np.abs(mij) + np.abs(mi * mj)))
            check(_close(got[:, i, j], want_ij, bound) and _close(got[:, j, i], want_ij, bound),
                  f"{what} [{i}, {j}]: within the bound of phase 4")
    elif name == "mode":
        check(np.array_equal(got, want), f"{what}: the centres, exact")
    elif name == "mutual information":
        check(abs(got - want) <= 1e-12 * abs(want), f"{what}: {got!r} against {want!r}")
    elif name == "describe":
        check(got["columns"] == list(want), f"{what}: columns {got['columns']}")
        for k, e in enumerate(got["columns"]):
            w = want[e]
            n_ = w["count"]
            check(got["count"][k] == n_ and got["NA"][k] == 0, f"{what} {e}: counts")
            kind = type(w["min"])
            check(kind(got["min"][k]) == w["min"] and kind(got["max"][k]) == w["max"],
                  f"{what} {e}: min {got['min'][k]!r}, max {got['max'][k]!r}")
            # every mean adds in float64, an int one too (its int64 sum would wrap)
            ok = abs(got["mean"][k] - w["sum"] / n_) <= _mean_error(n_, w["sum"], w["abs"])
            check(ok, f"{what} {e}: mean {got['mean'][k]!r}")
            var, var_bound = _std_error(n_, w["sum"], w["abs"], w["squares"])
            check(abs(got["std"][k] ** 2 - var) <= var_bound, f"{what} {e}: std within the bound")
    elif name in ("shift sum", "diff sum", "rolling sum"):
        n_ = float(want.numel())
        total, abs_total = float(want.sum()), float(want.abs().sum())
        check(abs(float(got) - total) <= RTOL * abs(total) + ATOL + n_ * 2.0 ** -52 * abs_total,
              f"{what}: {got!r} against {total!r}")
    elif name == "rolling max":
        check(float(got) == want, f"{what}: {got!r} against {want!r}")
    elif name in ("u sum", "u isin"):
        check(int(got) == want, f"{what}: {got!r} against {want!r}")
    elif name in ("u minmax", "u max by id4"):
        check([int(v) for v in np.asarray(got).ravel()] == list(want), f"{what}: exact")
    elif name == "u groupby count":
        keys, counts = want
        check([int(v) for v in got["keys"]] == keys, f"{what}: keys")
        check(np.array_equal(got["values"], host(counts)), f"{what}: counts")
    elif name == "stat mean/std by id4":
        n_, s, a, s2 = (host(t) for t in want)
        for g, ni, si, ai, s2i in zip(np.asarray(got), n_, s, a, s2):
            mean, mean_error = si / ni, _mean_error(ni, si, ai)
            var, var_bound = _std_error(ni, si, ai, s2i)
            std = math.sqrt(var)
            std_error = var_bound / std
            bound = (mean_error / (std - std_error) + abs(mean) * std_error
                     / (std * (std - std_error)) + 4 * 2.0 ** -52 * abs(mean / std))
            check(abs(g - mean / std) <= bound, f"{what}: {g!r} against {mean / std!r}")
    else:
        raise KeyError(name)


def phase20_drive(vt, df, cols, k6=PHASE20_K6, expect_routes=True):
    """Each query of phase 20 once through the public API, checked against
    its plain computation; on the card each route named in PHASE20_EXPECT
    (and B6's probe where a set is probed) asserted from trace_log.
    Returns {query: (strategies of the last pass, its probe route, passes)}."""
    routes = {}
    for name, query in phase20_queries(vt).items():
        passes = df.executor.passes
        out = query(df)
        log = df.executor.trace_log[-1]
        routes[name] = (log["strategies"], log["probe"], df.executor.passes - passes)
        phase20_check(name, phase20_answer(name, out), phase20_plain(cols, name, k6))
        if expect_routes:
            strategies = log["strategies"][0] if log["strategies"] else {}
            for kind, route in PHASE20_EXPECT.get(name, {}).items():
                check(strategies.get(kind) == route,
                      f"phase 20 {name}: {kind} took {strategies.get(kind)!r}, not {route!r}")
            if name in PHASE20_PROBES:
                check(log["probe"] == PHASE20_PROBES[name],
                      f"phase 20 {name}: probe {log['probe']!r}, not {PHASE20_PROBES[name]!r}")
        if name.startswith("stat"):
            check(routes[name][2] == 1 and {"additive", "moments"} <= set(log["strategies"][0]),
                  f"phase 20 {name}: one pass of sums and moments, {routes[name]}")
        print(f"phase 20 {name}: {routes[name][2]} passes, strategies {log['strategies']}, "
              f"probe {log['probe']}; checked against plain torch", flush=True)
    return routes


def phase20_on_the_card(df):
    """shift and rolling leave their views over CUDA tensors: no column of
    theirs crosses to the host."""
    from vaex_tpu_torch.shift import ColumnShifted
    shifted = df.shift(1, "v3").dataset["v3"]
    check(isinstance(shifted, ColumnShifted) and shifted.device.type == "cuda"
          and shifted.source.is_cuda, "phase 20: a shifted column is a view over a CUDA tensor")
    rolled = df.rolling(5, column="v3").sum()
    for k in range(5):
        col = rolled.dataset[f"__v3_shift_{k}"]
        source = col.source if isinstance(col, ColumnShifted) else col
        check(isinstance(source, torch.Tensor) and source.is_cuda,
              f"phase 20: rolling's column {k} lies on the card")
    diffed = df.diff(1, "v3")
    check(diffed.dataset["__v3_original"] is df.dataset["v3"],
          "phase 20: diff keeps its source as it is (no copy)")


def phase20_path(vt, plan, gp, probe, label, n=PHASE20_ROWS):
    """Phase 20 on the card: every query once with the kernel counts set to
    0 (B2, b3, b3-l2, B4 and B6 asserted launched), the views' device
    asserted, then each query timed (5 repetitions, medians) beside its
    plain computation, with its peak memory above the table.  Returns
    (launches, the phase's JSON record)."""
    cols = phase20_columns(n, "cuda")
    df = phase20_frame(vt, cols)
    torch.cuda.synchronize()
    zero_launches(plan, gp)
    probe.probe.launches = probe.probe.wide_launches = 0
    routes = phase20_drive(vt, df, cols)
    launches = {**launch_counts(plan, gp), "b6": probe.probe.launches,
                "b6-wide": probe.probe.wide_launches}
    print(f"launches during phase 20: {launches}", flush=True)
    for name in (plan.B2, plan.B3, plan.B3_L2, plan.B4, "b6"):
        check(launches[name] > 0, f"{name} was not launched during phase 20: {launches}")
    phase20_on_the_card(df)
    record = {"card": label, "rows": n, "queries": {}}
    for name, query in phase20_queries(vt).items():
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        query(df)
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        port_s, _ = median_s(lambda: query(df))
        plain_s, _ = median_s(lambda: phase20_plain(cols, name))
        strategies, probe_route, passes = routes[name]
        record["queries"][name] = {"ms": port_s * 1e3, "plain_ms": plain_s * 1e3,
                                   "strategies": strategies, "probe": probe_route,
                                   "passes": passes, "peak_gb": peak_gb}
        print(f"[{label}] phase 20 {name} N={n}: median {port_s * 1e3!r} ms (port, {passes} "
              f"passes, {strategies}, probe {probe_route}; {peak_gb!r} GB above the table at "
              f"its peak) vs {plain_s * 1e3!r} ms (plain torch), reps {REPS}", flush=True)
    del df, cols
    torch.cuda.empty_cache()
    return launches, record

# phase 21: the host scope.  BASELINE config 3 on H2O's own string keys
# (benchmarks/fixtures.py:28-40 with H2O's formats), benchmarks/strings.py's
# cases (:53-61) and datetimes through the host stage
PHASE21_ROWS = 100_000_000
# the unstaged string path and the datetimes: each query hashes every string
# (or converts every datetime) on the host, so they run at 1e7 rows
PHASE21_HOST_ROWS = 10_000_000
PHASE21_K = 100
PHASE21_QUESTIONS = ("q1", "q2", "q3", "q10")
# the route each question's pass takes, and the kernel that must launch in it
PHASE21_ROUTES = {"q1": ("b1", ("b1",)), "q2": ("b2", ("b2",)), "q3": ("b3", ("b3", "b3-l2"))}


def phase21_strings(codes, labels):
    """Plain strings made from drawn codes and their labels without a Python
    loop over the rows: a dictionary array decoded."""
    import pyarrow as pa
    return pa.DictionaryArray.from_arrays(pa.array(codes.astype(np.int32)),
                                          pa.array(labels)).dictionary_decode()


def phase21_columns(n, seed=SEED):
    """H2O's groupby table (benchmarks/fixtures.py:28-40) drawn on the host
    from ``seed`` with H2O's key formats: id1, id2 "id%03d" of 1..100, id3
    "id%010d" of 1..n/100 (plain string columns), id4, id5 int64 in 1..100,
    id6 in 1..n/100, v1 in 1..5, v2 in 1..15, v3 U[0, 100).  Returns (the
    frame's host columns, the drawn codes of the string keys, their
    labels)."""
    rng = np.random.default_rng(seed)
    k3 = config3_span("id3", n)
    labels = {"id1": [f"id{i:03d}" for i in range(1, PHASE21_K + 1)],
              "id3": [f"id{i:010d}" for i in range(1, k3 + 1)]}
    labels["id2"] = labels["id1"]
    codes = {"id1": rng.integers(0, PHASE21_K, n), "id2": rng.integers(0, PHASE21_K, n),
             "id3": rng.integers(0, k3, n)}
    host = {key: phase21_strings(codes[key], labels[key]) for key in ("id1", "id2", "id3")}
    for key, high in (("id4", PHASE21_K), ("id5", PHASE21_K), ("id6", k3), ("v1", 5),
                      ("v2", 15)):
        host[key] = rng.integers(1, high + 1, n).astype(np.int64)
    host["v3"] = rng.random(n) * 100
    return host, codes, labels


def phase21_plain_columns(host, codes, device):
    """The plain side's columns on ``device``: each string key as its drawn
    code + 1 (phase 17's int keys), the rest as they are."""
    cols = {key: torch.as_tensor(codes[key] + 1, device=device) if key in codes
            else torch.as_tensor(host[key], device=device) for key in host}
    return cols


def phase21_label_codes(col, labels, device):
    """A dictionary column's rows as the drawn code of their label (-1 for a
    label not among ``labels``): each label looked up once on the host, then
    gathered by code on ``device``."""
    import pyarrow as pa
    import pyarrow.compute as pc
    table = pc.index_in(col.labels, value_set=pa.array(labels)).fill_null(-1)
    table = torch.as_tensor(np.asarray(table).astype(np.int64), device=device)
    return table.index_select(0, col.codes.to(device=device, dtype=torch.int64))


def phase21_as_ints(vt, out, labels, device):
    """A result over string keys as phase 17's over int keys: each string key
    column (asserted a dictionary column whose codes lie on ``device``) as
    its drawn code + 1, the rows in ascending order of the keys, as the
    plain answers hold them."""
    from vaex_tpu_torch.column import ColumnDictionary
    cols = {}
    for name in out.get_column_names():
        col = out.dataset[name]
        if name in labels:
            check(isinstance(col, ColumnDictionary) and col.codes.device.type
                  == torch.device(device).type,
                  f"phase 21: key {name} comes back as a dictionary column on {device}")
            cols[name] = phase21_label_codes(col, labels[name], device) + 1
        else:
            cols[name] = _column(out, name, device)
    keys = torch.stack([cols[k] for k in CONFIG3_KEYS if k in cols], dim=1)
    _, inverse = torch.unique(keys, dim=0, return_inverse=True)
    order = torch.empty_like(inverse)
    order[inverse] = torch.arange(inverse.numel(), device=inverse.device)
    return vt.from_dict({name: value[order] for name, value in cols.items()})


def phase21_h2o(vt, df, plain_cols, labels, n, device, plan=None, expect_routes=True):
    """q1, q2, q3 and q10 on string keys, each once through the public API
    and checked against plain torch over the codes; with ``expect_routes``
    (the full size) the route of q1-q3 from trace_log and, given ``plan``,
    the launch of its kernel during it; q10 asserted on the one-sort route.
    Returns each question's route."""
    questions = config3_questions(vt)
    plain = config3_plain(plain_cols, n)
    routes = {}
    for q in PHASE21_QUESTIONS:
        before = {name: k.launches for name, k in plan.KERNELS.items()} if plan else None
        out = questions[q](df)
        entry = df.executor.trace_log[-1]
        routes[q] = ({k: entry[k] for k in ("groupby", "mode", "words", "groups")}
                     if "groupby" in entry else entry["strategies"])
        if q in PHASE21_ROUTES and expect_routes:
            route, kernels = PHASE21_ROUTES[q]
            got = entry["strategies"][0].get("additive", "")
            check(got.startswith(route), f"phase 21 {q}: additive route {got!r}, not {route}")
            if plan:
                launched = [name for name in kernels
                            if plan.KERNELS[name].launches > before[name]]
                check(launched, f"phase 21 {q}: {kernels} not launched")
        elif q not in PHASE21_ROUTES:
            check(routes[q].get("groupby") == "one-sort", f"phase 21 {q}: {routes[q]}")
        config3_check(f"phase 21 {q}", phase21_as_ints(vt, out, labels, device), plain[q](),
                      device)
        print(f"phase 21 {q} N={n}: {len(out)} groups, route {routes[q]}; checked against "
              f"plain torch over the codes", flush=True)
    return routes


def phase21_strings_columns(n, k=PHASE21_K, seed=SEED):
    """benchmarks/strings.py's frame: s the labels "id%07d" of k codes drawn
    from ``seed``, x U[0, 1); returns (host columns, codes, labels)."""
    rng = np.random.default_rng(seed)
    labels = [f"id{i:07d}" for i in range(k)]
    codes = rng.integers(0, k, n)
    return {"s": phase21_strings(codes, labels), "x": rng.random(n)}, codes, labels


def phase21_isin_values(labels):
    """The isin labels of benchmarks/strings.py: every second one, at most 500."""
    return labels[0::2][:500]


def phase21_string_queries(labels):
    """benchmarks/strings.py:53-61's cases."""
    values = phase21_isin_values(labels)
    return {
        "groupby_str_sum": lambda df: df.groupby("s", agg={"x": "sum"}),
        "value_counts_str": lambda df: df["s"].value_counts(),
        "unique_str": lambda df: df.unique("s"),
        "isin_str_500": lambda df: df[df["s"].isin(values)].count("*"),
        "str_upper": lambda df: df["s"].str.upper().evaluate(),
        "str_contains": lambda df: df["s"].str.contains("3", regex=False).evaluate(),
        "str_len_sum": lambda df: df["s"].str.len().sum(),
    }


def phase21_string_plain(codes, x, labels, name):
    """A case answered over the codes (a tensor) in plain torch, a per-label
    result computed in Python over the labels and gathered by code."""
    k = len(labels)
    device = codes.device
    if name == "groupby_str_sum":
        counts = torch.bincount(codes, minlength=k)
        sums = torch.zeros(k, dtype=torch.float64, device=device).index_add_(0, codes, x)
        return counts, sums
    if name in ("value_counts_str", "unique_str"):
        return torch.bincount(codes, minlength=k)
    if name == "isin_str_500":
        member = torch.zeros(k, dtype=torch.bool, device=device)
        member[0::2] = True
        return int(member[codes].sum())
    if name == "str_upper":
        import pyarrow as pa
        return pa.DictionaryArray.from_arrays(pa.array(codes.cpu().numpy().astype(np.int32)),
                                              pa.array([v.upper() for v in labels]))
    if name == "str_contains":
        table = torch.tensor(["3" in v for v in labels], device=device)
        return table[codes]
    table = torch.tensor([len(v) for v in labels], device=device)  # str_len_sum
    return int(table[codes].sum())


def phase21_string_check(name, got, want, codes, labels, device):
    """A case's answer against its plain one: counts, labels and ints
    exact, float sums within :func:`within_sum_bound`."""
    import pyarrow as pa
    import pyarrow.compute as pc
    what = f"phase 21 {name}"
    if name == "groupby_str_sum":
        counts, sums = want
        at = phase21_label_codes(got.dataset["s"], labels, device)
        check(bool((at >= 0).all()) and at.numel() == int((counts > 0).sum()), f"{what} keys")
        x = _column(got, "x", device).to(torch.float64)
        want_x = sums.index_select(0, at)
        check(within_sum_bound(x, want_x, want_x.abs(), counts.index_select(0, at)), what)
    elif name == "value_counts_str":
        at = np.asarray(pc.index_in(pa.array(list(got.index)), value_set=pa.array(labels))
                        .fill_null(-1))
        check(bool((at >= 0).all()), f"{what} labels")
        check(np.array_equal(got.to_numpy(), want.cpu().numpy()[at])
              and len(at) == int((want > 0).sum()), what)
    elif name == "unique_str":
        present = [labels[i] for i in torch.nonzero(want).squeeze(1).tolist()]
        check(sorted(got) == sorted(present) and len(got) == len(present), what)
    elif name in ("isin_str_500", "str_len_sum"):
        check(int(got) == want, f"{what}: {got} against {want}")
    elif name == "str_upper":
        check(len(got) == len(want), f"{what} length")
        if hasattr(got, "dictionary"):
            got = got.dictionary.take(got.indices)
        same = pc.equal(got, want.dictionary.take(want.indices))
        check(pc.all(same).as_py() and got.null_count == 0, what)
    else:  # str_contains
        got = np.asarray(got)
        check(got.dtype == np.bool_ and np.array_equal(got, want.cpu().numpy()), what)


def phase21_string_cases(vt, df, codes, x, labels, device, names=None, plan=None):
    """The cases (``names``, or all) once through the public API on ``df``,
    each checked against plain torch over the codes; returns each case's
    last pass's host-stage expressions."""
    stages = {}
    for name, query in phase21_string_queries(labels).items():
        if names is not None and name not in names:
            continue
        passes = df.executor.passes
        got = query(df)
        # an evaluate of a host-stage expression reads the host and runs no pass
        stages[name] = (df.executor.trace_log[-1]["host_stage"]
                        if df.executor.passes > passes else "evaluated on the host")
        phase21_string_check(name, got, phase21_string_plain(codes, x, labels, name), codes,
                             labels, device)
        print(f"phase 21 {name} N={len(codes)}: host stage {stages[name]}; checked against "
              f"plain torch over the codes", flush=True)
    return stages


def phase21_datetimes(n, seed=SEED):
    """t datetime64[ns] uniform over 2021 with 1% NaT, v3 U[0, 100)."""
    rng = np.random.default_rng(seed)
    year = np.int64(365 * 24 * 3600) * 10 ** 9
    t = (np.datetime64("2021-01-01", "ns") + rng.integers(0, year, n).astype("m8[ns]"))
    t[rng.random(n) < 0.01] = np.datetime64("NaT")
    return {"t": t, "v3": rng.random(n) * 100}


def phase21_datetime_queries(vt):
    return {
        "groupby_hour_mean": lambda df: df.groupby(df.t.dt.hour, agg={"v3": "mean"}),
        "year_value_counts": lambda df: df.t.dt.year.value_counts(),
        "days_since_min_sum": lambda df: (df.t - df.t.min()).td.days.sum(),
        "min_astype_day": lambda df: df.min("astype(t, 'datetime64[D]')"),
    }


def phase21_datetime_plain(t, v3, name):
    """A datetime query in plain torch over the int64 nanoseconds (NaT the
    int64 minimum)."""
    nat = t == np.iinfo(np.int64).min
    ok = ~nat
    if name == "groupby_hour_mean":
        hour = torch.div(t, 3600 * 10 ** 9, rounding_mode="floor") % 24
        hour = hour.masked_fill(nat, 24)  # the NaN hour, last
        counts = torch.bincount(hour, minlength=25)
        sums = torch.zeros(25, dtype=torch.float64, device=t.device).index_add_(0, hour, v3)
        return counts, sums
    if name == "year_value_counts":
        return int(ok.sum()), int(nat.sum())
    if name == "days_since_min_sum":
        tmin = t[ok].min()
        return int(torch.div(t[ok] - tmin, 86400 * 10 ** 9, rounding_mode="floor").sum())
    day = torch.div(t[ok], 86400 * 10 ** 9, rounding_mode="floor").min()  # min_astype_day
    return np.datetime64(int(day), "D")


def phase21_datetime_check(name, got, want):
    what = f"phase 21 {name}"
    if name == "groupby_hour_mean":
        counts, sums = want
        hours = np.asarray(got.evaluate(got.get_column_names()[0]))
        check(np.array_equal(hours[:24], np.arange(24)) and np.isnan(hours[24]), f"{what} keys")
        mean = torch.as_tensor(np.asarray(got.evaluate("v3")), dtype=torch.float64)
        want_mean = (sums / counts).cpu()
        check(within_sum_bound(mean, want_mean, want_mean, counts.cpu()), what)
    elif name == "year_value_counts":
        valid, nat = want
        index = list(got.index)
        check(index[0] == 2021 and np.isnan(index[1]) and list(got.to_numpy()) == [valid, nat],
              f"{what}: {got.to_dict()}")
    else:
        check(got == want, f"{what}: {got!r} against {want!r}")


def phase21_datetime_cases(vt, df, t, v3):
    stages = {}
    for name, query in phase21_datetime_queries(vt).items():
        got = query(df)
        stages[name] = df.executor.trace_log[-1].get("host_stage")
        check(stages[name], f"phase 21 {name}: no host stage in its last pass")
        phase21_datetime_check(name, got, phase21_datetime_plain(t, v3, name))
        print(f"phase 21 {name} N={len(t)}: host stage {stages[name]}; checked against plain "
              f"torch", flush=True)
    return stages


def phase21_time(record, name, query, plain, df, rows):
    """One query's median (host clock to a synchronize, 5 repetitions)
    beside its plain version's, with its host-stage time per tile and its
    peak memory above the table."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    query(df)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    log = df.executor.trace_log[-1] if df.executor.trace_log else {}
    port_s, _ = median_s(lambda: query(df))
    plain_s, _ = median_s(plain)
    host_ms = log.get("host_s", 0.0) * 1e3 / max(log.get("tiles", 1), 1)
    record[name] = {"rows": rows, "ms": port_s * 1e3, "plain_ms": plain_s * 1e3,
                    "host_stage_ms_per_tile": host_ms, "peak_gb": peak_gb}
    print(f"phase 21 {name} N={rows}: median {port_s * 1e3!r} ms (port; host stage "
          f"{host_ms!r} ms a tile, {peak_gb!r} GB above the table at its peak) vs "
          f"{plain_s * 1e3!r} ms (plain torch), reps {REPS}", flush=True)


def phase21_path(vt, plan, gp, probe, label, config3_times, n=PHASE21_ROWS,
                 n_host=PHASE21_HOST_ROWS):
    """Phase 21 on the card: (a) H2O q1-q3 and q10 on string keys at ``n``
    rows, (b) benchmarks/strings.py's cases on the staged frame at ``n``
    rows and two of them on the unstaged frame at ``n_host``, (c) the
    datetime queries at ``n_host``; each driven once with the kernel counts
    set to 0 and checked, B1, B2 and B3 asserted launched, then each timed
    beside its plain version.  Returns (launches, the phase's JSON record)."""
    record = {"card": label, "rows": n, "host_rows": n_host, "queries": {}}
    host, codes, labels = phase21_columns(n)
    frame = vt.from_arrays(**host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df = frame.to_device("cuda")
    torch.cuda.synchronize()
    record["ingest_s"] = time.perf_counter() - t0
    print(f"[{label}] phase 21 ingest (to_device, three string columns dictionary-encoded) "
          f"N={n}: {record['ingest_s']!r} s", flush=True)
    plain_cols = phase21_plain_columns(host, codes, "cuda")
    del frame
    zero_launches(plan, gp)
    probe.probe.launches = probe.probe.wide_launches = 0
    routes = phase21_h2o(vt, df, plain_cols, labels, n, "cuda", plan)
    s_host, s_codes, s_labels = phase21_strings_columns(n)
    s_df = vt.from_arrays(**s_host).to_device("cuda")
    s_codes_t = torch.as_tensor(s_codes, device="cuda")
    s_x = torch.as_tensor(s_host["x"], device="cuda")
    stages = phase21_string_cases(vt, s_df, s_codes_t, s_x, s_labels, "cuda")
    h_host, h_codes, h_labels = phase21_strings_columns(n_host)
    h_df = vt.from_arrays(**h_host)  # unstaged: the set grouper and the host stage
    h_codes_t = torch.as_tensor(h_codes, device="cuda")
    h_x = torch.as_tensor(h_host["x"], device="cuda")
    host_names = ("groupby_str_sum", "isin_str_500")
    stages.update({f"{k} (unstaged)": v for k, v in phase21_string_cases(
        vt, h_df, h_codes_t, h_x, h_labels, "cuda", host_names).items()})
    d_host = phase21_datetimes(n_host)
    d_df = vt.from_arrays(**d_host).to_device("cuda")
    d_t = torch.as_tensor(d_host["t"].view(np.int64), device="cuda")
    d_v3 = torch.as_tensor(d_host["v3"], device="cuda")
    stages.update(phase21_datetime_cases(vt, d_df, d_t, d_v3))
    launches = {**launch_counts(plan, gp), "b6": probe.probe.launches,
                "b6-wide": probe.probe.wide_launches}
    print(f"launches during phase 21: {launches}", flush=True)
    for name in (plan.B1, plan.B2):
        check(launches[name] > 0, f"{name} was not launched during phase 21: {launches}")
    check(launches[plan.B3] + launches[plan.B3_L2] > 0,
          f"B3 was not launched during phase 21: {launches}")
    record["routes"], record["host_stage"] = routes, stages
    questions = config3_questions(vt)
    plain = config3_plain(plain_cols, n)
    for q in PHASE21_QUESTIONS:
        phase21_time(record["queries"], q, questions[q], plain[q], df, n)
        if q in config3_times:
            record["queries"][q]["phase17_int_keys_ms"] = config3_times[q][0] * 1e3
            record["queries"][q]["ratio_to_int_keys"] = (
                record["queries"][q]["ms"] / (config3_times[q][0] * 1e3))
    del df, plain_cols
    for name, query in phase21_string_queries(s_labels).items():
        phase21_time(record["queries"], name, query,
                     lambda name=name: phase21_string_plain(s_codes_t, s_x, s_labels, name),
                     s_df, n)
    for name in host_names:
        phase21_time(record["queries"], f"{name} (unstaged)",
                     phase21_string_queries(h_labels)[name],
                     lambda name=name: phase21_string_plain(h_codes_t, h_x, h_labels, name),
                     h_df, n_host)
    for name, query in phase21_datetime_queries(vt).items():
        phase21_time(record["queries"], name, query,
                     lambda name=name: phase21_datetime_plain(d_t, d_v3, name), d_df, n_host)
    del s_df, h_df, d_df
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record


# phase 22: the executor's tail (ROADMAP A10) and uint64 inside expressions
# (A14): a state written and loaded onto config 2's frame, the result cache
# on the 1e6-key set grouper and q10's one sort, progress and cancelling,
# Python UDFs, pickling, and phase 20's uint64 column in expressions
PHASE22_ROWS = 100_000_000
# the UDF and pickling rows: cut from 1e8, since every row crosses to the
# host and back (a UDF runs in the host stage, a pickle holds host arrays)
PHASE22_HOST_ROWS = 10_000_000
PHASE22_TILE_ROWS = 1 << 24  # the progress table's tiles: 6 at 1e8 rows
PHASE22_CANCEL_AFTER = 2  # tiles before the callback cancels
PHASE22_UDF_K = 100
PHASE22_A14 = ("u // 3 sum", "u % 7 groupby", "u & 0xFFFF sum", "u >> 60 sum", "u + k sum",
               "sqrt(u) mean")


def phase22_udf(x, k):
    """Phase 22's Python UDF: numpy, module-level, so that the processes of
    ``multiprocessing=True`` unpickle it."""
    return np.sqrt(np.abs(x)) * 2.0 + k


def phase22_udf_torch(x, k):
    """The same function in torch, on the card."""
    return torch.sqrt(torch.abs(x)) * 2.0 + k


def phase22_tile_sum(x):
    """map_reduce's map: one tile's (sum, count) of x."""
    return float(np.sum(x)), len(x)


def phase22_add(a, b):
    return a[0] + b[0], a[1] + b[1]


def phase22_state_stats(df):
    """Config 2's group (phase 16) and the selection's count by the
    categorized key i."""
    out = config2_group(df)
    out["count i"] = np.asarray(df.count(binby="i", selection=True))
    return out


def phase22_state(vt, df, cols, path):
    """Config 2's frame, with i categorized, written to ``path``
    (``state_write``) and loaded onto a fresh frame over the same tensors
    (``state_load``): (the original's statistics, the fresh frame's)."""
    want = phase22_state_stats(df)
    df.state_write(path)
    fresh = vt.from_dataset(vt.DatasetArrays(dict(cols)))
    fresh.state_load(path)
    return phase22_state_stats(fresh), want


def phase22_state_check(got, want):
    """Every statistic of the loaded frame bit for bit the original's: the
    same kernels over the same rows in the same order."""
    for name, value in want.items():
        check(np.asarray(got[name]).tobytes() == np.asarray(value).tobytes(),
              f"phase 22 state {name}: {np.asarray(got[name]).tolist()} against "
              f"{np.asarray(value).tolist()}")


def phase22_twice(df, query, kind, cache_on=True):
    """``query`` twice, under ``cache.memory()`` (or ``cache.off()``):
    (both results, how many passes of each run did ``kind``: "set-create"
    a set build, "one-sort" the one sort)."""
    from vaex_tpu_torch import cache
    results, builds = [], []
    with (cache.memory() if cache_on else cache.off()):
        for _ in range(2):
            p0 = df.executor.passes
            results.append(query(df))
            added = df.executor.passes - p0
            log = df.executor.trace_log[-added:] if added else []
            builds.append(sum(1 for e in log
                              if kind in e.get("tasks", ()) or e.get("groupby") == kind))
    return results, builds


def phase22_same_frames(a, b):
    """Two result frames alike bit for bit: names, and each column's bytes."""
    names = a.get_column_names()
    return names == b.get_column_names() and all(
        np.asarray(a.evaluate(n)).tobytes() == np.asarray(b.evaluate(n)).tobytes()
        for n in names)


def phase22_cache_check(name, results, builds, want_builds, plain_check):
    """The cache served the second run (its build did not run) or, off, did
    not; both runs agree bit for bit and each passes its plain check."""
    check(builds == want_builds, f"phase 22 cache {name}: builds {builds} against {want_builds}")
    check(phase22_same_frames(*results), f"phase 22 cache {name}: the two runs differ")
    for out in results:
        plain_check(out)


def phase22_progress(vt, df, cancel_after=PHASE22_CANCEL_AFTER, b1=None):
    """Config 1's groupby (phase 6) with a progress callback, then with one
    that returns False after ``cancel_after`` tiles, then once more: a dict
    of the fractions seen, the first result, the cancelled run's exception
    and callback calls, B1's launches in it (``b1``: the kernel, or None
    off the card), the tiles of a pass, and the next result."""
    from vaex_tpu_torch.execution import UserAbort
    seen, calls = [], []
    signal = df.executor.signal_progress
    cb = signal.connect(lambda p: seen.append(p) or True)
    try:
        first = run_query(df, vt)
    finally:
        signal.disconnect(cb)
    tiles = df.executor.trace_log[-1]["tiles"]
    before = None if b1 is None else b1.launches
    cb = signal.connect(lambda p: calls.append(p) or len(calls) < cancel_after)
    aborted = None
    try:
        run_query(df, vt)
    except UserAbort as e:
        aborted = e
    finally:
        signal.disconnect(cb)
    launched = None if b1 is None else b1.launches - before
    return {"fractions": seen, "first": first, "aborted": aborted, "calls": len(calls),
            "launched": launched, "tiles": tiles, "after": run_query(df, vt)}


def phase22_progress_check(got, plain_ok, cancel_after=PHASE22_CANCEL_AFTER):
    """Fractions strictly increasing, one a tile, ending at 1.0; the
    cancelled pass rejected with UserAbort after ``cancel_after`` tiles (B1
    launched once a tile that ran, where counted); both results right."""
    f = got["fractions"]
    check(len(f) == got["tiles"] and f[-1] == 1.0 and all(a < b for a, b in zip(f, f[1:])),
          f"phase 22 progress fractions {f}")
    check(type(got["aborted"]).__name__ == "UserAbort" and got["calls"] == cancel_after
          and cancel_after < got["tiles"],
          f"phase 22 cancelled pass: {got['aborted']!r} after {got['calls']} tiles")
    check(got["launched"] is None or got["launched"] == got["calls"],
          f"phase 22 cancelled pass launched B1 {got['launched']} times in {got['calls']} tiles")
    plain_ok(got["first"])
    plain_ok(got["after"])


def phase22_udf_columns(n, device, seed=SEED):
    """x float64 N(0, 1), k int64 in 0..99, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"x": torch.randn(n, generator=gen, device=device, dtype=torch.float64),
            "k": torch.randint(0, PHASE22_UDF_K, (n,), generator=gen, device=device,
                               dtype=torch.int64)}


def phase22_udf_frame(vt, cols, multiprocessing=False):
    df = vt.from_dataset(vt.DatasetArrays(dict(cols)))
    df["y"] = df.apply(phase22_udf, ["x", "k"], multiprocessing=multiprocessing)
    return df


def phase22_udf_query(df):
    return df.groupby("k", agg={"y": ["sum", "std"]}, sort=True)


def phase22_udf_answer(out):
    return {name: np.asarray(out.evaluate(name)) for name in ("k", "y_sum", "y_std")}


def phase22_udf_plain(cols):
    """The UDF in torch on the same tensors, per k: keys, counts, sums and
    sums of |y| and y^2."""
    x, k = cols["x"], cols["k"]
    y = phase22_udf_torch(x, k)
    f64 = torch.float64

    def per_k(v):
        return torch.zeros(PHASE22_UDF_K, dtype=f64, device=k.device).index_add_(0, k, v)
    counts = torch.bincount(k, minlength=PHASE22_UDF_K)
    keep = counts > 0
    return {"k": torch.arange(PHASE22_UDF_K)[keep.cpu()].numpy(), "n": counts[keep].cpu(),
            "sum": per_k(y)[keep].cpu(), "abs1": per_k(y.abs())[keep].cpu(),
            "abs2": per_k(y * y)[keep].cpu()}


def phase22_udf_check(got, want):
    """Keys exact; sums within :func:`within_sum_bound`; stds within that
    bound carried through var = E[y^2] - E[y]^2, as config 2's."""
    f64 = torch.float64
    check(np.array_equal(got["k"], want["k"]), f"phase 22 udf keys {got['k'].tolist()}")
    n, s1, s2 = want["n"], want["abs1"], want["abs2"]
    check(within_sum_bound(torch.as_tensor(got["y_sum"], dtype=f64), want["sum"], s1, n),
          "phase 22 udf sums")
    nf = n.to(f64)
    mean = want["sum"] / nf
    std_want = torch.sqrt(torch.clamp(s2 / nf - mean ** 2, min=0))
    std_got = torch.as_tensor(got["y_std"], dtype=f64)
    e1, e2 = 2.0 ** -52 * s1, 2.0 ** -52 * s2
    bound = RTOL * std_want + ATOL + (e2 + 2 * mean.abs() * e1 + e1 ** 2) / (std_got + std_want)
    check(bool(((std_got - std_want).abs() <= bound).all()), "phase 22 udf stds")


def phase22_map_reduce_check(got, x):
    n = x.numel()
    check(got[1] == n and within_sum_bound(
        torch.tensor([got[0]], dtype=torch.float64), x.sum().cpu().reshape(1),
        x.abs().sum().cpu().reshape(1), torch.tensor([n])),
        f"phase 22 map_reduce {got} against {float(x.sum())}, {n}")


def phase22_pickle_frame(vt, cols, device):
    df = vt.from_dataset(vt.DatasetArrays(dict(cols))).to_device(device)
    df["z"] = df.x * 2 + df.k
    return df.filter("x > -1").categorize("k", labels=range(PHASE22_UDF_K))


def phase22_pickle_query(df):
    return df.groupby("k", agg={"z": "sum", "c": "count"}, sort=True)


def phase22_pickle(df):
    """The frame through ``pickle``: (its bytes, the frame back)."""
    import pickle
    blob = pickle.dumps(df)
    return len(blob), pickle.loads(blob)


def phase22_pickle_check(back, df, device):
    check(all(back.dataset[n].device.type == torch.device(device).type for n in ("x", "k"))
          and back.filter_expression == df.filter_expression and back.is_category("k"),
          "phase 22 pickle: the columns staged again, the filter and the category kept")
    check(phase22_same_frames(phase22_pickle_query(back), phase22_pickle_query(df)),
          "phase 22 pickle: the groupby of the frame back equals the original's")


def phase22_a14_frame(vt, cols):
    df = phase20_frame(vt, cols)
    df["k"] = "id4 - 50"  # a signed key
    df["m7"] = "u % 7"
    return df


def phase22_a14_queries():
    return {"u // 3 sum": lambda df: df.sum("u // 3"),
            "u % 7 groupby": lambda df: df.groupby("m7", agg="count", sort=True),
            "u & 0xFFFF sum": lambda df: df.sum("u & 0xFFFF"),
            "u >> 60 sum": lambda df: df.sum("u >> 60"),
            "u + k sum": lambda df: df.sum("u + k"),
            "sqrt(u) mean": lambda df: df.mean("sqrt(u)")}


def phase22_a14_answer(name, out):
    if name == "u % 7 groupby":
        return {"keys": np.asarray(out.evaluate("m7")), "counts": np.asarray(out.evaluate("count"))}
    return np.asarray(out)


def phase22_a14_plain(host, name):
    """numpy over the values copied to the host: (the answer, for a float
    its row count and sum of |term|)."""
    u, k = host["u"], host["id4"] - 50
    with np.errstate(all="ignore"):
        if name == "u % 7 groupby":
            keys, counts = np.unique(u % np.uint64(7), return_counts=True)
            return {"keys": keys, "counts": counts}
        if name == "u + k sum":
            v = u + k
            return v.sum(), len(v), np.abs(v).sum()
        if name == "sqrt(u) mean":
            v = np.sqrt(u)
            return v.mean(), len(v), v.sum() / len(v)
        v = {"u // 3 sum": u // np.uint64(3), "u & 0xFFFF sum": u & np.uint64(0xFFFF),
             "u >> 60 sum": u >> np.uint64(60)}[name]
        return v.sum(dtype=np.uint64)


def phase22_a14_check(name, got, want):
    """uint64 results exact, in uint64; float ones within the summation
    bound (a mean's over its row count)."""
    if name == "u % 7 groupby":
        check(got["keys"].dtype == np.uint64 and np.array_equal(got["keys"], want["keys"])
              and np.array_equal(got["counts"], want["counts"]), f"phase 22 {name}")
    elif isinstance(want, tuple):
        value, n, abs_sum = want
        check(within_sum_bound(torch.tensor([float(got)], dtype=torch.float64),
                               torch.tensor([float(value)], dtype=torch.float64),
                               torch.tensor([abs_sum], dtype=torch.float64),
                               torch.tensor([n])), f"phase 22 {name}: {got!r} against {value!r}")
    else:
        check(got.dtype == np.uint64 and got == want, f"phase 22 {name}: {got!r} against {want!r}")


PHASE22_HOST_QUERIES = ("udf groupby", "udf groupby (processes)", "map_reduce",
                        "pickle dumps + loads")


def phase22_queries(vt, t):
    """name -> (query, its plain version or None) over the tables ``t`` of
    phase 22: config 2's group on the loaded frame's twin (``df2``), config
    1's groupby at 2^24-row tiles (``df1``), the UDF groupby without and with
    processes and map_reduce (``dfu``, ``dfm``), the pickle round trip
    (``dfp``), the uint64 expressions (``dfa``)."""
    colsu = t["colsu"]
    queries = {
        "state config 2 group": (lambda: phase22_state_stats(t["df2"]), None),
        "progress groupby": (lambda: run_query(t["df1"], vt),
                             lambda: plain_query(t["i1"], t["x1"])),
        "udf groupby": (lambda: phase22_udf_query(t["dfu"]), lambda: phase22_udf_plain(colsu)),
        "udf groupby (processes)": (lambda: phase22_udf_query(t["dfm"]), None),
        "map_reduce": (lambda: t["dfu"].map_reduce(phase22_tile_sum, phase22_add, ["x"]),
                       lambda: (colsu["x"].sum().item(), colsu["x"].numel())),
        "pickle dumps + loads": (lambda: phase22_pickle(t["dfp"]), None)}
    for name, query in phase22_a14_queries().items():
        queries[name] = (lambda query=query: query(t["dfa"]), None)
    return queries


def phase22_time(record, name, query, plain, rows):
    """A query's median (host clock to a synchronize, 5 repetitions, the
    cache off) beside its plain version's, with its peak memory above what
    was allocated before it."""
    from vaex_tpu_torch import cache
    with cache.off():
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        query()
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        port_s, _ = median_s(query)
        plain_s = median_s(plain)[0] if plain is not None else None
    record[name] = {"rows": rows, "ms": port_s * 1e3,
                    "plain_ms": None if plain_s is None else plain_s * 1e3, "peak_gb": peak_gb}
    print(f"phase 22 {name} N={rows}: median {port_s * 1e3!r} ms (port, {peak_gb!r} GB above "
          f"the table at its peak) vs "
          f"{'none' if plain_s is None else repr(plain_s * 1e3) + ' ms'} (plain torch), "
          f"reps {REPS}", flush=True)


def phase22_path(vt, plan, gp, probe, label, n=PHASE22_ROWS, n_host=PHASE22_HOST_ROWS):
    """Phase 22 on the card, each item driven once with the kernel counts
    set to 0 and checked (B1, B4, B3 and B6 asserted launched), then timed
    with the cache off beside its plain version: (1) config 2's frame
    through state_write / state_load, (2) the 1e6-key set grouper and q10's
    one sort served from the cache, (3) progress and cancelling, (4) a
    Python UDF, with and without processes, and map_reduce, (5) pickling,
    (6) uint64 expressions.  Returns (launches, the phase's JSON record)."""
    import tempfile
    from vaex_tpu_torch import cache
    from vaex_tpu_torch import multiprocessing as port_mp
    from vaex_tpu_torch.ops import grid_additive as ga
    record = {"card": label, "rows": n, "host_rows": n_host, "queries": {}}
    zero_launches(plan, gp)
    probe.probe.launches = probe.probe.wide_launches = 0
    cache.clear()

    # (1) state
    cols2 = config2_columns(n, "cuda")
    df2 = config2_frame(vt, cols2).categorize("i", labels=range(1000))
    with tempfile.TemporaryDirectory() as tmp:
        got, want = phase22_state(vt, df2, cols2, os.path.join(tmp, "state.json"))
        record["state_bytes"] = os.path.getsize(os.path.join(tmp, "state.json"))
    phase22_state_check(got, want)
    config2_check(got, config2_plain(cols2))
    state_launches = launch_counts(plan, gp)
    check(state_launches[plan.B1] > 0 and state_launches[plan.B4] > 0,
          f"phase 22 state: B1 and B4 launched {state_launches}")
    print(f"phase 22 state N={n}: the loaded frame's statistics equal the original's bit for "
          f"bit and plain torch's; launches so far {state_launches}", flush=True)

    # (2) the cache: the 1e6-key set grouper (phase 11) and q10 (phase 17)
    h2o_df, h2o_cols = make_h2o(vt)
    sets_df, sets_cols, values = make_sets_table(vt, h2o_cols)
    del h2o_df
    set_query = sets_queries(vt, values)["set k1e6"]
    set_plain = sets_plain(sets_cols, values)["set k1e6"]

    def set_check(out):
        sets_check("set k1e6", out, set_plain())
    # a card tensor has no exact key (cache.py): the cache keeps nothing of
    # these frames, on or off, and each run builds again
    for on, want_builds in ((False, [1, 1]), (True, [1, 1])):
        results, builds = phase22_twice(sets_df, set_query, "set-create", cache_on=on)
        phase22_cache_check(f"set k1e6 ({'memory' if on else 'off'})", results, builds,
                            want_builds, set_check)
        del results
    check(probe.probe.wide_launches > 0, "phase 22: B6's b6-wide route launched")
    cols3 = config3_columns(CONFIG3_ROWS, "cuda")
    df3 = vt.from_dataset(vt.DatasetArrays(cols3))
    q10 = config3_questions(vt)["q10"]
    q10_plain = config3_plain(cols3, CONFIG3_ROWS)["q10"]

    def q10_check(out):
        config3_check("q10", out, q10_plain(), "cuda")
    for on, want_builds in ((False, [1, 1]), (True, [1, 1])):
        results, builds = phase22_twice(df3, q10, "one-sort", cache_on=on)
        phase22_cache_check(f"q10 ({'memory' if on else 'off'})", results, builds,
                            want_builds, q10_check)
        del results
    # a frame of host arrays is keyed by their bytes: its set, kept on the
    # card, serves the second run from the device LRU
    host_keys = sets_cols["k1e6"][:PHASE22_HOST_ROWS].cpu().numpy()
    host_df = vt.from_arrays(k=host_keys)
    results, builds = phase22_twice(host_df, lambda df: df.unique("k"), "set-create")
    check(builds == [1, 0] and results[0] == results[1] == sorted(np.unique(host_keys).tolist()),
          f"phase 22 cache of a host frame: builds {builds}")
    del results
    gc.collect()
    torch.cuda.synchronize()
    held, before = cache.device_backend.nbytes, torch.cuda.memory_allocated()
    freed = cache.clear()
    after = torch.cuda.memory_allocated()
    check(freed == held > 0 and before - after >= freed,
          f"phase 22 cache.clear(): {freed} bytes held, {before - after} freed on the card")
    record["cache"] = {"device_lru_bytes": held, "freed_bytes": before - after}
    for name, df_, query in (("set k1e6", sets_df, set_query), ("q10", df3, q10)):
        with cache.memory():
            query(df_)  # the miss, stored
            hit_s, _ = median_s(lambda: query(df_))
        with cache.off():
            miss_s, _ = median_s(lambda: query(df_))
        cache.clear()
        record["cache"][name] = {"repeat_ms": hit_s * 1e3, "miss_ms": miss_s * 1e3}
        print(f"[{label}] phase 22 cache {name}: repeated with the cache on {hit_s * 1e3!r} ms "
              f"(no exact key: its pass), cache off {miss_s * 1e3!r} ms, reps {REPS}",
              flush=True)
    del sets_df, sets_cols, df3, cols3, h2o_cols
    gc.collect()
    torch.cuda.empty_cache()

    # (3) progress and cancelling on config 1's table
    df1, i1, x1 = make_table(n, vt)
    df1._tile_rows = PHASE22_TILE_ROWS
    want_c, want_s = plain_query(i1, x1)

    def main_check(out):
        check(torch.equal(torch.as_tensor(out["c"].tolist()), want_c.cpu())
              and torch.allclose(torch.as_tensor(out["s"].tolist(), dtype=torch.float64),
                                 want_s.cpu(), rtol=RTOL, atol=ATOL),
              "phase 22 progress: the groupby equals plain torch")
    progress = phase22_progress(vt, df1, b1=ga.grid_additive)
    phase22_progress_check(progress, main_check)
    record["progress"] = {"fractions": progress["fractions"], "tiles": progress["tiles"],
                          "cancelled_after": progress["calls"], "b1_launches": progress["launched"]}
    print(f"phase 22 progress N={n}: fractions {progress['fractions']}, cancelled after "
          f"{progress['calls']} tiles with B1 launched {progress['launched']} times; the next "
          f"groupby is right", flush=True)
    del progress

    # (4) UDFs at n_host rows
    colsu = phase22_udf_columns(n_host, "cuda")
    dfu = phase22_udf_frame(vt, colsu)
    dfm = phase22_udf_frame(vt, colsu, multiprocessing=True)
    want = phase22_udf_plain(colsu)
    got = phase22_udf_answer(phase22_udf_query(dfu))
    log = dfu.executor.trace_log[-1]
    phase22_udf_check(got, want)
    got_mp = phase22_udf_answer(phase22_udf_query(dfm))
    check(all(got_mp[k].tobytes() == got[k].tobytes() for k in got),
          "phase 22 udf: multiprocessing=True gives the same bits")
    check(port_mp._pool._ctx.get_start_method() != "fork",
          "phase 22 udf: the pool forks no process that started CUDA")
    mr = dfu.map_reduce(phase22_tile_sum, phase22_add, ["x"])
    phase22_map_reduce_check(mr, colsu["x"])
    record["udf_host_stage_ms_per_tile"] = log["host_s"] * 1e3 / log["tiles"]
    print(f"phase 22 udf N={n_host}: groupby of a UDF column right (sums and stds within "
          f"the bound), the same bits with processes, map_reduce right; host stage "
          f"{record['udf_host_stage_ms_per_tile']!r} ms a tile", flush=True)

    # (5) pickling at n_host rows
    dfp = phase22_pickle_frame(vt, colsu, "cuda")
    record["pickle_bytes"], back = phase22_pickle(dfp)
    phase22_pickle_check(back, dfp, "cuda")
    print(f"phase 22 pickle N={n_host}: {record['pickle_bytes']} bytes; the frame back on "
          f"the card, its groupby equal bit for bit", flush=True)
    del back

    # (6) uint64 inside expressions on phase 20's u
    cols20 = phase20_columns(n, "cuda")
    dfa = phase22_a14_frame(vt, cols20)
    host = {"u": cols20["u"].cpu().numpy().view(np.uint64), "id4": cols20["id4"].cpu().numpy()}
    for name, query in phase22_a14_queries().items():
        phase22_a14_check(name, phase22_a14_answer(name, query(dfa)), phase22_a14_plain(host, name))
    print(f"phase 22 uint64 expressions N={n}: {list(phase22_a14_queries())} equal numpy's",
          flush=True)

    launches = {**launch_counts(plan, gp), "b6": probe.probe.launches,
                "b6-wide": probe.probe.wide_launches}
    print(f"launches during phase 22: {launches}", flush=True)
    for name in (plan.B1, plan.B4, "b6"):
        check(launches[name] > 0, f"{name} was not launched during phase 22: {launches}")
    check(launches[plan.B3] + launches[plan.B3_L2] > 0,
          f"B3 was not launched during phase 22: {launches}")
    tables = {"df2": df2, "df1": df1, "i1": i1, "x1": x1, "colsu": colsu, "dfu": dfu,
              "dfm": dfm, "dfp": dfp, "dfa": dfa}
    for name, (query, plain) in phase22_queries(vt, tables).items():
        phase22_time(record["queries"], name, query, plain,
                     n_host if name in PHASE22_HOST_QUERIES else n)
    port_mp.close_pool()
    del df2, cols2, df1, i1, x1, dfu, dfm, colsu, dfp, dfa, cols20, host
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record


# phase 23: files and the streamed pass (ROADMAP A11): BASELINE config 1 from
# its file through the stream of page-locked slots and a copy stream, the
# formats' round trips, and the file's cache key
PHASE23_ROWS = 400_000_000  # bench.py's N: 6.4 GB on disk
# parquet and Arrow IPC: cut from 4e8 so that the phase keeps to its time
PHASE23_FORMAT_ROWS = 100_000_000
PHASE23_TEXT_ROWS = 1_000_000  # CSV and JSON, text: cut
PHASE23_SMALL_ROWS = 100_000  # FITS and VOTable: cut
PHASE23_KEY_ROWS = 1_000_000  # the file rewritten under the cache
PHASE23_RING_TILE = 1 << 20  # 382 tiles of 4e8 rows through a ring of 3
PHASE23_CANCEL_AFTER = 5
PHASE23_ISIN = 50
PHASE23_LINK_BYTES = 256 << 20
# the wide pass: 30 float64 host columns (a describe() of a 30-column table)
# at 2^25 rows, whose ring STREAM_RING_BYTES clamps to 2^22-row tiles
PHASE23_WIDE_COLUMNS = 30
PHASE23_WIDE_ROWS = 1 << 25
PHASE23_STREAM_THREADS = ("vaex-tpu-torch-stream", "vaex-tpu-torch-io")


def phase23_values():
    """The isin count's 50 values of i1, drawn from seed 42."""
    return np.random.default_rng(SEED).choice(K, PHASE23_ISIN, replace=False).astype(np.int64)


def phase23_queries(vt, values):
    """Config 1's groupby, std of x, the 2-D count over (i1, x) and the
    isin count: B1, B4, B2 and B6 on the card."""
    return {
        "groupby": lambda df: run_query(df, vt),
        "std": lambda df: df.std("x"),
        "count2d": lambda df: df.count(binby=["i1", "x"], limits=[[0, K], [0, 1]],
                                       shape=[K, 1000]),
        "isin": lambda df: df.count(selection=df.i1.isin(values)),
    }


def phase23_answer(name, out):
    """A query's answer as CPU tensors."""
    if name == "groupby":
        return (torch.as_tensor(out["i1"].tolist()), torch.as_tensor(out["c"].tolist()),
                torch.as_tensor(out["s"].tolist(), dtype=torch.float64))
    if name == "std":
        return torch.as_tensor(float(out), dtype=torch.float64)
    return torch.as_tensor(np.asarray(out))


def phase23_check(name, got, want):
    """Keys, counts and int answers exact; B1's sums and B4's std within
    rtol 1e-9 (both add in a fixed order, PERF.md section 2)."""
    if name == "groupby":
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"phase 23 {name}: keys and counts exact")
        check(torch.allclose(got[2], want[2], rtol=RTOL, atol=ATOL),
              f"phase 23 {name}: sums within rtol {RTOL}")
    elif name == "std":
        check(abs(float(got) - float(want)) <= RTOL * abs(float(want)) + ATOL,
              f"phase 23 std: {float(got)!r} vs {float(want)!r}")
    else:
        check(torch.equal(got, want), f"phase 23 {name}: exact")


def phase23_wants(vt, staged, values):
    """Every query's answer on the staged frame."""
    return {name: phase23_answer(name, query(staged))
            for name, query in phase23_queries(vt, values).items()}


def phase23_stream(df):
    """The last pass's stream record (trace_log), checked present."""
    log = df.executor.trace_log[-1]
    check(log.get("stream") is not None, f"phase 23: the last pass did not stream: {log}")
    return log["stream"]


class phase23_counted:
    """The kernel launches of streamed passes alone: ``run(name, query,
    df)`` reads the counts just before and just after ``query(df)``, adds
    the difference to ``launches`` and fails unless the query's own kernel
    (B1 for a groupby, B4 for std, B2 for the 2-D count, B6 for the isin
    count) was launched in it.  Staged passes run outside it count nothing."""

    def __init__(self, plan, gp, probe):
        self.plan, self.gp, self.probe = plan, gp, probe
        self.own = {"groupby": plan.B1, "std": plan.B4, "count2d": plan.B2, "isin": "b6"}
        zero_launches(plan, gp)
        probe.probe.launches = probe.probe.wide_launches = 0
        self.launches = dict.fromkeys(self.counts(), 0)

    def counts(self):
        return {**launch_counts(self.plan, self.gp), "b6": self.probe.probe.launches,
                "b6-wide": self.probe.probe.wide_launches}

    def __call__(self, name, query, df):
        before = self.counts()
        out = query(df)
        after = self.counts()
        for kernel in after:
            self.launches[kernel] += after[kernel] - before[kernel]
        check(after[self.own[name]] > before[self.own[name]],
              f"phase 23 {name}: {self.own[name]} was not launched on the streamed tiles "
              f"({ {k: after[k] - before[k] for k in after} })")
        return out


def phase23_plain_run(name, query, df):
    return query(df)


def phase23_drive(vt, fdf, wants, values, narrowed=True, run=phase23_plain_run):
    """The queries streamed from the file's frame ``fdf``, each through
    ``run`` (a :class:`phase23_counted` on the card): first config 1's
    groupby, which ships i1 wide and builds its proof, then every query,
    each checked against the staged frame's answer, i1 asserted on the wire
    as int32 after the first pass (``narrowed``) and x as float64.  Returns
    each query's stream record."""
    queries = phase23_queries(vt, values)
    phase23_check("groupby", phase23_answer("groupby", run("groupby", queries["groupby"], fdf)),
                  wants["groupby"])
    first = phase23_stream(fdf)
    check(first["wire"] == {"i1": "int64", "x": "float64"},
          f"phase 23 first pass ships i1 and x wide: {first['wire']}")
    records = {"first": first}
    for name, query in queries.items():
        phase23_check(name, phase23_answer(name, run(name, query, fdf)), wants[name])
        records[name] = phase23_stream(fdf)
        wire = records[name]["wire"]
        if "i1" in wire and narrowed:
            check(wire["i1"] == "int32", f"phase 23 {name}: i1 on the wire as int32: {wire}")
        if "x" in wire:
            check(wire["x"] == "float64", f"phase 23 {name}: x on the wire as float64: {wire}")
    return records


def phase23_threads():
    """The stream's threads that are alive."""
    import threading
    return [t.name for t in threading.enumerate() if t.name.startswith(PHASE23_STREAM_THREADS)]


def phase23_ring(vt, fdf, want, tile_rows=PHASE23_RING_TILE, cancel_after=PHASE23_CANCEL_AFTER,
                 run=phase23_plain_run):
    """Config 1's groupby at ``tile_rows``-row tiles, the ring wrapping
    again and again (through ``run``): checked; then cancelled after
    ``cancel_after`` tiles (UserAbort, no stream thread left), and right
    again.  Returns (tiles, ring slots)."""
    from vaex_tpu_torch.execution import UserAbort
    df = fdf.copy()
    df._tile_rows = tile_rows
    groupby = phase23_queries(vt, None)["groupby"]
    phase23_check("groupby", phase23_answer("groupby", run("groupby", groupby, df)), want)
    log = df.executor.trace_log[-1]
    stream = phase23_stream(df)
    check(log["tiles"] == -(-len(df) // tile_rows) and log["tiles"] > 3 * stream["ring"],
          f"phase 23 ring: {log['tiles']} tiles through {stream['ring']} slots")
    calls = []
    signal = df.executor.signal_progress
    cb = signal.connect(lambda p: calls.append(p) or len(calls) < cancel_after)
    aborted = None
    try:
        run_query(df, vt)
    except UserAbort as e:
        aborted = e
    finally:
        signal.disconnect(cb)
    check(aborted is not None and len(calls) == cancel_after,
          f"phase 23 cancel: {aborted!r} after {len(calls)} tiles")
    phase23_no_threads()
    phase23_check("groupby", phase23_answer("groupby", run("groupby", groupby, df)), want)
    phase23_no_threads()
    return log["tiles"], stream["ring"]


def phase23_no_threads():
    left = phase23_threads()
    check(not left, f"phase 23: stream threads outlive the pass: {left}")


def phase23_export(df, path):
    """``df`` written to ``path`` (its extension names the format): seconds."""
    t0 = time.perf_counter()
    df.export(path)
    return time.perf_counter() - t0


def phase23_key_reads(vt, path):
    """A cached unique of i1 over the file at ``path``, twice, with
    hash_array_data counted: (the two answers, the calls, the second run's
    passes)."""
    from vaex_tpu_torch import cache, column, dataset, utils
    real, calls = utils.hash_array_data, []

    def counting(ar):
        calls.append(len(ar))
        return real(ar)
    modules = (utils, column, dataset)
    for m in modules:
        m.hash_array_data = counting
    try:
        df = vt.open(path)
        with cache.memory(clear_on_exit=True):
            first = sorted(np.asarray(df.unique("i1")).tolist())
            passes = df.executor.passes
            second = sorted(np.asarray(df.unique("i1")).tolist())
            passes = df.executor.passes - passes
    finally:
        for m in modules:
            m.hash_array_data = real
    return first, second, len(calls), passes


def phase23_key_check(first, second, calls, passes):
    check(calls == 0, f"phase 23 key: the file's column was hashed {calls} times")
    check(first == second == list(range(K)) and passes == 0,
          f"phase 23 key: the second unique a cache hit ({passes} passes) and right")


def phase23_rewrite(vt, i1, x, path):
    """The cached unique of i1 over a file, then the file rewritten under its
    name with one key changed (the same size), opened again: (the answer
    before, the answer after, the sizes)."""
    from vaex_tpu_torch import cache
    i1 = np.array(i1)
    with cache.memory(clear_on_exit=True):
        vt.from_arrays(i1=i1, x=x).export(path)
        size = os.path.getsize(path)
        before = sorted(np.asarray(vt.open(path).unique("i1")).tolist())
        i1[0] = K  # a key no row had
        vt.from_arrays(i1=i1, x=x).export(path)
        after = sorted(np.asarray(vt.open(path).unique("i1")).tolist())
    return before, after, (size, os.path.getsize(path))


def phase23_rewrite_check(before, after, sizes):
    check(sizes[0] == sizes[1], f"phase 23 rewrite: the same size {sizes}")
    check(K not in before and K in after,
          f"phase 23 rewrite: the rewritten file's unique {after[-3:]} (before {before[-3:]})")


def phase23_formats(vt, tmp, device, n_text=PHASE23_TEXT_ROWS, n_small=PHASE23_SMALL_ROWS):
    """CSV and JSON at ``n_text`` rows, FITS and VOTable at ``n_small``: each
    exported from a staged frame, opened, categorized and grouped, checked
    against the staged frame's groupby.  Returns {format: seconds of the
    round trip}."""
    out = {}
    for exts, n in ((("csv", "json"), n_text), (("fits", "vot"), n_small)):
        staged, _, _ = make_table(n, vt, device)
        want = phase23_answer("groupby", run_query(staged, vt))
        for ext in exts:
            path = os.path.join(tmp, f"phase23.{ext}")
            t0 = time.perf_counter()
            staged.export(path)
            df = vt.open(path).categorize("i1", labels=range(K))
            phase23_check("groupby", phase23_answer("groupby", run_query(df, vt)), want)
            out[ext] = time.perf_counter() - t0
            os.remove(path)
    return out


def rss_gb():
    """The process's resident set (/proc/self/status VmRSS), GB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


class peak_rss:
    """The resident set before a block and its peak within it, sampled
    every 2 ms on a thread of its own (GB): page-locked slots are resident."""

    def __enter__(self):
        import threading
        self.before = self.peak = rss_gb()
        self.stop = threading.Event()

        def sample():
            while not self.stop.wait(0.002):
                self.peak = max(self.peak, rss_gb())
        self.thread = threading.Thread(target=sample, name="phase23-rss", daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, rss_gb())


def phase23_wide_frame(vt, n=PHASE23_WIDE_ROWS, c=PHASE23_WIDE_COLUMNS):
    """A frame of ``c`` float64 host columns of ``n`` rows (one uniform array
    from seed 42 under every name: the stream copies each name), the names
    and each column's numpy sum."""
    a = np.random.default_rng(SEED).random(n)
    names = [f"c{i}" for i in range(c)]
    return vt.from_arrays(**dict.fromkeys(names, a)), names, a


def phase23_wide_pass(df, names, a, budget):
    """``df.sum(names)`` streamed with the ring's budget
    ``STREAM_RING_BYTES = budget``, under :class:`peak_rss`: every sum
    within the float64 summation bound of numpy's, the slots' bytes within
    the budget.  Returns the pass's record."""
    from vaex_tpu_torch import settings
    saved, settings.STREAM_RING_BYTES = settings.STREAM_RING_BYTES, budget
    try:
        with peak_rss() as rss:
            got = torch.as_tensor(np.asarray(df.sum(names), dtype=np.float64))
    finally:
        settings.STREAM_RING_BYTES = saved
    log = df.executor.trace_log[-1]
    stream = phase23_stream(df)
    want = torch.full_like(got, float(np.sum(a)))
    check(within_sum_bound(got, want, want.abs(), torch.full_like(got, len(a))),
          f"phase 23 wide pass: sums {got[:3].tolist()} vs numpy's {float(want[0])!r}")
    check(0 < stream["ring_bytes"] <= budget,
          f"phase 23 wide pass: the ring's {stream['ring_bytes']} B past its budget {budget}")
    return {"budget_bytes": budget, "tile_rows": log["tile_rows"], "tiles": log["tiles"],
            "ring_bytes": stream["ring_bytes"], "pinned": stream["pinned"],
            "rss_before_gb": rss.before, "rss_peak_gb": rss.peak}


def phase23_wide(vt, label):
    """The wide pass at the ring's budget and at twice it: each checked once
    under peak_rss (the first pass of a budget allocates its slots; later
    ones reuse the host allocator's cached blocks), then timed, median of 3."""
    from vaex_tpu_torch import settings
    df, names, a = phase23_wide_frame(vt)
    out = {}
    for name, budget in (("budget", settings.STREAM_RING_BYTES),
                         ("twice the budget", 2 * settings.STREAM_RING_BYTES)):
        rec = out[name] = phase23_wide_pass(df, names, a, budget)
        saved, settings.STREAM_RING_BYTES = settings.STREAM_RING_BYTES, budget
        try:
            s, _ = median_s(lambda: df.sum(names), 3)
        finally:
            settings.STREAM_RING_BYTES = saved
        stream = phase23_stream(df)
        rows = len(a)
        rec.update({"rows": rows, "columns": len(names), "ms": s * 1e3,
                    "rows_per_s": rows / s,
                    "host_copy_gb_per_s": rows * len(names) * 8 / stream["host_copy_s"] / 1e9,
                    "host_copy_ms": stream["host_copy_s"] * 1e3, "wait_ms": stream["wait_s"] * 1e3})
        print(f"[{label}] phase 23 wide pass ({len(names)} float64 columns, N={rows}) at "
              f"{name} ({budget} B): {rec['tile_rows']}-row tiles, the ring {rec['ring_bytes']} B, "
              f"resident set {rec['rss_before_gb']!r} -> peak {rec['rss_peak_gb']!r} GB; "
              f"{s * 1e3!r} ms, host copy {rec['host_copy_ms']!r} ms", flush=True)
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is not None:
        out["host_allocator"] = {k: v for k, v in stats().items() if isinstance(k, str)
                                 and "bytes" in k and k.endswith((".current", ".peak"))}
    del df, a
    gc.collect()
    return out


class phase23_synchronous:
    """PREFETCH = TRANSFER_AHEAD = 0 for a block: the synchronous copy."""

    def __enter__(self):
        from vaex_tpu_torch import settings
        self.saved = settings.PREFETCH, settings.TRANSFER_AHEAD
        settings.PREFETCH = settings.TRANSFER_AHEAD = 0

    def __exit__(self, *exc):
        from vaex_tpu_torch import settings
        settings.PREFETCH, settings.TRANSFER_AHEAD = self.saved


def phase23_link():
    """GB/s of a 256 MiB host-to-card copy from page-locked and from pageable
    memory, each the median of 5 (bench.py:122-151 for the reference)."""
    n = PHASE23_LINK_BYTES
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    out = {}
    for kind, host in (("pinned", torch.ones(n, dtype=torch.uint8, pin_memory=True)),
                       ("pageable", torch.ones(n, dtype=torch.uint8))):
        dev.copy_(host)
        s, _ = median_s(lambda: dev.copy_(host, non_blocking=True))
        out[kind] = n / s / 1e9
    return out


def phase23_time(record, name, query, fdf, staged, reps):
    """One query's median (host clock to a synchronize) streamed, with the
    synchronous copy and on the staged frame, and the stream's record."""
    stream_s, _ = median_s(lambda: query(fdf), reps)
    stream = fdf.executor.trace_log[-1]["stream"]
    with phase23_synchronous():
        sync_s, _ = median_s(lambda: query(fdf), reps)
    staged_s, _ = median_s(lambda: query(staged), reps)
    rows = len(fdf)
    record[name] = {"rows": rows, "streamed_ms": stream_s * 1e3, "sync_ms": sync_s * 1e3,
                    "staged_ms": staged_s * 1e3, "reps": reps,
                    "streamed_rows_per_s": rows / stream_s,
                    "wire_gb_per_s": stream["wire_bytes"] / stream_s / 1e9,
                    "wire": stream["wire"], "tiles": fdf.executor.trace_log[-1]["tiles"],
                    "host_copy_ms": stream["host_copy_s"] * 1e3,
                    "wait_ms": stream["wait_s"] * 1e3}
    print(f"phase 23 {name} N={rows}: streamed {stream_s * 1e3!r} ms (wire {stream['wire']}, "
          f"host copy {stream['host_copy_s'] * 1e3!r} ms, the pass waited "
          f"{stream['wait_s'] * 1e3!r} ms), synchronous {sync_s * 1e3!r} ms, staged "
          f"{staged_s * 1e3!r} ms, reps {reps}", flush=True)


def page_cache_gb():
    """The page cache's size (/proc/meminfo's Cached), GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("Cached:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def phase23_cold(vt, path, query):
    """One pass over the file after its pages were dropped from the page
    cache (its frames closed first: a page a mapping holds stays): (seconds,
    GB the page cache shrank by when they were dropped)."""
    gc.collect()
    before = page_cache_gb()
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    dropped = before - page_cache_gb()
    df = vt.open(path).categorize("i1", labels=range(K))
    s, _ = median_s(lambda: query(df), 1)
    return s, dropped


def phase23_path(vt, plan, gp, probe, label, n=PHASE23_ROWS, n_format=PHASE23_FORMAT_ROWS):
    """Phase 23 on the card (see the module's docstring): the link; the
    staged frames' answers and the files; config 1 from its file (HDF5, or
    Arrow IPC where h5py is not installed), the ring, parquet and Arrow IPC,
    each streamed query checked and counted by a :class:`phase23_counted`
    (the counts set to 0 just before the first and read just after the
    last, each query's own kernel asserted launched); the key, the text and
    small formats, the wide pass; then the timings.  Returns (the launches
    on streamed tiles, the phase's JSON record)."""
    import importlib.util
    import shutil
    import tempfile
    from vaex_tpu_torch import settings
    tmp = tempfile.mkdtemp(prefix="phase23-", dir=tempfile.gettempdir())
    record = {"card": label, "rows": n, "format_rows": n_format,
              "free_disk_gb": shutil.disk_usage(tmp).free / 1e9,
              "hdf5": "h5py" if importlib.util.find_spec("h5py") else "h5py absent",
              "tile_rows": settings.TILE_ROWS, "transfer_ahead": settings.TRANSFER_AHEAD,
              "prefetch": settings.PREFETCH, "io_threads": settings.NUM_THREADS_IO,
              "queries": {}, "formats": {}}
    t_phase = time.perf_counter()
    try:
        record["link_gb_per_s"] = phase23_link()
        print(f"[{label}] phase 23 link (256 MiB host to card, median of 5): "
              f"{record['link_gb_per_s']} GB/s", flush=True)
        # the staged frames' answers and the files first: only streamed
        # passes run between the counts set to 0 and their reading
        values = phase23_values()
        staged, i1, x = make_table(n, vt)
        wants = phase23_wants(vt, staged, values)
        fstaged, _, _ = make_table(n_format, vt)
        fwants = {k: phase23_answer(k, phase23_queries(vt, values)[k](fstaged))
                  for k in ("groupby", "std")}
        ext = "hdf5" if record["hdf5"] == "h5py" else "arrow"
        path = os.path.join(tmp, f"config1.{ext}")
        record["export_s"] = phase23_export(staged, path)
        record["file_gb"] = os.path.getsize(path) / 1e9
        fpaths = {fmt: os.path.join(tmp, f"format.{fmt}") for fmt in ("parquet", "arrow")}
        for fmt, fpath in fpaths.items():
            record["formats"][fmt] = {"export_s": phase23_export(fstaged, fpath)}

        counted = phase23_counted(plan, gp, probe)
        fdf = vt.open(path).categorize("i1", labels=range(K))
        records = phase23_drive(vt, fdf, wants, values, run=counted)
        record["wire"] = {k: v["wire"] for k, v in records.items()}
        print(f"phase 23 config 1 from {ext} N={n}: {record['file_gb']!r} GB written in "
              f"{record['export_s']!r} s; groupby, std, 2-D count and isin streamed equal the "
              f"staged frame's, each launching its kernel; wire {record['wire']}", flush=True)
        record["ring_tiles"], record["ring_slots"] = phase23_ring(vt, fdf, wants["groupby"],
                                                                  run=counted)
        print(f"phase 23 ring: {record['ring_tiles']} tiles through {record['ring_slots']} "
              f"slots right; cancelled after {PHASE23_CANCEL_AFTER} tiles with no thread left",
              flush=True)
        format_frames = {}
        for fmt, fpath in fpaths.items():
            fdf_f = vt.open(fpath).categorize("i1", labels=range(K))
            for q in ("groupby", "std"):
                phase23_check(q, phase23_answer(q, counted(q, phase23_queries(vt, values)[q],
                                                           fdf_f)), fwants[q])
                phase23_stream(fdf_f)
            format_frames[fmt] = fdf_f
        launches = counted.launches
        print(f"launches on streamed tiles during phase 23: {launches}", flush=True)
        for name in (plan.B1, plan.B2, plan.B4, "b6"):
            check(launches[name] > 0, f"{name} was not launched during phase 23: {launches}")

        phase23_key_check(*phase23_key_reads(vt, path))
        small, si1, sx = make_table(PHASE23_KEY_ROWS, vt)
        phase23_rewrite_check(*phase23_rewrite(vt, si1.cpu().numpy(), sx.cpu().numpy(),
                                               os.path.join(tmp, f"key.{ext}")))
        del small, si1, sx
        print(f"phase 23 key: a cached unique over the {n}-row file hashed no byte; a rewrite "
              f"of a {PHASE23_KEY_ROWS}-row file gave the new answer", flush=True)
        record["formats"].update({k: {"round_trip_s": v} for k, v in
                                  phase23_formats(vt, tmp, "cuda").items()})
        record["wide"] = phase23_wide(vt, label)

        for name, query in phase23_queries(vt, values).items():
            phase23_time(record["queries"], name, query, fdf, staged, 5 if name == "groupby" else 3)
        ring = fdf.copy()
        ring._tile_rows = PHASE23_RING_TILE
        phase23_time(record["queries"], "groupby at 2^20-row tiles",
                     phase23_queries(vt, values)["groupby"], ring, staged, 3)
        del ring
        for fmt, frame in format_frames.items():
            for q in ("groupby", "std"):
                phase23_time(record["formats"][fmt], q, phase23_queries(vt, values)[q], frame,
                             fstaged, 3)
        g = record["queries"]["groupby"]
        g["link_share"] = g["wire_gb_per_s"] / record["link_gb_per_s"]["pinned"]
        del fdf, format_frames
        record["cold_groupby_s"], record["cold_dropped_gb"] = phase23_cold(
            vt, path, lambda df: run_query(df, vt))
        print(f"[{label}] phase 23 config 1 groupby N={n}: streamed {g['streamed_rows_per_s']!r} "
              f"rows/s, wire {g['wire_gb_per_s']!r} GB/s = {g['link_share']!r} of the pinned "
              f"link; cold {record['cold_groupby_s']!r} s after dropping the file's pages (the "
              f"page cache shrank {record['cold_dropped_gb']!r} GB of the file's "
              f"{record['file_gb']!r}), not a check", flush=True)
        del staged, i1, x, fstaged
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    record["phase_s"] = time.perf_counter() - t_phase
    return launches, record


PHASE24_SHARDS = 4
PHASE24_ROWS = 100_000_000  # config 1 and config 3's table
PHASE24_FACT = 100_000_000  # config 4's fact table: cut from 1e9 (the buffers of slack 4)
PHASE24_DIM = 10_000_000
PHASE24_ISIN = 500
PHASE24_GLOO_ROWS = 1_000_000
# each sharded query's own kernel, one of these launched on its shard tiles
# (None: torch sorts alone, the fused exchange)
PHASE24_OWN = {"c1 groupby": ("b1",), "c1 std": ("b4",), "c1 count2d": ("b2",),
               "c1 isin": ("b6", "b6-wide"), "q2": ("b2",), "q6-sd": ("b5",),
               "q3": ("b3", "b3-l2"), "q7": ("b3x", "b3x-l2", "b3x-direct"), "q10": None,
               "q6": None, "J1": ("b6", "b6-wide"), "J3": ("b1",),
               "nccl c1 groupby": ("b1",)}
# the kernels phase 24 must launch on shard tiles, counted around the sharded
# queries alone
PHASE24_KERNELS = (("b1",), ("b2",), ("b3", "b3-l2"), ("b3x", "b3x-l2", "b3x-direct"),
                   ("b4",), ("b5",), ("b6", "b6-wide"))


def phase24_mesh(device, shards=PHASE24_SHARDS):
    from vaex_tpu_torch.parallel import data_mesh
    return data_mesh(shards, devices=[device] * shards)


def phase24_frames(vt, device, n=PHASE24_ROWS, n_fact=PHASE24_FACT, n_dim=PHASE24_DIM):
    """The single-device frames and their tensors: config 1 (i1 categorized,
    x), config 3's H2O table (raw keys) and config 4's fact and dim tables,
    made on ``device`` from seed 42."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    i1 = torch.randint(0, K, (n,), generator=gen, device=device, dtype=torch.int64)
    x = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    c1 = vt.from_dataset(vt.DatasetArrays({"i1": i1, "x": x})).categorize("i1", labels=range(K))
    h2o = config3_columns(n, device)
    c3 = vt.from_dataset(vt.DatasetArrays(dict(h2o)))
    fact, dim, _ = config4_tables(n_fact, n_dim, device)
    ids = np.arange(0, 2 * PHASE24_ISIN, 2)  # 500 ids, half of them among i1's values
    return {"c1": c1, "c3": c3, "fact": vt.from_dataset(vt.DatasetArrays(dict(fact))),
            "dim": vt.from_dataset(vt.DatasetArrays(dict(dim))), "ids": ids,
            "cols": {"i1": i1, "x": x, **h2o, "fact_x": fact["x"], "fact_key": fact["key"],
                     "label": dim["label"]}, "n": n}


def phase24_queries(vt, ids):
    """name -> (the frame it reads, the query); J3 reads J1's join."""
    a = vt.agg
    h2o = config3_questions(vt)
    return {
        "c1 groupby": ("c1", lambda df: run_query(df, vt)),
        "c1 std": ("c1", lambda df: df.std("x")),
        "c1 count2d": ("c1", lambda df: df.count(binby=["i1", "x"], limits=[None, [0, 1]],
                                                 shape=[K, 100])),
        "c1 isin": ("c1", lambda df: df.count(selection=df.i1.isin(ids))),
        "q2": ("c3", h2o["q2"]),
        "q6-sd": ("c3", lambda df: df.groupby(["id4", "id5"],
                                              agg={"sd_v3": a.std("v3", ddof=1)})),
        "q3": ("c3", h2o["q3"]),
        "q7": ("c3", h2o["q7"]),
        "q10": ("c3", h2o["q10"]),
        "q6": ("c3", h2o["q6"]),
        "J1": ("fact", None),
        "J3": ("joined", lambda df: df.groupby("label", agg={"x": "sum", "n": "count"})),
    }


def phase24_sharded(df, mesh):
    """``df`` over ``mesh``: a copy whose executor runs its passes sharded."""
    from vaex_tpu_torch.execution import ExecutorLocal
    out = df.copy()
    out.executor = ExecutorLocal(mesh=mesh)
    return out


def phase24_answer(out):
    """A query's answer as {column: tensor} (a scalar or grid as "value"): a
    result frame's tensor columns where they lie, others from the host."""
    if not hasattr(out, "get_column_names"):
        return {"value": out if isinstance(out, torch.Tensor) else torch.as_tensor(np.asarray(out))}
    answer = {}
    for name in out.get_column_names():
        col = out.dataset[name]
        if not isinstance(col, torch.Tensor):
            values = out[name].values
            col = torch.as_tensor(np.asarray(np.ma.filled(values, -1)
                                             if np.ma.isMaskedArray(values) else values))
        answer[name] = col
    return answer


def _phase24_cells(cols, keys, n):
    """Each row's cell of the dense config 3 keys (1 .. span), and the cells."""
    cell, size = None, 1
    for key in keys:
        span = config3_span(key, n)
        part = cols[key] - 1
        cell = part if cell is None else cell * span + part
        size *= span
    return cell, size


def _phase24_per_cell(cell, size, v, observed=False):
    """(rows, sum, sum of |v|, sum of v^2) of ``v`` per cell, float64 on the
    CPU; of the cells some row has where ``observed`` (a dense key's result
    keeps those alone)."""
    v = v.to(torch.float64)
    n = torch.bincount(cell, minlength=size).to(torch.float64)
    s = torch.zeros(size, dtype=torch.float64, device=v.device).index_add_(0, cell, v)
    a = torch.zeros(size, dtype=torch.float64, device=v.device).index_add_(0, cell, v.abs())
    s2 = torch.zeros(size, dtype=torch.float64, device=v.device).index_add_(0, cell, v * v)
    keep = n > 0 if observed else torch.ones_like(n, dtype=torch.bool)
    return tuple(t[keep].cpu() for t in (n, s, a, s2))


def phase24_scales(cols, name, n):
    """Per float column of a query the plain sums its bound is made of:
    (kind, rows, sum, sum of |v|, sum of v^2) per cell in the result's order."""
    if name in ("c1 groupby", "nccl c1 groupby"):
        return {"s": ("sum",) + _phase24_per_cell(cols["i1"], K, cols["x"])}
    if name == "c1 std":
        x = cols["x"]
        one = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        return {"value": ("std0",) + _phase24_per_cell(one, 1, x)}
    if name in ("q6-sd", "q6"):
        cell, size = _phase24_cells(cols, ("id4", "id5"), n)
        return {"sd_v3": ("std1",) + _phase24_per_cell(cell, size, cols["v3"], observed=True)}
    if name == "q3":
        cell, size = _phase24_cells(cols, ("id3",), n)
        return {"v3": ("mean",) + _phase24_per_cell(cell, size, cols["v3"], observed=True)}
    return {}  # q10's and J3's sums are of terms >= 0: their own scale


def phase24_check(name, got, want, scales, phase="phase 24"):
    """A sharded answer against the single-device pass's on the same tensors
    (raises): keys, counts, int sums, min / max, medians and join rows
    exactly; float sums within ``within_sum_bound``, means and stds within
    that bound carried through their formulas; ``phase`` names the failure."""
    check(sorted(got) == sorted(want), f"{phase} {name}: columns {sorted(got)} {sorted(want)}")
    for column, w in want.items():
        g = got[column].to(w.device)  # a key column may come from the host on one side
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{phase} {name} {column}: {g.shape} {g.dtype} against {w.shape} {w.dtype}")
        what = f"{phase} {name} {column}: the sharded answer equals the single device's"
        if not w.is_floating_point() or column in ("median_v3",):
            check(torch.equal(g, w), what)
            continue
        if column not in scales:  # a sum of terms >= 0 (q10's v3, J3's x)
            counts = got.get("v1", got.get("n"))
            check(within_sum_bound(g, w, w.abs(), counts), what + " within the bound")
            continue
        kind, n, s, a, s2 = scales[column]
        g64, w64 = (t.reshape(-1).to(torch.float64).cpu() for t in (g, w))
        both_nan = torch.isnan(g64) & torch.isnan(w64)  # an empty cell, or one row and ddof 1
        if kind == "sum":
            ok = within_sum_bound(g64, w64, a, n)
        elif kind == "mean":  # each side within its sum's bound over n, of the exact mean
            ok = bool((((g64 - w64).abs() <= 2 * _bound(s, a, n) / n.clamp(min=1)) | both_nan
                       ).all())
        else:  # a std: each side's square within the variance's bound
            ddof = 1 if kind == "std1" else 0
            b1, b2 = _bound(s, a, n), _bound(s2, s2, n)
            var_bound = (b2 / n + (2 * s.abs() * b1 + b1 * b1) / (n * n)
                         + 8 * 2.0 ** -52 * (s2 / n + (s / n) ** 2) + ATOL)
            scale = n / (n - ddof).clamp(min=1)
            ok = bool((((g64 * g64 - w64 * w64).abs() <= 2 * var_bound * scale) | both_nan).all())
        check(ok, what + f" within the bound ({kind})")


class phase24_counted:
    """The launches of the sharded queries alone: ``run(name, query, df)``
    reads the counts just before and just after ``query(df)`` and fails
    unless one of the query's own kernels (``PHASE24_OWN``) was launched."""

    def __init__(self, plan, gp, probe):
        self.plan, self.gp, self.probe = plan, gp, probe
        zero_launches(plan, gp)
        probe.probe.launches = probe.probe.wide_launches = 0
        self.launches = dict.fromkeys(self.counts(), 0)

    def counts(self):
        return {**launch_counts(self.plan, self.gp), "b6": self.probe.probe.launches,
                "b6-wide": self.probe.probe.wide_launches}

    def __call__(self, name, query, df):
        before = self.counts()
        out = query(df)
        _sync()
        after = self.counts()
        for kernel in after:
            self.launches[kernel] += after[kernel] - before[kernel]
        own = PHASE24_OWN[name]
        check(own is None or any(after[k] > before[k] for k in own),
              f"phase 24 {name}: none of {own} was launched on the shard tiles "
              f"({ {k: after[k] - before[k] for k in after} })")
        return out


def phase24_plain_run(name, query, df):
    return query(df)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def phase24_lookup(joined):
    """The row index of a join's right columns, and its mask."""
    col = joined.dataset["label"]
    return col.index, col.mask


def phase24_drive(vt, frames, mesh, run=phase24_plain_run, expect_routes=True, reps=0):
    """Every query on the single-device frames first (the references, never
    counted), then on the frames over ``mesh`` through ``run``, each checked
    against its reference; a rerun of config 1's groupby gives the same
    bits.  With ``reps`` each query is timed, sharded and single, medians.
    Returns {query: record}."""
    from vaex_tpu_torch import cache
    queries = phase24_queries(vt, frames["ids"])
    records = {}
    with cache.off():
        single = dict(frames)
        single["joined"] = frames["fact"].join(frames["dim"], on="key")
        wants, times = {}, {}
        for name, (frame, query) in queries.items():
            if query is not None:
                wants[name] = phase24_answer(query(single[frame]))
        want_lookup = phase24_lookup(single["joined"])
        sharded = {k: phase24_sharded(frames[k], mesh) for k in ("c1", "c3", "fact")}
        sharded["dim"] = frames["dim"]
        for name, (frame, query) in queries.items():
            if name == "J1":
                sharded["joined"] = run("J1", lambda df: df.join(sharded["dim"], on="key"),
                                        sharded["fact"])
                got, want = phase24_lookup(sharded["joined"]), want_lookup
                check(torch.equal(got[0], want[0]) and (got[1] is None) == (want[1] is None)
                      and (got[1] is None or torch.equal(got[1], want[1])),
                      "phase 24 J1: the mesh join's rows equal the single device's")
                log = sharded["fact"].executor.trace_log
                entry = [e for e in log if e.get("join")][-1]
                check(entry["join"] == "mesh", f"phase 24 J1 took {entry}")
                records[name] = {"route": "mesh", "probe": entry["probe"],
                                 "alltoall_bytes_per_device": entry["alltoall_bytes_per_device"],
                                 "slack": entry["slack"]}
                continue
            df = sharded[frame]
            log = df.executor.trace_log
            start = len(log)
            out = run(name, query, df)
            got = phase24_answer(out)
            phase24_check(name, got, wants[name],
                          phase24_scales(frames["cols"], name, frames["n"]))
            records[name] = phase24_record(name, log[start:], mesh, expect_routes)
            records[name]["devices"] = {k: [str(v.device), str(wants[name][k].device)]
                                        for k, v in got.items()}
        again = phase24_answer(queries["c1 groupby"][1](sharded["c1"]))
        first = phase24_answer(queries["c1 groupby"][1](sharded["c1"]))
        check(again["s"].cpu().numpy().tobytes() == first["s"].cpu().numpy().tobytes(),
              "phase 24: a rerun of the sharded float groupby gives the same bits")
        if reps:
            for name, (frame, query) in queries.items():
                if name == "J1":
                    fs, fm = single["fact"], sharded["fact"]
                    records[name]["single_ms"] = _median_ms(
                        lambda: fs.join(frames["dim"], on="key"), reps)
                    records[name]["sharded_ms"] = _median_ms(
                        lambda: fm.join(frames["dim"], on="key"), reps)
                    continue
                records[name]["single_ms"] = _median_ms(lambda: query(single[frame]), reps)
                records[name]["sharded_ms"] = _median_ms(lambda: query(sharded[frame]), reps)
    return records


def _median_ms(fn, reps):
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase24_record(name, entries, mesh, expect_routes):
    """What a sharded query's trace says: its passes' shards, the exchange's
    bytes a shard and its retries; checks the route each takes."""
    passes = [e for e in entries if e.get("mesh")]
    shuffles = [e for e in entries if e.get("shuffle") is True]
    fused = [e for e in entries if e.get("fused_mesh_groupby") is True]
    record = {"passes": len(passes),
              "shards": passes[-1]["mesh"]["shards"] if passes else None}
    if name in ("q3", "q7"):
        check(bool(shuffles) or not expect_routes, f"phase 24 {name}: no shuffle ran {entries}")
    if name in ("q10", "q6"):
        check(bool(fused), f"phase 24 {name}: the fused exchange did not run")
    for e in shuffles:
        # each shard sends slack x its rows, of row_bytes each
        check(e["alltoall_bytes_per_device"] == e["rows_per_device"] * e["slack"] * e["row_bytes"]
              or e["capacity"] == 64, f"phase 24 {name}: exchange bytes {e}")
        record.update(route="shuffle", strategies=e["strategies"], slack=e["slack"],
                      retries=len([x for x in entries if x.get("shuffle") == "overflow"]),
                      alltoall_bytes_per_device=e["alltoall_bytes_per_device"])
    for e in fused:
        record.update(route="fused exchange", slack=e["slack"], retries=e["attempt"],
                      alltoall_bytes_per_device=e["alltoall_bytes_per_device"],
                      groups=e["groups"], mode=e["mode"])
    if passes and "route" not in record:
        record.update(route="sharded pass",
                      strategies=[s for e in passes for s in e["strategies"]])
        check(all(e["mesh"]["shards"] == [str(d) for d in mesh.devices] for e in passes),
              f"phase 24 {name}: a pass off the mesh")
    return record


def phase24_nccl(vt, frames, run):
    """Config 1's groupby over four shards whose merges go through a NCCL
    process group of one process (a free port on localhost), checked; the
    group is destroyed after."""
    import socket
    import torch.distributed as dist
    from vaex_tpu_torch import cache
    from vaex_tpu_torch.parallel import initialize_multihost
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    try:
        mesh = phase24_mesh("cuda:0")
        check(mesh.group is not None and dist.get_backend(mesh.group) == "nccl",
              "phase 24: the mesh has the NCCL group")
        with cache.off():
            want = phase24_answer(run_query(frames["c1"], vt))
            df = phase24_sharded(frames["c1"], mesh)
            got = phase24_answer(run("nccl c1 groupby", lambda d: run_query(d, vt), df))
        phase24_check("nccl c1 groupby", got, want,
                      phase24_scales(frames["cols"], "nccl c1 groupby", frames["n"]))
        entry = df.executor.trace_log[-1]["mesh"]
        return {"backend": "nccl", "world": entry["world"], "shards": entry["shards"]}
    finally:
        dist.destroy_process_group()


PHASE24_GLOO = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[3])
from chip_smoke import port_collectives
rank, store, device = int(sys.argv[1]), sys.argv[2], sys.argv[5]
dist.init_process_group("gloo", init_method="file://" + store, world_size=2, rank=rank)
tried = port_collectives(device)
out = {"collectives": tried}
if all(v == "ok" for v in tried.values()):
    import vaex_tpu_torch as vt
    from chip_smoke import within_sum_bound
    from vaex_tpu_torch.parallel import distributed_executor
    n = int(sys.argv[4])
    gen = torch.Generator(device=device).manual_seed(42)
    i1 = torch.randint(0, 100, (n,), generator=gen, device=device)
    x = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    half = slice(rank * n // 2, (rank + 1) * n // 2)
    df = vt.from_dataset(vt.DatasetArrays({"i1": i1[half].clone(), "x": x[half].clone()}))
    df = df.categorize("i1", labels=range(100))
    df.executor = distributed_executor(devices=[device] * 2)
    g = df.groupby("i1", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)
    c = torch.bincount(i1, minlength=100).cpu()
    s = torch.zeros(100, dtype=torch.float64, device=device).index_add_(0, i1, x).cpu()
    got_c, got_s = torch.as_tensor(g["c"].values), torch.as_tensor(g["s"].values)
    out["merge_world"] = df.executor.trace_log[-1]["mesh"]["world"]
    out["counts_exact"] = bool(torch.equal(got_c, c))
    out["sums_within_bound"] = bool(within_sum_bound(got_s, s, s, c))  # x >= 0: |x| = x
print("RESULT " + json.dumps(out), flush=True)
# leave the group together, then end without the interpreter's teardown:
# gloo's threads torn down at exit can abort a process whose work is done
dist.barrier()
dist.destroy_process_group()
os._exit(0)
'''


def phase24_gloo(n=PHASE24_GLOO_ROWS, timeout=120, device="cuda"):
    """Two processes of two shards each on ``device``, their merges over
    gloo: first each collective of the port on that device's tensors
    (:func:`port_collectives`); where they all answer, config 1's groupby
    over the four shards against plain torch.  Returns each process's record with its exit code
    (``failed``: its output where it printed no result)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="phase24-")
    try:
        script = os.path.join(tmp, "gloo.py")
        with open(script, "w") as f:
            f.write(PHASE24_GLOO)
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen([sys.executable, script, str(r), store, HERE, str(n), device],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    records = []
    for p, out in zip(procs, outs):
        if "RESULT " not in out:
            records.append({"failed": out[-1500:], "rc": p.returncode})
        else:
            records.append({**json.loads(out.split("RESULT ", 1)[1].splitlines()[0]),
                            "rc": p.returncode})
    return records


def phase24_gloo_verdict(records):
    """What the two gloo processes showed (raises otherwise): each process
    exited 0, every collective took the device's tensors (a refusal, named,
    fails the phase), and the merge across the two processes gave counts
    equal to plain torch's and sums within ``within_sum_bound``."""
    check(len(records) == 2, f"phase 24 gloo: {len(records)} records of 2 processes")
    for r in records:
        check("failed" not in r and r.get("rc") == 0 and "collectives" in r,
              f"phase 24 gloo: a process failed: {r}")
    refused = [sorted(n for n, v in r["collectives"].items() if v != "ok") for r in records]
    check(not any(refused), f"phase 24 gloo: a collective refused the tensors: {refused}")
    for r in records:
        check(r.get("merge_world") == 2,
              f"phase 24 gloo: the groupby's merge did not cross the processes: {r}")
        check(r.get("counts_exact") is True and r.get("sums_within_bound") is True,
              f"phase 24 gloo: the groupby across processes is wrong: {r}")
    return {"ran": True}


def phase24_path(vt, plan, gp, probe, label):
    """Phase 24 on the card (see the module's docstring).  Returns (the
    launches on shard tiles, the phase's JSON record)."""
    t_phase = time.perf_counter()
    mesh = phase24_mesh("cuda:0")
    frames = phase24_frames(vt, "cuda")
    counted = phase24_counted(plan, gp, probe)
    records = phase24_drive(vt, frames, mesh, run=counted, reps=3)
    nccl = phase24_nccl(vt, frames, counted)
    launches = counted.launches
    print(f"launches on shard tiles during phase 24: {launches}", flush=True)
    for names in PHASE24_KERNELS:
        check(any(launches[k] > 0 for k in names),
              f"none of {names} was launched on shard tiles during phase 24: {launches}")
    del frames
    gc.collect()
    torch.cuda.empty_cache()
    gloo = phase24_gloo()
    verdict = phase24_gloo_verdict(gloo)
    record = {"card": label, "shards": [str(d) for d in mesh.devices], "rows": PHASE24_ROWS,
              "fact_rows": PHASE24_FACT, "dim_rows": PHASE24_DIM, "queries": records,
              "nccl": nccl, "gloo_cuda": {**verdict, "processes": gloo}, "launches": launches,
              "phase_s": time.perf_counter() - t_phase}
    print(f"[{label}] phase 24: {len(records)} queries over {PHASE24_SHARDS} shards of cuda:0 "
          f"equal the single device's; NCCL world of one: {nccl}; gloo on CUDA: {verdict} {gloo}",
          flush=True)
    return launches, record


# phase 25: serving and the frame's accessors (ROADMAP A13, first half): a
# table served on the card answering REST, websocket, client, GraphQL and
# linked-view requests, with astro and geo columns over it, and the CLI
PHASE25_ROWS = 100_000_000
PHASE25_K = 100  # key's categories
PHASE25_CLI_ROWS = 1_000_000
PHASE25_TOKEN = "phase-25-token"
PHASE25_REPS = 3
PHASE25_COLUMNS = {"key": "int64", "x": "float64", "ra": "float64", "dec": "float64",
                   "parallax": "float64", "g_mag": "float32"}
# a pentagon in (ra, dec) degrees, for inside_polygon
PHASE25_POLYGON = ([30.0, 120.0, 150.0, 80.0, 20.0], [-20.0, -35.0, 10.0, 50.0, 25.0])
PHASE25_GRAPHQL = ("{ df(where: {g_mag: {_lt: 15}}) { count mean { x } "
                   "groupby { key { count mean { x } } } } }")
# the kernels the phase must launch: the 64-bin histogram and the groupby
# (B1), the 128 x 128 heatmap (B2), the std (B4)
PHASE25_KERNELS = ("b1", "b2", "b4")


def phase25_columns(n, device, seed=SEED):
    """The served table, made on ``device`` from ``seed``: key int64 of
    PHASE25_K categories, x N(0, 1), ra and dec uniform on the sphere in
    degrees, parallax in [0.05, 5) mas (float64), g_mag N(17, 2) (float32)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(generator=gen, device=device, dtype=torch.float64)
    key = torch.randint(0, PHASE25_K, (n,), generator=gen, device=device, dtype=torch.int64)
    x = torch.randn(n, **f64)
    ra = torch.rand(n, **f64) * 360.0
    dec = torch.rad2deg(torch.asin(torch.rand(n, **f64) * 2.0 - 1.0))
    parallax = torch.rand(n, **f64) * 4.95 + 0.05
    g_mag = torch.randn(n, generator=gen, device=device, dtype=torch.float32) * 2.0 + 17.0
    return {"key": key, "x": x, "ra": ra, "dec": dec, "parallax": parallax, "g_mag": g_mag}


def phase25_frame(vt, cols):
    return vt.from_dataset(vt.DatasetArrays(cols)).categorize("key", labels=range(PHASE25_K))


def phase25_http(app, method, path, query="", body=None, token=PHASE25_TOKEN):
    """(status, JSON body) of one request to the ASGI app, driven in this
    process; the token goes as the x-token header."""
    import asyncio
    headers = [] if token is None else [(b"x-token", token.encode())]
    scope = {"type": "http", "method": method, "path": path, "query_string": query.encode(),
             "headers": headers}
    incoming = [{"type": "http.request", "body": json.dumps(body).encode() if body else b"",
                 "more_body": False}]
    sent = []

    async def receive():
        return incoming.pop(0)

    async def send(event):
        sent.append(event)
    asyncio.run(app(scope, receive, send))
    return sent[0]["status"], json.loads(b"".join(e.get("body", b"") for e in sent[1:]))


def phase25_ws(app, messages):
    """The app's replies to ``messages`` over one /websocket connection."""
    import asyncio
    incoming = ([{"type": "websocket.connect"}]
                + [{"type": "websocket.receive", "text": json.dumps(m)} for m in messages]
                + [{"type": "websocket.disconnect"}])
    sent = []

    async def receive():
        return incoming.pop(0)

    async def send(event):
        sent.append(event)
    asyncio.run(app({"type": "websocket", "path": "/websocket", "headers": []}, receive, send))
    check(sent[0]["type"] == "websocket.accept", f"phase 25 websocket: {sent[0]}")
    return [json.loads(e["text"]) for e in sent[1:]]


def phase25_call(method, args=(), kwargs=None, msg_id=None):
    from vaex_tpu_torch.server.service import encode_result
    return {"msg_id": msg_id, "command": "call", "df": "sky", "method": method,
            "args": encode_result(list(args)), "kwargs": encode_result(dict(kwargs or {})),
            "auth": {"token": PHASE25_TOKEN}}


def phase25_reply(reply):
    from vaex_tpu_torch.server.service import decode_result
    check("error" not in reply, f"phase 25 websocket reply: {reply.get('error')}")
    return decode_result(reply["result"])


def phase25_bins(c, lo, hi, bins):
    """(bin, inside) of each value over [lo, hi) by the binner's formula
    (floor((c - lo) * ((1 / span) * bins))); the value at hi overflows."""
    b = torch.floor((c - lo) * (1.0 / (hi - lo) * bins)).to(torch.int64)
    return b, (c >= lo) & (c < hi) & (b < bins)


def phase25_grid(axes, bins, keep=None):
    """The count grid of ``axes`` (tensors) at ``bins`` a side over each
    one's own min and max, rows where ``keep``: (grid as int64 numpy, the
    limits)."""
    cell, inside, limits = None, keep, []
    for c in axes:
        lo, hi = (float(t) for t in torch.aminmax(c))
        limits.append([lo, hi])
        b, ok = phase25_bins(c, lo, hi, bins)
        cell = b if cell is None else cell * bins + b
        inside = ok if inside is None else inside & ok
    grid = torch.bincount(cell[inside], minlength=bins ** len(axes))
    return grid.reshape((bins,) * len(axes)).cpu().numpy(), limits


def phase25_moments(v, keep=None):
    """(n, sum, sum of |v|, sum of v^2) of v where ``keep``, the terms of
    the bounds of a mean and a std."""
    if keep is not None:
        v = v[keep]
    return (int(v.numel()), float(v.sum()), float(v.abs().sum()), float((v * v).sum()))


def phase25_pnpoly(x, y, xs, ys):
    """The crossing rule in plain torch: True where (x, y) lies inside the
    polygon of vertices (xs, ys)."""
    inside = torch.zeros_like(x, dtype=torch.bool)
    j = len(xs) - 1
    for i in range(len(xs)):
        x0, y0, x1, y1 = xs[j], ys[j], xs[i], ys[i]
        inside ^= ((y1 > y) != (y0 > y)) & (x < (x0 - x1) * (y - y1) / ((y0 - y1) or 1e-300) + x1)
        j = i
    return inside


def phase25_eq2gal(ra, dec):
    """(l, b) in degrees in plain torch, the rotation of df.astro.eq2gal
    written out: the unit vector, the J2000 matrix, the angles back."""
    from vaex_tpu_torch.astro import FRAME_MATRICES
    a, d = torch.deg2rad(ra), torch.deg2rad(dec)
    xyz = (torch.cos(a) * torch.cos(d), torch.sin(a) * torch.cos(d), torch.sin(d))
    xo, yo, zo = ((row[0]) * xyz[0] + (row[1]) * xyz[1] + (row[2]) * xyz[2]
                  for row in FRAME_MATRICES["eq2gal"])
    l_ = torch.atan2(yo, xo) * 180.0 / math.pi
    b_ = (math.pi / 2 - torch.arccos(zo / torch.sqrt(xo ** 2 + yo ** 2 + zo ** 2))) * 180.0 / math.pi
    return l_, b_


def phase25_check(name, got, want):
    """One request's answer against its plain torch computation; raises
    where they disagree.  Names, schemas, counts, grids, limits and extremes
    exact; means, stds, sums and correlations within the bound of phase 4
    carried through their formulas (``want`` holds the moments)."""
    if name in ("dataset", "401", "400"):
        check(got == want, f"phase 25 {name}: {got} != {want}")
        return
    if name.startswith(("histogram", "heatmap")):
        grid, limits = want
        limits = limits[0] if len(limits) == 1 else limits  # a histogram's one pair
        check(np.array_equal(np.asarray(got["values"]), grid) and got["limits"] == limits,
              f"phase 25 {name}: grid or limits differ from plain torch "
              f"({np.asarray(got['values']).sum()} vs {grid.sum()}, {got['limits']} vs {limits})")
        return
    if name in ("count r", "astro count l b", "_what_grid"):
        check(np.array_equal(np.asarray(got), want[0]),
              f"phase 25 {name}: the grid differs from plain torch "
              f"({np.asarray(got).sum()} vs {want[0].sum()})")
        return
    if name in ("minmax r", "geo inside_polygon", "cancel then count"):
        check(np.array_equal(np.asarray(got), np.asarray(want)),
              f"phase 25 {name}: {got} != {want}")
        return
    if name in ("std parallax",):
        n, s, a, s2 = want
        var, var_bound = _std_error(n, s, a, s2)
        check(abs(float(got) ** 2 - var) <= var_bound, f"phase 25 {name}: {got!r} vs var {var!r}")
        return
    if name in ("mean r", "mean x"):
        n, s, a, _ = want
        check(_close(got, s / n, _mean_error(n, s, a)), f"phase 25 {name}: {got!r} vs {s / n!r}")
        return
    if name == "correlation":
        check(abs(float(got) - want) <= 1e-9, f"phase 25 {name}: {got!r} vs {want!r}")
        return
    if name == "groupby":
        counts, sums, abs_sums = want
        check(np.array_equal(np.asarray(got["key"]), np.arange(PHASE25_K))
              and np.array_equal(np.asarray(got["n"]), counts.cpu().numpy()),
              f"phase 25 {name}: keys or counts differ from plain torch")
        check(within_sum_bound(torch.as_tensor(np.asarray(got["s"]), dtype=torch.float64),
                               sums.cpu(), abs_sums.cpu(), counts.cpu()),
              f"phase 25 {name}: the sums are not within the bound")
        return
    if name == "graphql":
        counts, sums, abs_sums = want["groups"]
        data = got["df"]
        n, s, a, _ = want["all"]
        check(data["count"] == n and _close(data["mean"]["x"], s / n, _mean_error(n, s, a)),
              f"phase 25 graphql: count {data['count']} / {n}, mean {data['mean']['x']!r}")
        g = data["groupby"]["key"]
        c = counts.cpu().numpy()
        means, bounds = (sums / counts).cpu().numpy(), [
            _mean_error(int(ci), float(si), float(ai)) for ci, si, ai in zip(c, sums, abs_sums)]
        check(g["count"] == c.tolist() and _close(g["mean"]["x"], means, bounds),
              "phase 25 graphql: the groupby's counts or means differ from plain torch")
        return
    if name == "progress":
        check(bool(got) and got[-1] == 1.0 and all(a <= b for a, b in zip(got, got[1:])),
              f"phase 25 progress fractions {got}")
        return
    if name == "astro l b":
        check(all(float((g - w).abs().max()) * math.pi / 180 <= 1e-12 for g, w in zip(got, want)),
              "phase 25 astro: l or b differs from plain torch by more than 1e-12 rad")
        return
    if name == "linked views":
        check(got["passes"] == 1, f"phase 25 linked views: the brush took {got['passes']} passes")
        for view in ("hist", "heat"):
            check(np.array_equal(got[view], want[view]),
                  f"phase 25 linked views: the {view} grids differ from plain torch")
        return
    raise KeyError(name)


def phase25_plain(cols, name, extra=None):
    """The plain torch answer of one request (``extra``: the port's own
    materialized columns where the request bins one)."""
    x, g_mag, parallax, key = cols["x"], cols["g_mag"], cols["parallax"], cols["key"]
    bright = g_mag < 15
    if name == "dataset":
        return {"names": ["sky"], "rows": int(x.numel()), "schema": PHASE25_COLUMNS}
    if name == "401":
        return 401
    if name == "400":
        return [400, 0]
    if name == "histogram x":
        return phase25_grid([x], 64)
    if name == "histogram x filtered":
        return phase25_grid([x], 64, keep=bright)
    if name == "heatmap ra dec":
        return phase25_grid([cols["ra"], cols["dec"]], 128)
    if name == "heatmap POST":
        return phase25_grid([cols["ra"], cols["dec"]], 128, keep=cols["dec"] > 0)
    if name == "std parallax":
        return phase25_moments(parallax)
    if name in ("groupby", "graphql groups"):
        keep = bright if name == "graphql groups" else torch.ones_like(bright)
        k, v = key[keep], x[keep]
        counts = torch.bincount(k, minlength=PHASE25_K)
        zeros = torch.zeros(PHASE25_K, dtype=torch.float64, device=x.device)
        return counts, zeros.index_add(0, k, v), zeros.index_add(0, k, v.abs())
    if name == "graphql":
        return {"all": phase25_moments(x, bright), "groups": phase25_plain(cols, "graphql groups")}
    r = extra
    if name == "count r":
        return phase25_grid([r], 1000, keep=bright)
    if name == "mean r":
        return phase25_moments(r, bright)
    if name == "minmax r":
        lo, hi = torch.aminmax(r)
        return [float(lo), float(hi)]
    if name == "correlation":
        return float(torch.corrcoef(torch.stack([x, parallax]))[0, 1])
    if name == "cancel then count":
        return int(x.numel())
    if name == "astro count l b":
        return phase25_grid(list(extra), 256)
    if name == "geo inside_polygon":
        return int(phase25_pnpoly(cols["ra"], cols["dec"], *PHASE25_POLYGON).sum())
    if name == "_what_grid":
        return phase25_grid([x], 64, keep=bright)
    raise KeyError(name)


def phase25_linked_views(vt, df, cols):
    """A GridModel histogram of x (64 bins) and a heatmap of ra, dec (128 x
    128) on one dispatcher, both with selections [None, True]; then the
    brush select("x > 1"): its passes, the grids after it, and the frame
    of the views (whose next select brushes again)."""
    from vaex_tpu_torch import jupyter
    dfv = df.copy()
    hist = jupyter.GridModel(dfv, [jupyter.Axis(dfv, "x", shape=64)], selection=[None, True])
    heat = jupyter.GridModel(dfv, [jupyter.Axis(dfv, "ra", shape=128),
                                   jupyter.Axis(dfv, "dec", shape=128)], selection=[None, True])
    check(jupyter.get_dispatcher(dfv).models == [hist, heat], "phase 25: one dispatcher")
    hist.compute()
    heat.compute()
    before = dfv.executor.passes
    dfv.select("x > 1")
    return {"passes": dfv.executor.passes - before, "hist": np.asarray(hist.grid),
            "heat": np.asarray(heat.grid), "frame": dfv,
            "limits": [[a.min, a.max] for a in hist.axes + heat.axes]}


def phase25_brush_direct(df, limits):
    """The linked views' four grids called directly on the frame: two
    statistics, one pass each."""
    sel = [None, "x > 1"]
    return (df.count(binby=["x"], limits=limits[:1], shape=64, selection=sel),
            df.count(binby=["ra", "dec"], limits=limits[1:], shape=128, selection=sel))


def phase25_linked_plain(cols):
    x, ra, dec = cols["x"], cols["ra"], cols["dec"]
    brush = x > 1
    return {"hist": np.stack([phase25_grid([x], 64)[0], phase25_grid([x], 64, brush)[0]]),
            "heat": np.stack([phase25_grid([ra, dec], 128)[0],
                              phase25_grid([ra, dec], 128, brush)[0]])}


def phase25_requests(vt, df, cols, device):
    """{name: (served, direct)}: each request through the server (the ASGI
    app in this process, its /websocket, a Client over DummyTransport) or
    the accessor, and the same statistic called directly on the frame.  A
    served answer comes back as the wire's JSON or numpy."""
    from vaex_tpu_torch.server import asgi
    from vaex_tpu_torch.server.client import Client
    from vaex_tpu_torch.server.service import DummyTransport, Service
    svc = Service({"sky": df}, token=PHASE25_TOKEN)
    app = asgi.create_app(svc)
    dfr = Client(DummyTransport(svc), token=PHASE25_TOKEN)["sky"]
    dfr["r"] = "sqrt(x**2 + parallax**2)"
    dfr.select("g_mag < 15")
    local = df.copy()
    local["r"] = "sqrt(x**2 + parallax**2)"
    local.select("g_mag < 15")

    def dataset():
        _, names = phase25_http(app, "GET", "/dataset")
        _, meta = phase25_http(app, "GET", "/dataset/sky")
        return {"names": names, "rows": meta["row_count"], "schema": meta["schema"]}

    def direct_dataset():
        return {"names": list(svc.dataframes), "rows": df.length_original(),
                "schema": {c: df.data_type(c).name for c in df.get_column_names()}}

    def served_get(path, query=""):
        def run():
            status, body = phase25_http(app, "GET", path, query)
            check(status == 200, f"phase 25 GET {path}?{query}: {status} {body}")
            return body
        return run

    def direct_grid(axes, shape, selection=False):
        def run():
            limits = df.limits(axes, None)  # a pair for each axis
            values = df.count(binby=axes, limits=limits, shape=shape, selection=selection)
            return {"values": values, "limits": [list(map(float, l)) for l in limits]}
        return run

    def heatmap_post():
        status, body = phase25_http(app, "POST", "/heatmap", body={
            "dataset_id": "sky", "expression_x": "ra", "expression_y": "dec", "shape_x": 128,
            "shape_y": 128, "filter": "dec > 0"})
        check(status == 200, f"phase 25 POST /heatmap: {status} {body}")
        return body

    def refused():
        """A filter that leaves the expression language: refused with 400
        before any pass (the number of passes it ran beside the status)."""
        passes = df.executor.passes
        status, _ = phase25_http(app, "POST", "/histogram", body={
            "dataset_id": "sky", "expression": "x", "filter": "x.__class__.__name__ == 'NA'"})
        return [status, df.executor.passes - passes]

    def ws(method, args, kwargs=None):
        def run():
            [reply] = phase25_ws(app, [phase25_call(method, args, kwargs, msg_id=f"m-{method}")])
            check(reply["msg_id"] == f"m-{method}", f"phase 25 websocket msg_id {reply['msg_id']}")
            return phase25_reply(reply)
        return run

    def groupby_direct():
        out = df.groupby("key", agg={"s": vt.agg.sum("x"), "n": "count"}, sort=True)
        return {name: out.evaluate(name) for name in ("key", "s", "n")}

    def progress():
        fractions = []
        dfr.client.on_progress = fractions.append
        try:
            dfr.sum("x")
        finally:
            dfr.client.on_progress = None
        return fractions

    def cancel_then_count():
        dfr.client.on_progress = lambda f: False
        try:
            dfr.sum("parallax")
            cancelled = False
        except RuntimeError as e:
            cancelled = "abort" in str(e).lower() or "cancel" in str(e).lower()
        finally:
            dfr.client.on_progress = None
        check(cancelled, "phase 25: the cancelled call did not answer with an error reply")
        return dfr.count()

    def graphql_direct():
        dff = df.filter("g_mag < 15")
        return (dff.count(), dff.mean("x"),
                dff.groupby("key", agg={"n": "count", "m": vt.agg.mean("x")}, sort=True))

    def astro():
        dfa = df.astro.eq2gal()
        return dfa.count(binby=["l", "b"], shape=256)

    def inside():
        return int(df.count(selection=df.geo.inside_polygon("ra", "dec", *PHASE25_POLYGON)))

    def inside_direct():
        xs, ys = (repr(list(v)) for v in PHASE25_POLYGON)
        return int(df.count(selection=f"pnpoly(ra, dec, {xs}, {ys})"))

    return {
        "dataset": (dataset, direct_dataset),
        "histogram x": (served_get("/histogram/sky/x", "shape=64"), direct_grid(["x"], 64)),
        "histogram x filtered": (served_get("/histogram/sky/x", "shape=64&filter=g_mag%20%3C%2015"),
                                 direct_grid(["x"], 64, "g_mag < 15")),
        "heatmap ra dec": (served_get("/heatmap/sky/ra/dec"), direct_grid(["ra", "dec"], 128)),
        "heatmap POST": (heatmap_post, direct_grid(["ra", "dec"], 128, "dec > 0")),
        "401": (lambda: phase25_http(app, "GET", "/histogram/sky/x", token=None)[0],
                lambda: 401),
        "400": (refused, lambda: [400, 0]),
        "std parallax": (ws("std", ("parallax",)), lambda: df.std("parallax")),
        "groupby": (ws("groupby_agg", ("key", {"s": ["sum", "x"], "n": "count"})),
                    groupby_direct),
        "count r": (lambda: dfr.count(binby=["r"], shape=1000, selection=True),
                    lambda: local.count(binby=["r"], shape=1000, selection=True)),
        "mean r": (lambda: dfr.mean("r", selection=True), lambda: local.mean("r", selection=True)),
        "minmax r": (lambda: dfr.minmax("r"), lambda: local.minmax("r")),
        "correlation": (lambda: dfr.correlation("x", "parallax"),
                        lambda: df.correlation("x", "parallax")),
        "progress": (progress, None),
        "cancel then count": (cancel_then_count, lambda: df.count()),
        "graphql": (lambda: df.graphql.execute(PHASE25_GRAPHQL).data, graphql_direct),
        "linked views": (lambda: phase25_linked_views(vt, df, cols), None),
        "astro count l b": (astro, astro),
        "geo inside_polygon": (inside, inside_direct),
        "_what_grid": (lambda: df.viz._what_grid("count(*)", ["x"], [df.limits("x", None)], 64,
                                                 "g_mag < 15"), None),
    }


def phase25_materialized(df, names):
    """The port's own values of virtual columns, materialized on the
    frame's device: {name: tensor}."""
    out = {}
    for name in names:
        col = df.materialize(name).dataset[name]
        check(isinstance(col, torch.Tensor), f"phase 25 materialize {name}: {type(col)}")
        out[name] = col
    return out


def phase25_drive(vt, df, cols, device):
    """Every request once, each checked against plain torch; returns
    {name: the served answer} and the port's r, l and b."""
    reqs = phase25_requests(vt, df, cols, device)
    local = df.copy()
    local["r"] = "sqrt(x**2 + parallax**2)"
    r = phase25_materialized(local, ["r"])["r"]
    plain_r = torch.sqrt(cols["x"] ** 2 + cols["parallax"] ** 2)
    check(bool(((r - plain_r).abs() <= 4 * 2.0 ** -52 * plain_r).all()),
          "phase 25: the port's r differs from plain torch's by more than 4 ulp")
    lb = phase25_materialized(df.astro.eq2gal(), ["l", "b"])
    phase25_check("astro l b", (lb["l"], lb["b"]), phase25_eq2gal(cols["ra"], cols["dec"]))
    extra = {"count r": r, "mean r": r, "minmax r": r, "astro count l b": (lb["l"], lb["b"])}
    answers = {}
    for name, (served, _) in reqs.items():
        got = served()
        want = (phase25_linked_plain(cols) if name == "linked views"
                else None if name == "progress" else phase25_plain(cols, name, extra.get(name)))
        phase25_check(name, got, want)
        answers[name] = got
    check(all(isinstance(t, torch.Tensor) and t.device.type == torch.device(device).type
              for t in (df.dataset[c] for c in PHASE25_COLUMNS)),
          "phase 25: a request moved the served frame off its device")
    return answers, reqs, extra


def phase25_cli(vt, cols, n=PHASE25_CLI_ROWS, device="cuda", timeout=300):
    """``python -m vaex_tpu_torch meta | stat | convert`` on an Arrow IPC file
    of the table's first n rows, the three run at once as subprocesses in
    a temporary directory; each must exit 0 and print what the file holds.
    Returns {command: seconds}."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "sky.arrow")
        vt.from_dataset(vt.DatasetArrays({k: v[:n] for k, v in cols.items()})).export(src)
        env = {**os.environ, "PYTHONPATH": HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
               "VAEX_TPU_TORCH_DEVICE": device}
        commands = {"meta": ["meta", src], "stat": ["stat", src],
                    "convert": ["convert", src, os.path.join(tmp, "sky.parquet")]}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen([sys.executable, "-m", "vaex_tpu_torch", *args], cwd=tmp,
                                        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True) for name, args in commands.items()}
        outs, seconds = {}, {}
        try:
            for name, proc in procs.items():
                out, err = proc.communicate(timeout=timeout)
                seconds[name] = time.perf_counter() - t0
                check(proc.returncode == 0, f"phase 25 CLI {name} exited {proc.returncode}: {err}")
                outs[name] = out
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        meta = json.loads(outs["meta"])
        check(meta == {"rows": n, "columns": PHASE25_COLUMNS}, f"phase 25 CLI meta: {meta}")
        lines = outs["stat"].splitlines()
        check(lines[0].split() == list(PHASE25_COLUMNS)
              and lines[2].split() == ["count"] + [str(n)] * len(PHASE25_COLUMNS),
              f"phase 25 CLI stat: {outs['stat']}")
        check(outs["convert"].strip().startswith("wrote "), f"phase 25 CLI convert: {outs}")
        back = vt.open(os.path.join(tmp, "sky.parquet")).to_device(cols["x"].device)
        for name, col in cols.items():
            check(torch.equal(back.dataset[name], col[:n]),
                  f"phase 25 CLI convert: column {name} differs after the round trip")
    return seconds


def phase25_optional(vt, df, cols, label):
    """The parts that need an optional library: the tornado server (tornado
    and websockets) and the drawings (matplotlib); each missing library is
    printed by name.  Returns {part: what ran}."""
    out = {}
    try:
        import tornado  # noqa: F401
        import websockets  # noqa: F401
    except ImportError as e:
        out["tornado"] = f"not installed: {e.name}"
    else:
        out["tornado"] = phase25_tornado(df, cols)
    try:
        import matplotlib
    except ImportError as e:
        out["matplotlib"] = f"not installed: {e.name}"
    else:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        grid = df.viz.histogram("x", shape=64)
        phase25_check("histogram x", {"values": grid, "limits": list(df.limits("x", None))},
                      phase25_plain(cols, "histogram x"))
        df.viz.heatmap("ra", "dec", shape=128)
        plt.close("all")
        out["matplotlib"] = "histogram and heatmap drawn"
    for part, what in out.items():
        print(f"[{label}] phase 25 {part}: {what}", flush=True)
    return out


def phase25_tornado(df, cols):
    """The tornado flavor on a free localhost port: a std over the
    websocket with streamed progress, and the REST histogram; requests run
    on its one worker thread, where the kernels launch."""
    import asyncio
    import socket
    import threading
    import urllib.request
    import tornado.ioloop
    from vaex_tpu_torch.server import client
    from vaex_tpu_torch.server.service import Service
    from vaex_tpu_torch.server.tornado_server import make_app
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    started, holder = threading.Event(), {}

    def run():
        asyncio.set_event_loop(asyncio.new_event_loop())
        make_app(Service({"sky": df}, token=PHASE25_TOKEN)).listen(port, address="localhost")
        holder["loop"] = tornado.ioloop.IOLoop.current()
        started.set()
        holder["loop"].start()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    check(started.wait(30), "phase 25 tornado: the server did not start")
    fractions = []
    try:
        remote = client.connect(f"ws://localhost:{port}", token=PHASE25_TOKEN,
                                on_progress=fractions.append)
        try:
            got = remote["sky"].std("parallax")
        finally:
            remote.close()
        phase25_check("std parallax", got, phase25_plain(cols, "std parallax"))
        phase25_check("progress", fractions, None)
        url = f"http://localhost:{port}/histogram/sky?expression=x&shape=64&token={PHASE25_TOKEN}"
        with urllib.request.urlopen(url, timeout=120) as r:
            body = json.loads(r.read())
        grid, [limits] = phase25_plain(cols, "histogram x")
        check(np.array_equal(np.asarray(body["counts"]), grid) and body["limits"] == limits,
              "phase 25 tornado: the REST histogram differs from plain torch")
    finally:
        holder["loop"].add_callback(holder["loop"].stop)
        thread.join(30)
    return f"websocket std with {len(fractions)} progress frames and the REST histogram right"


def phase25_time(reqs, cols, extra, reps=PHASE25_REPS):
    """{name: {"served_ms", "direct_ms", "plain_ms"}}: medians of ``reps``
    runs (host clock, each ended by a synchronize of the card) of each
    request served, called directly on the frame, and in plain torch, each
    warmed by the drive's run; the linked views' is the brush alone, on
    views built once, against the same four grids as two direct calls."""
    times = {}
    for name, (served, direct) in reqs.items():
        if name in ("401", "400", "progress", "cancel then count"):
            continue
        if name == "linked views":  # the brush alone, on views built once
            views = served()
            entry = {"served_ms": _median_ms(lambda: views["frame"].select("x > 1"), reps),
                     "direct_ms": _median_ms(lambda: phase25_brush_direct(
                         views["frame"], views["limits"]), reps),
                     "plain_ms": _median_ms(lambda: phase25_linked_plain(cols), reps)}
            times[name] = entry
            continue
        entry = {"served_ms": _median_ms(served, reps)}
        if direct is not None:
            entry["direct_ms"] = _median_ms(direct, reps)
        if name == "astro count l b":
            entry["plain_ms"] = _median_ms(lambda: phase25_grid(
                list(phase25_eq2gal(cols["ra"], cols["dec"])), 256), reps)
        elif name in ("count r", "mean r", "minmax r"):
            entry["plain_ms"] = _median_ms(lambda: phase25_plain(cols, name, torch.sqrt(
                cols["x"] ** 2 + cols["parallax"] ** 2)), reps)
        else:
            entry["plain_ms"] = _median_ms(lambda: phase25_plain(cols, name, extra.get(name)),
                                           reps)
        times[name] = entry
    return times


def phase25_path(vt, plan, gp, probe, label, n=PHASE25_ROWS):
    """Phase 25 on the card: the table made on cuda:0, every request driven
    once with the kernel counts set to 0 and checked, B1, B2 and B4 asserted
    launched; then each request timed served, direct and in plain torch;
    the CLI as subprocesses; the tornado server and the drawings where
    their libraries are installed.  Returns (launches, the phase's JSON
    record)."""
    from vaex_tpu_torch import cache
    t_phase = time.perf_counter()
    cols = phase25_columns(n, "cuda")
    df = phase25_frame(vt, cols)
    torch.cuda.synchronize()
    with cache.off():  # every request runs its passes: none is served from the cache
        zero_launches(plan, gp)
        probe.probe.launches = probe.probe.wide_launches = 0
        answers, reqs, extra = phase25_drive(vt, df, cols, "cuda")
        torch.cuda.synchronize()
        launches = {**launch_counts(plan, gp), "b6": probe.probe.launches,
                    "b6-wide": probe.probe.wide_launches}
        print(f"launches during phase 25: {launches}", flush=True)
        for name in PHASE25_KERNELS:
            check(launches[name] > 0, f"{name} was not launched during phase 25: {launches}")
        print(f"[{label}] phase 25 N={n}: {len(answers)} requests equal plain torch; the brush "
              f"regridded both linked views in {answers['linked views']['passes']} pass; "
              f"progress {answers['progress']}", flush=True)
        times = phase25_time(reqs, cols, extra)
    for name, t in times.items():
        print(f"[{label}] phase 25 {name}: served {t['served_ms']!r} ms, direct "
              f"{t.get('direct_ms')!r} ms, plain torch {t['plain_ms']!r} ms", flush=True)
    cli = phase25_cli(vt, cols)
    print(f"[{label}] phase 25 CLI meta / stat / convert of {PHASE25_CLI_ROWS} rows, at once: "
          f"{cli} s", flush=True)
    optional = phase25_optional(vt, df, cols, label)
    record = {"card": label, "rows": n, "bytes": sum(c.element_size() * c.numel()
                                                     for c in cols.values()),
              "requests": times, "progress": answers["progress"],
              "brush_passes": answers["linked views"]["passes"], "cli_s": cli,
              "optional": optional, "launches": launches,
              "phase_s": time.perf_counter() - t_phase}
    del df, cols, reqs, extra, answers
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record


# phase 26: a fitted machine-learning pipeline on the card (ROADMAP A13b): a
# scaler, a PCA, KMeans, the other scalers and discretizers, the encoders,
# the metrics and a state round trip, each step against plain torch
PHASE26_ROWS = 100_000_000
PHASE26_FEATURES = [f"x{d}" for d in range(8)]
PHASE26_CENTRES = 16
PHASE26_K = 100  # key's categories
PHASE26_LABELS = [f"cat{i}" for i in range(8)]  # cat's labels
# t = sum of PHASE26_WEIGHTS[d] * x_d + PHASE26_INTERCEPT + noise
PHASE26_WEIGHTS = [0.25 * (d + 1) * (-1) ** d for d in range(8)]
PHASE26_INTERCEPT = 0.5
PHASE26_KMEANS = {"n_clusters": 16, "n_init": 3, "max_iter": 20, "tol": 1e-4,
                  "random_state": 42}
# the legs on the host by nature (a function of the host stage, river's and
# sklearn's models on host arrays): cut from 1e8
PHASE26_HOST_ROWS = 10_000_000
PHASE26_SKLEARN_ROWS = 1_000_000
PHASE26_BATCH = 1_000_000
PHASE26_REPS = 3
PHASE26_PERCENTILE_SHAPE = 1024 * 16  # percentile_approx's count grid
# the kernels the phase must launch: the sums, means and counts (B1), the
# percentiles' count grid (B2), the scaler's stds (B4), the encoders' and
# the join's set probes (B6)
PHASE26_KERNELS = ("b1", "b2", "b4", "b6")


def phase26_columns(n, device, seed=SEED):
    """The table, made on ``device`` from ``seed``: x0..x7 float64 drawn
    around PHASE26_CENTRES centres uniform in [-10, 10]^8 (sd 1), key int64
    of PHASE26_K categories, cat the int32 codes of PHASE26_LABELS, y float64
    in {0, 1} (x0 + noise > 0), t float64 linear in x0..x7 plus noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(generator=gen, device=device, dtype=torch.float64)
    centres = torch.rand((PHASE26_CENTRES, len(PHASE26_FEATURES)), **f64) * 20.0 - 10.0
    which = torch.randint(0, PHASE26_CENTRES, (n,), generator=gen, device=device)
    cols = {f: centres[:, d].index_select(0, which) + torch.randn(n, **f64)
            for d, f in enumerate(PHASE26_FEATURES)}
    del which
    cols["key"] = torch.randint(0, PHASE26_K, (n,), generator=gen, device=device)
    cols["cat"] = torch.randint(0, len(PHASE26_LABELS), (n,), generator=gen, device=device,
                                dtype=torch.int32)
    cols["y"] = (cols["x0"] + torch.randn(n, **f64) > 0).to(torch.float64)
    t = torch.full((n,), PHASE26_INTERCEPT, device=device, dtype=torch.float64)
    for w, f in zip(PHASE26_WEIGHTS, PHASE26_FEATURES):
        t += w * cols[f]
    cols["t"] = t + 0.1 * torch.randn(n, **f64)
    return cols


def phase26_frame(vt, cols):
    """The frame over the tensors: cat a string column held as its int32
    codes on the card (no string is made per row), key categorized."""
    import pyarrow as pa
    from vaex_tpu_torch.column import ColumnDictionary
    columns = dict(cols)
    columns["cat"] = ColumnDictionary(cols["cat"], pa.array(PHASE26_LABELS), has_null=False)
    return vt.from_dataset(vt.DatasetArrays(columns)).categorize("key",
                                                                labels=range(PHASE26_K))


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _linear(names, weights, intercept):
    """The expression sum w * name + intercept, and its plain torch
    evaluation over ``values`` (a dict of tensors) in the same order."""
    expr = " + ".join(f"({w!r}) * {f}" for w, f in zip(weights, names)) + f" + {intercept!r}"

    def plain(values):
        acc = weights[0] * values[names[0]]
        for w, f in zip(weights[1:], names[1:]):
            acc = acc + w * values[f]
        return acc + intercept
    return expr, plain


def phase26_scaled(cols, mean, std):
    """The standard-scaled features [D, N] as the port's expressions compute
    them: (x - mean) / std with the fitted floats."""
    return torch.stack([(cols[f] - m) / s for f, m, s in zip(PHASE26_FEATURES, mean, std)])


def phase26_pca_column(S, means, vectors, i):
    """PCA_i in plain torch, in the order of the port's expression."""
    acc = None
    for j in range(S.shape[0]):
        term = float(vectors[j][i]) * (S[j] - float(means[j]))
        acc = term if acc is None else acc + term
    return acc


def phase26_init(S, kmeans):
    """KMeans's init rows, drawn as KMeans draws them: per run n_clusters of
    the first chunk_size rows by np.random.default_rng(random_state).choice."""
    rng = np.random.default_rng(kmeans["random_state"])
    rows = min(kmeans.get("chunk_size", 4_000_000), S.shape[1])
    picks = [rng.choice(rows, size=kmeans["n_clusters"], replace=False)
             for _ in range(kmeans["n_init"])]
    index = torch.as_tensor(np.concatenate(picks), device=S.device)
    return S.index_select(1, index).T.reshape(kmeans["n_init"], kmeans["n_clusters"], -1)


def phase26_lloyd(S, init, iterations, rows=1 << 21):
    """Lloyd's algorithm in plain torch from ``init`` [R, K, D] for
    ``iterations`` steps over S [D, N]: the scores ||c||^2 - 2 c.x by the
    port's formula and product (addmm), the first least, counts and sums by
    index_add_, an empty cluster keeping its centroid.  Returns (centroids,
    per iteration the inertia of each run, the last iteration's counts,
    sums and sums of |x|)."""
    C = init.clone()
    R, K, D = C.shape
    inertias = []
    for _ in range(iterations):
        flat = C.reshape(R * K, D)
        counts = torch.zeros((R, K), dtype=torch.int64, device=S.device)
        sums = torch.zeros((R, K, D), dtype=torch.float64, device=S.device)
        abs_sums = torch.zeros((R, K, D), dtype=torch.float64, device=S.device)
        inertia = torch.zeros(R, dtype=torch.float64, device=S.device)
        for a in range(0, S.shape[1], rows):
            X = S[:, a:a + rows]
            scores = torch.addmm((flat * flat).sum(1)[:, None], flat, X, alpha=-2.0)
            least, best = scores.view(R, K, -1).min(1)
            inertia += (least + (X * X).sum(0)).sum(1)
            for r in range(R):
                counts[r].index_add_(0, best[r], torch.ones_like(best[r]))
                sums[r].index_add_(0, best[r], X.T)
                abs_sums[r].index_add_(0, best[r], X.T.abs())
        C = torch.where(counts[:, :, None] > 0, sums / counts.clamp(min=1)[:, :, None], C)
        inertias.append(inertia)
    return C, inertias, counts, sums, abs_sums


def phase26_assign(C, S, rows=1 << 22):
    """The nearest of the centroids C [K, D] to each row of S [D, N] by
    -2 c.x + ||c||^2, the first on a tie."""
    c2 = (C * C).sum(1)[:, None]
    return torch.cat([torch.addmm(c2, C, S[:, a:a + rows], alpha=-2.0).argmin(0)
                      for a in range(0, S.shape[1], rows)])


def phase26_quantiles(x, percentages):
    """numpy's linear percentiles of x in plain torch: one sort."""
    xs = torch.sort(x).values
    out = []
    for p in percentages:
        pos = p / 100.0 * (xs.shape[0] - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, xs.shape[0] - 1)
        out.append(float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)))
    return out


# how phase26_check holds each value: "exact", "close" (RTOL and ATOL),
# ("bins", width) for a percentile against the count grid's bin width,
# ("centroids", bound) for a centroid against the plain one within its
# sums' bound (within_sum_bound's) over its count
def phase26_check(name, got, want):
    """Each value of one step against its plain torch answer, by the rule
    ``want`` gives it ({key: (value, rule)}); raises naming the step and
    the key where one disagrees."""
    for key, (value, rule) in want.items():
        check(key in got, f"phase 26 {name}: no {key}")
        g = got[key]
        if rule == "exact":
            ok = np.array_equal(np.asarray(g), np.asarray(value))
        elif rule == "close":
            ok = np.allclose(np.asarray(g, np.float64), np.asarray(value, np.float64),
                             rtol=RTOL, atol=ATOL)
        elif rule[0] == "bins":
            ok = _close(g, value, rule[1])
        elif rule[0] == "centroids":
            ok = _close(g, value, rule[1])
        else:
            raise KeyError(rule)
        check(ok, f"phase 26 {name}: {key} differs from plain torch: {g!r} vs {value!r}")


def _scaled_names():
    return [f"standard_scaled_{f}" for f in PHASE26_FEATURES]


def phase26_steps(vt, st):
    """The pipeline's steps in order: {name: (port, plain)}, each a
    function of the state ``st`` (the frame so far, the tensors, the fitted
    transformers), ``port`` returning (what it fitted, {key: value}),
    ``plain`` returning {key: (value, rule)} in plain torch."""
    cols, n = st["cols"], st["n"]
    F = PHASE26_FEATURES

    def scaler():
        t = vt.ml.StandardScaler(features=F).fit(st["df"])
        return t, {"mean": t.mean_, "std": t.std_}

    def scaler_plain():
        return {"mean": ([float(cols[f].mean()) for f in F], "close"),
                "std": ([float(cols[f].std(correction=0)) for f in F], "close")}

    def pca():
        t = vt.ml.PCA(features=_scaled_names(), n_components=3).fit(st["df"])
        V, lam = np.asarray(t.eigen_vectors_), np.asarray(t.eigen_values_)
        # the fit's covariance matrix, back from its eigenvectors and values
        return t, {"cov": (V * lam) @ V.T, "eigen_values": lam}

    def pca_plain():
        cov = torch.cov(st["S"], correction=0)
        lam = torch.linalg.eigvalsh(cov).flip(0)
        return {"cov": (_host(cov), "close"), "eigen_values": (_host(lam), "close")}

    def kmeans():
        km = vt.ml.KMeans(features=_scaled_names(), **PHASE26_KMEANS).fit(st["df"])
        return km, {"iterations": len(km.inertias_), "inertias": km.inertias_,
                    "inertia": km.inertia_, "centroids": np.asarray(km.cluster_centers_)}

    def kmeans_plain():
        km = st["kmeans"]
        iterations = len(km.inertias_)
        C, inertias, counts, sums, abs_sums = phase26_lloyd(
            st["S"], phase26_init(st["S"], PHASE26_KMEANS), iterations)
        best = int(torch.argmin(inertias[-1]))
        c = counts[best].to(torch.float64)[:, None].clamp(min=1)
        bound = (RTOL * sums[best].abs() + ATOL + c * 2.0 ** -52 * abs_sums[best]) / c
        st["plain_centroids"] = C[best]
        return {"iterations": (iterations, "exact"),
                "inertias": ([float(i.min()) for i in inertias], "close"),
                "inertia": (float(inertias[-1][best]), "close"),
                "centroids": (_host(C[best]), ("centroids", _host(bound)))}

    def predict():
        km = st["kmeans"]
        pred = torch.as_tensor(km.predict(st["df"]), device=st["S"].device)
        C = st["plain_centroids"]
        want = phase26_assign(C, st["S"])
        differ = torch.nonzero(pred != want).squeeze(1)
        ties = 0
        if differ.numel():
            X = st["S"][:, differ].T
            d_got = ((X - C[pred[differ]]) ** 2).sum(1)
            d_want = ((X - C[want[differ]]) ** 2).sum(1)
            tie = (d_got - d_want).abs() <= 1e-12 * d_want
            print(f"phase 26 predict: {differ.numel()} rows differ from the plain assignment; "
                  f"distances {list(zip(_host(d_got)[:5], _host(d_want)[:5]))}", flush=True)
            ties = int(tie.sum())
            pred[differ[tie]] = want[differ[tie]]
        st["assignment"] = want
        return pred, {"rows differing without a tie": int((pred != want).sum()),
                      "counts": _host(torch.bincount(pred, minlength=16)),
                      "ties": ties}

    def predict_plain():
        return {"rows differing without a tie": (0, "exact"),
                "counts": (_host(torch.bincount(st["assignment"], minlength=16)), "exact")}

    def scalers():
        df, x2 = st["df"], ["x0", "x1"]
        ts = [vt.ml.MinMaxScaler(features=x2), vt.ml.MaxAbsScaler(features=x2),
              vt.ml.RobustScaler(features=x2),
              vt.ml.KBinsDiscretizer(features=x2, n_bins=5, prefix="binned_uniform_"),
              vt.ml.KBinsDiscretizer(features=x2, n_bins=5, strategy="quantile",
                                     prefix="binned_quantile_")]
        for t in ts:
            t.fit(df)
        mm, ma, rb, ku, kq = ts
        return ts, {"min": mm.fmin_, "max": mm.fmax_, "absmax": ma.absmax_,
                    "center": rb.center_, "scale": rb.scale_,
                    "uniform": [ku.bin_edges_[f] for f in x2],
                    "quantile": [kq.bin_edges_[f] for f in x2]}

    def scalers_plain():
        x2 = ["x0", "x1"]
        lo, hi = zip(*[(float(cols[f].min()), float(cols[f].max())) for f in x2])
        width = np.asarray([(h - l) / PHASE26_PERCENTILE_SHAPE for l, h in zip(lo, hi)])
        q = [phase26_quantiles(cols[f], [25.0, 50.0, 75.0]) for f in x2]
        qs = [phase26_quantiles(cols[f], list(np.linspace(0, 100, 6))) for f in x2]
        return {"min": (list(lo), "exact"), "max": (list(hi), "exact"),
                "absmax": ([max(abs(l), abs(h)) for l, h in zip(lo, hi)], "exact"),
                "center": ([v[1] for v in q], ("bins", width)),
                "scale": ([v[2] - v[0] for v in q], ("bins", 2 * width)),
                "uniform": ([np.linspace(l, h, 6).tolist() for l, h in zip(lo, hi)], "exact"),
                "quantile": (qs, ("bins", width[:, None]))}

    def encoders():
        df = st["df"]
        le = vt.ml.LabelEncoder(features=["cat", "key"]).fit(df)
        oh = vt.ml.OneHotEncoder(features=["cat"]).fit(df)
        fe = vt.ml.FrequencyEncoder(features=["cat"]).fit(df)
        out = fe.transform(oh.transform(le.transform(df)))
        names = (["label_encoded_cat", "label_encoded_key"]
                 + [f"cat_{label}" for label in oh.uniques_["cat"]] + ["frequency_encoded_cat"])
        sums = out.sum(names)
        return (le, oh, fe), {
            "labels cat": le.labels_["cat"], "labels key": le.labels_["key"],
            "code sums": [int(s) for s in sums[:2]], "one-hot sums": [int(s) for s in sums[2:-1]],
            "frequencies": [fe.mappings_["cat"][label] for label in PHASE26_LABELS],
            "frequency sum": float(sums[-1])}

    def encoders_plain():
        labels = sorted(PHASE26_LABELS)
        ranks = torch.as_tensor(np.searchsorted(labels, PHASE26_LABELS), device=cols["cat"].device)
        keys = torch.arange(PHASE26_K, device=cols["key"].device)
        counts = torch.bincount(cols["cat"].long(), minlength=len(PHASE26_LABELS))
        freq = counts.to(torch.float64) / n
        by_label = {label: int(c) for label, c in zip(PHASE26_LABELS, _host(counts))}
        return {"labels cat": (labels, "exact"), "labels key": (list(range(PHASE26_K)), "exact"),
                "code sums": ([int(ranks[cols["cat"].long()].sum()),
                               int(torch.searchsorted(keys, cols["key"]).sum())], "exact"),
                "one-hot sums": ([by_label[label] for label in labels], "exact"),
                "frequencies": ([c / n for c in _host(counts).tolist()], "exact"),
                "frequency sum": (float(freq[cols["cat"].long()].sum()), "close")}

    def targets():
        df = st["df"]
        bte = vt.ml.BayesianTargetEncoder(features=["key"], target="y").fit(df)
        woe = vt.ml.WeightOfEvidenceEncoder(features=["key"], target="y").fit(df)
        gbt = vt.ml.GroupByTransformer(by="key", agg={"x0_mean": vt.agg.mean("x0")}).fit(df)
        out = woe.transform(bte.transform(df))
        joined = gbt.transform(out)
        sums = out.sum(["mean_encoded_key", "woe_encoded_key"])
        return (bte, woe, gbt), {
            "global mean": bte.global_mean_,
            "bayesian": [bte.mappings_["key"][k] for k in range(PHASE26_K)],
            "woe": [woe.mappings_["key"][k] for k in range(PHASE26_K)],
            "group means": gbt.df_group["x0_mean"].tolist(),
            "encoded sums": [float(s) for s in sums],
            "joined sum": float(joined.sum("x0_mean"))}

    def targets_plain():
        key, y, x0 = cols["key"], cols["y"], cols["x0"]
        count = torch.bincount(key, minlength=PHASE26_K).to(torch.float64)
        pos = torch.zeros(PHASE26_K, dtype=torch.float64, device=key.device).index_add_(0, key, y)
        xs = torch.zeros(PHASE26_K, dtype=torch.float64, device=key.device).index_add_(0, key, x0)
        g = float(y.mean())
        blended = (count * (pos / count) + 100 * g) / (count + 100)
        neg = count - pos
        woe = torch.log((pos / pos.sum().clamp(min=1)).clamp(min=1e-9)
                        / (neg / neg.sum().clamp(min=1)).clamp(min=1e-9))
        means = xs / count
        return {"global mean": (g, "close"), "bayesian": (_host(blended), "close"),
                "woe": (_host(woe), "close"), "group means": (_host(means), "close"),
                "encoded sums": ([float(blended[key].sum()), float(woe[key].sum())], "close"),
                "joined sum": (float(means[key].sum()), "close")}

    expr, linear_plain = _linear(F, PHASE26_WEIGHTS, PHASE26_INTERCEPT)

    def metrics():
        m = st["df"].ml.metrics
        yp = "PCA_0 > 0"
        return None, {
            "accuracy": m.accuracy_score("y", yp),
            "confusion": m.confusion_matrix("y", yp),
            "binary": list(m.precision_recall_fscore("y", yp)),
            "macro": list(m.precision_recall_fscore("y", yp, average="macro")),
            "mcc": m.matthews_correlation_coefficient("y", yp),
            "mae": m.mean_absolute_error("t", expr), "mse": m.mean_squared_error("t", expr),
            "r2": m.r2_score("t", expr)}

    def metrics_plain():
        y = cols["y"] > 0.5
        p = st["pca0"] > 0
        C = torch.stack([torch.stack([(~y & ~p).sum(), (~y & p).sum()]),
                         torch.stack([(y & ~p).sum(), (y & p).sum()])]).to(torch.float64)
        tp, fp, fn = C[1, 1], C[0, 1], C[1, 0]
        pr, rc = tp / (tp + fp), tp / (tp + fn)
        precision, recall = torch.diag(C) / C.sum(0), torch.diag(C) / C.sum(1)
        f1 = 2 * precision * recall / (precision + recall)
        t_sum, p_sum, total = C.sum(1), C.sum(0), C.sum()
        mcc = ((torch.trace(C) * total - t_sum @ p_sum)
               / torch.sqrt((total * total - t_sum @ t_sum) * (total * total - p_sum @ p_sum)))
        resid = cols["t"] - linear_plain(cols)
        ss_tot = ((cols["t"] - cols["t"].mean()) ** 2).sum()
        return {"accuracy": (float((y == p).to(torch.float64).mean()), "close"),
                "confusion": (_host(C).astype(np.int64), "exact"),
                "binary": ([float(pr), float(rc), float(2 * pr * rc / (pr + rc))], "close"),
                "macro": ([float(precision.mean()), float(recall.mean()), float(f1.mean())],
                          "close"),
                "mcc": (float(mcc), "close"), "mae": (float(resid.abs().mean()), "close"),
                "mse": (float((resid ** 2).mean()), "close"),
                "r2": (float(1 - (resid ** 2).sum() / ss_tot), "close")}

    return {"standard_scaler": (scaler, scaler_plain), "pca": (pca, pca_plain),
            "kmeans": (kmeans, kmeans_plain), "predict": (predict, predict_plain),
            "scalers": (scalers, scalers_plain), "encoders": (encoders, encoders_plain),
            "target encoders": (targets, targets_plain), "metrics": (metrics, metrics_plain)}


def _transformed(df, cols):
    """The columns a pipeline added to a frame over ``cols``."""
    return [c for c in df.get_column_names() if c not in cols and not c.startswith("__")]


def phase26_drive(vt, df, cols, n):
    """Every step once, in order, each checked against plain torch; then the
    state round trip.  Returns (the state, {step: (port, plain)}, {step:
    the port's answer})."""
    st = {"df": df, "cols": cols, "n": n}
    steps = phase26_steps(vt, st)
    answers = {}
    for name, (port, plain) in steps.items():
        fitted, got = port()
        if name == "standard_scaler":
            st["S"] = phase26_scaled(cols, fitted.mean_, fitted.std_)
            st["scaler"] = fitted
        elif name == "pca":
            st["pca"] = fitted
            st["pca0"] = phase26_pca_column(st["S"], fitted.means_, fitted.eigen_vectors_, 0)
        elif name == "kmeans":
            st["kmeans"] = fitted
        want = plain()
        phase26_check(name, got, want)
        answers[name] = got
        if name in ("standard_scaler", "pca"):
            st["df"] = fitted.transform(st["df"])
        elif name in ("scalers", "encoders"):
            for t in fitted:
                st["df"] = t.transform(st["df"])
        elif name == "target encoders":
            for t in fitted[:2]:
                st["df"] = t.transform(st["df"])
    names = _transformed(st["df"], cols)
    got = phase26_state(vt, st["df"], cols, names)
    phase26_check("state", got, {"sums": (list(_host(st["df"].sum(names))), "close")})
    answers["state"] = {"columns": len(names)}
    check(all(isinstance(t, torch.Tensor) and t.device.type == torch.device(
        cols["x0"].device).type for t in (df.dataset[f] for f in PHASE26_FEATURES)),
          "phase 26: a step moved the frame off its device")
    return st, steps, answers


def phase26_state(vt, df, cols, names):
    """The pipeline's frame state (every transformed column but KMeans's and
    the join's) put on a second frame over the same tensors: its columns'
    sums in one pass."""
    fresh = phase26_frame(vt, cols)
    fresh.state_set(df.state_get())
    return {"sums": list(_host(fresh.sum(names)))}


def phase26_host_legs(vt, st, n_host=PHASE26_HOST_ROWS, n_sklearn=PHASE26_SKLEARN_ROWS,
                      batch=PHASE26_BATCH):
    """The legs that run on the host by nature, cut to ``n_host`` rows: the
    KMeans transform column (a function of the host stage) counted by a
    groupby against predict's counts; RiverModel(OnlineSGDRegressor) in
    batches of ``batch`` rows, its predict against the same weights in
    plain torch; sklearn's LinearRegression through Predictor on
    ``n_sklearn`` rows, where sklearn is installed.  Returns ({leg: (port,
    plain)}, what is missing)."""
    import importlib.util
    df, S, km = st["df"], st["S"], st["kmeans"]
    small = df[:n_host]
    names = _scaled_names()
    legs, missing = {}, []

    def kmeans_column():
        out = km.transform(small).groupby("prediction_kmeans", agg={"n": "count"}, sort=True)
        counts = np.zeros(PHASE26_KMEANS["n_clusters"], np.int64)
        counts[np.asarray(out["prediction_kmeans"].tolist())] = out["n"].tolist()
        return {"counts": counts}

    def kmeans_plain():
        C = torch.as_tensor(np.asarray(km.cluster_centers_), device=S.device)
        return {"counts": (_host(torch.bincount(phase26_assign(C, S[:, :n_host]),
                                                minlength=PHASE26_KMEANS["n_clusters"])),
                           "exact")}
    legs["kmeans transform"] = (kmeans_column, kmeans_plain)

    river = vt.ml.RiverModel(model=vt.ml.OnlineSGDRegressor(), features=names, target="t",
                             batch_size=batch)
    river.fit(small)

    def river_port():
        return {"predict": river.predict(small)}

    def river_plain():
        w = torch.as_tensor(river.model.weights, device=S.device)
        return {"predict": (_host(S[:, :n_host].T @ w + river.model.intercept), "close")}
    legs["river predict"] = (river_port, river_plain)

    if importlib.util.find_spec("sklearn") is None:
        missing.append("sklearn")
    else:
        from sklearn.linear_model import LinearRegression
        part = df[:n_sklearn]
        predictor = vt.ml.Predictor(model=LinearRegression(), features=names, target="t")
        predictor.fit(part)

        def sklearn_port():
            return {"predict": np.asarray(predictor.transform(part).evaluate("prediction"))}

        def sklearn_plain():
            coef = torch.as_tensor(predictor.model.coef_, device=S.device)
            return {"predict": (_host(S[:, :n_sklearn].T @ coef + predictor.model.intercept_),
                                "close")}
        legs["sklearn predict"] = (sklearn_port, sklearn_plain)
    for name, (port, plain) in legs.items():
        phase26_check(name, port(), plain())
    return legs, missing


def phase26_time(steps, reps=PHASE26_REPS):
    """{step: {"port_ms", "plain_ms"}}: medians of ``reps`` runs (host clock,
    each ended by a synchronize of the card) of each step's port and plain
    torch functions."""
    return {name: {"port_ms": _median_ms(lambda: port(), reps),
                   "plain_ms": _median_ms(lambda: plain(), reps)}
            for name, (port, plain) in steps.items()}


def phase26_path(vt, plan, gp, probe, label, n=PHASE26_ROWS):
    """Phase 26 on the card: the table made on cuda:0, the pipeline driven
    once with the kernel counts set to 0 and each step checked, B1, B2, B4
    and B6 asserted launched; then each step timed against plain torch,
    KMeans's fit asserted to give the same bits each time, and the host
    legs at PHASE26_HOST_ROWS.  Returns (launches, the phase's JSON
    record)."""
    from vaex_tpu_torch import cache
    t_phase = time.perf_counter()
    cols = phase26_columns(n, "cuda")
    df = phase26_frame(vt, cols)
    torch.cuda.synchronize()
    with cache.off():  # every step runs its passes
        zero_launches(plan, gp)
        probe.probe.launches = probe.probe.wide_launches = 0
        st, steps, answers = phase26_drive(vt, df, cols, n)
        torch.cuda.synchronize()
        launches = {**launch_counts(plan, gp), "b6": probe.probe.launches,
                    "b6-wide": probe.probe.wide_launches}
        print(f"launches during phase 26: {launches}", flush=True)
        for name in PHASE26_KERNELS:
            check(launches[name] > 0, f"{name} was not launched during phase 26: {launches}")
        km = answers["kmeans"]
        print(f"[{label}] phase 26 N={n}: {len(answers)} steps equal plain torch; KMeans "
              f"{km['iterations']} iterations, inertia {km['inertia']!r}; "
              f"{answers['predict']['ties']} predicted rows on a tie; "
              f"{answers['state']['columns']} columns through the state", flush=True)
        centres = []
        steps["kmeans"] = (lambda: centres.append(vt.ml.KMeans(
            features=_scaled_names(), **PHASE26_KMEANS).fit(st["df"]).cluster_centers_),
            steps["kmeans"][1])
        times = phase26_time({k: v for k, v in steps.items() if k != "predict"})
        check(all(c == km["centroids"].tolist() for c in centres),
              "phase 26: KMeans's fits gave different centroids")
        times["kmeans"]["iterations"] = km["iterations"]
        times["kmeans"]["port_ms_per_iteration"] = times["kmeans"]["port_ms"] / km["iterations"]
        times["kmeans"]["plain_ms_per_iteration"] = times["kmeans"]["plain_ms"] / km["iterations"]
        times["predict"] = {"port_ms": _median_ms(lambda: st["kmeans"].predict(st["df"]),
                                                  PHASE26_REPS),
                            "plain_ms": _median_ms(lambda: phase26_assign(
                                st["plain_centroids"], st["S"]).cpu(), PHASE26_REPS)}
        legs, missing = phase26_host_legs(vt, st)
        times.update({f"{name} (N={PHASE26_HOST_ROWS if name != 'sklearn predict' else PHASE26_SKLEARN_ROWS})": t
                      for name, t in phase26_time(legs).items()})
    for name in missing:
        print(f"[{label}] phase 26 {name}: not installed: {name}", flush=True)
    for name, t in times.items():
        print(f"[{label}] phase 26 {name}: port {t['port_ms']!r} ms, plain torch "
              f"{t['plain_ms']!r} ms", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[{label}] phase 26 took {phase_s:.1f} s", flush=True)
    record = {"card": label, "rows": n, "host_rows": PHASE26_HOST_ROWS,
              "sklearn_rows": PHASE26_SKLEARN_ROWS,
              "bytes": sum(c.element_size() * c.numel() for c in cols.values()),
              "steps": times, "kmeans_iterations": km["iterations"],
              "predict_ties": answers["predict"]["ties"], "missing": missing,
              "launches": launches, "phase_s": phase_s}
    del df, cols, st, steps
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record


def profile_phases(vt, phases, label):
    """The device busy and idle share of each query of phases 20-23 and of
    each step of phase 26 (``python3 chip_smoke.py --profile 20 21 22 23
    26``): the phase's tables made as the phase makes them, each query
    through scripts/profile_torch_groupby.py's ``profile`` (two warm-ups,
    then 5 runs under torch.profiler, each ended by a synchronize), the
    result cache off but for phase 22's two hits."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from profile_torch_groupby import profile as profile_on_the_card
    from vaex_tpu_torch import cache

    def profile(name, query):
        try:
            profile_on_the_card(name, query)
        except RuntimeError as e:  # a query of the host alone: the card idles
            if "no device activity" not in str(e):
                raise
            print(f"{name}: no device activity (the query runs on the host), idle share 1.0",
                  flush=True)
    print(f"profiling phases {phases} on {label}", flush=True)
    if 20 in phases:
        cols = phase20_columns(PHASE20_ROWS, "cuda")
        df = phase20_frame(vt, cols)
        with cache.off():
            for name, query in phase20_queries(vt).items():
                profile(f"phase 20 {name} N={PHASE20_ROWS}", lambda: query(df))
        del df, cols
    if 21 in phases:
        host, _, _ = phase21_columns(PHASE21_ROWS)
        df = vt.from_arrays(**host).to_device("cuda")
        s_host, _, s_labels = phase21_strings_columns(PHASE21_ROWS)
        s_df = vt.from_arrays(**s_host).to_device("cuda")
        h_host, _, h_labels = phase21_strings_columns(PHASE21_HOST_ROWS)
        h_df = vt.from_arrays(**h_host)
        d_df = vt.from_arrays(**phase21_datetimes(PHASE21_HOST_ROWS)).to_device("cuda")
        questions = config3_questions(vt)
        with cache.off():
            for q in PHASE21_QUESTIONS:
                profile(f"phase 21 {q} N={PHASE21_ROWS}", lambda: questions[q](df))
            for name, query in phase21_string_queries(s_labels).items():
                profile(f"phase 21 {name} N={PHASE21_ROWS}", lambda: query(s_df))
            for name in ("groupby_str_sum", "isin_str_500"):
                query = phase21_string_queries(h_labels)[name]
                profile(f"phase 21 {name} (unstaged) N={PHASE21_HOST_ROWS}", lambda: query(h_df))
            for name, query in phase21_datetime_queries(vt).items():
                profile(f"phase 21 {name} N={PHASE21_HOST_ROWS}", lambda: query(d_df))
        del df, s_df, h_df, d_df
    if 22 in phases:
        n, n_host = PHASE22_ROWS, PHASE22_HOST_ROWS
        h2o_df, h2o_cols = make_h2o(vt)
        del h2o_df
        sets_df, _, values = make_sets_table(vt, h2o_cols)
        set_query = sets_queries(vt, values)["set k1e6"]
        with cache.memory():
            profile(f"phase 22 cache hit set k1e6 N={n}", lambda: set_query(sets_df))
        cache.clear()
        del sets_df, h2o_cols
        df3 = vt.from_dataset(vt.DatasetArrays(config3_columns(CONFIG3_ROWS, "cuda")))
        q10 = config3_questions(vt)["q10"]
        with cache.memory():
            profile(f"phase 22 cache hit q10 N={CONFIG3_ROWS}", lambda: q10(df3))
        cache.clear()
        del df3
        gc.collect()
        torch.cuda.empty_cache()
        df1, i1, x1 = make_table(n, vt)
        df1._tile_rows = PHASE22_TILE_ROWS
        colsu = phase22_udf_columns(n_host, "cuda")
        tables = {"df2": config2_frame(vt, config2_columns(n, "cuda")).categorize(
                      "i", labels=range(1000)),
                  "df1": df1, "i1": i1, "x1": x1, "colsu": colsu,
                  "dfu": phase22_udf_frame(vt, colsu),
                  "dfm": phase22_udf_frame(vt, colsu, multiprocessing=True),
                  "dfp": phase22_pickle_frame(vt, colsu, "cuda"),
                  "dfa": phase22_a14_frame(vt, phase20_columns(n, "cuda"))}
        with cache.off():
            for name, (query, _) in phase22_queries(vt, tables).items():
                rows = n_host if name in PHASE22_HOST_QUERIES else n
                profile(f"phase 22 {name} N={rows}", query)
        from vaex_tpu_torch import multiprocessing as port_mp
        port_mp.close_pool()
    if 26 in phases:
        cols = phase26_columns(PHASE26_ROWS, "cuda")
        df = phase26_frame(vt, cols)
        with cache.off():
            st, steps, _ = phase26_drive(vt, df, cols, PHASE26_ROWS)
            for name, (port, _) in steps.items():
                if name != "predict":
                    profile(f"phase 26 {name} N={PHASE26_ROWS}", port)
            profile(f"phase 26 predict N={PHASE26_ROWS}", lambda: st["kmeans"].predict(st["df"]))
            legs, _ = phase26_host_legs(vt, st)
            for name, (port, _) in legs.items():
                profile(f"phase 26 {name} N={PHASE26_HOST_ROWS}", port)
        del df, cols, st, steps, legs
        gc.collect()
        torch.cuda.empty_cache()
    if 23 in phases:
        import importlib.util
        import shutil
        import tempfile
        tmp = tempfile.mkdtemp(prefix="phase23-", dir=tempfile.gettempdir())
        try:
            staged, _, _ = make_table(PHASE23_ROWS, vt)
            ext = "hdf5" if importlib.util.find_spec("h5py") else "arrow"
            path = os.path.join(tmp, f"config1.{ext}")
            staged.export(path)
            fdf = vt.open(path).categorize("i1", labels=range(K))
            run_query(fdf, vt)  # the first pass builds i1's proof
            profile(f"phase 23 config 1 groupby streamed from {ext} N={PHASE23_ROWS}",
                    lambda: run_query(fdf, vt))
            with phase23_synchronous():
                profile(f"phase 23 config 1 groupby synchronous from {ext} N={PHASE23_ROWS}",
                        lambda: run_query(fdf, vt))
            profile(f"phase 23 config 1 groupby staged N={PHASE23_ROWS}",
                    lambda: run_query(staged, vt))
            del fdf, staged
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


PHASE27_ROWS = 100_000_000
PHASE27_G2 = 10_607  # a key whose groups put corr on B5 (G = 10 609 with the edges)
PHASE27_RTOL = 1e-6  # the float contract, against plain torch over the centred data


def phase27_columns(n, device, seed=SEED):
    """Config 1's key i1 in [0, K) and value x, and at the same rows y =
    N(0, 1) + 1e8, z = y / 2 + N(0, 1) + 1e6 (float64), x62 = 2^62 + [0, 8)
    (int64), g a key in [0, 103) and g2 one in [0, PHASE27_G2)."""
    gen = torch.Generator(device=device).manual_seed(seed + 27)
    e = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    return {"i1": torch.randint(0, K, (n,), generator=gen, device=device),
            "x": torch.rand(n, generator=gen, device=device, dtype=torch.float64),
            "y": e + 1e8,
            "z": e / 2 + torch.randn(n, generator=gen, device=device, dtype=torch.float64)
            + 1e6,
            "x62": torch.randint(0, 8, (n,), generator=gen, device=device) + 2 ** 62,
            "g": torch.randint(0, 103, (n,), generator=gen, device=device),
            "g2": torch.randint(0, PHASE27_G2, (n,), generator=gen, device=device)}


def phase27_frame(vt, cols):
    return vt.from_dataset(vt.DatasetArrays(cols))


def phase27_check(name, got, want, rtol=PHASE27_RTOL):
    """``got`` equal to ``want`` (both float arrays, NaN alike) within
    ``rtol`` relative, or exactly (rtol 0)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    same = (got.shape == want.shape and bool(np.all((np.abs(got - want) <= rtol * np.abs(want))
                                                    | (np.isnan(got) & np.isnan(want)))))
    check(same, f"phase 27 {name}: {got.ravel()[:4]} against {want.ravel()[:4]}")


def phase27_plain(cols):
    """The answers of :func:`phase27_drive` in plain torch over the centred
    data (y - 1e8, z - 1e6 and x62 - 2^62 are exact), sharing no code with
    the port; per group of g2 NaN where a group has no row."""
    cy, cz = cols["y"] - 1e8, cols["z"] - 1e6
    c62 = (cols["x62"] - 2 ** 62).to(torch.float64)
    n, g, g2 = cols["y"].shape[0], cols["g"], cols["g2"]

    def sums(key, G, values):
        return torch.zeros(G, dtype=torch.float64, device=key.device).index_add_(0, key, values)
    cnt = torch.bincount(g, minlength=103).to(torch.float64)
    mean_y = sums(g, 103, cy) / cnt
    n2 = torch.bincount(g2, minlength=PHASE27_G2).to(torch.float64)
    a, b = sums(g2, PHASE27_G2, cy) / n2, sums(g2, PHASE27_G2, cz) / n2
    cov2 = sums(g2, PHASE27_G2, cy * cz) / n2 - a * b
    var_a = sums(g2, PHASE27_G2, cy * cy) / n2 - a * a
    var_b = sums(g2, PHASE27_G2, cz * cz) / n2 - b * b
    return {
        "unique": torch.unique(cols["i1"]).tolist(),
        "mean x62": float(cols["x62"].to(torch.float64).sum()) / n,
        "mean x62 by g": (sums(g, 103, cols["x62"].to(torch.float64)) / cnt).cpu().numpy(),
        "std x62": float(c62.std(unbiased=False)),
        "std y": float(cy.std(unbiased=False)),
        "std y by g": torch.sqrt(sums(g, 103, cy * cy) / cnt - mean_y ** 2).cpu().numpy(),
        "corr by g2": (cov2 / torch.sqrt(var_a * var_b)).cpu().numpy(),
        "cov": torch.cov(torch.stack([cy, cz]), correction=0).cpu().numpy(),
    }


def phase27_drive(vt, df, cols, write=True):
    """C17-C19 through the public API: the unique of i1 before and after a
    write through ``.data`` (which bumps no version counter), the mean of
    x62 (2^62 + [0, 8)) on the frame, binned by g and per group, its std
    (exact: within 1e-6 of the centred data's), the std of y (1e8 away from
    zero) on the frame and binned (B4), corr(y, z) per group of g2 (B5) and
    cov([y, z]), each checked against plain torch over the centred data.
    Returns the strategies the moments took."""
    from vaex_tpu_torch import cache
    with cache.memory():
        before = df.unique("i1")
        check(before == torch.unique(cols["i1"]).tolist(), "phase 27 unique before the write")
        if write:
            cols["i1"].data[5] = K + 7  # no version bump
        got = df.unique("i1")
    want = phase27_plain(cols)
    check(got == want["unique"] and (K + 7 in got) == write,
          f"phase 27 unique after a write through .data: {got[-3:]}")
    limits = {"binby": "g", "limits": [-0.5, 102.5], "shape": 103}
    phase27_check("mean x62", df.mean("x62"), want["mean x62"], 1e-12)
    phase27_check("mean x62 by g", df.mean("x62", **limits), want["mean x62 by g"], 1e-12)
    out = df.groupby("g", agg={"m": vt.agg.mean("x62")}, sort=True)
    phase27_check("mean x62 per group", out["m"].values,
                  want["mean x62 by g"][np.asarray(out["g"].values)], 1e-12)
    phase27_check("std x62", df.std("x62"), want["std x62"])
    phase27_check("std y", df.std("y"), want["std y"])
    phase27_check("std y by g", df.std("y", **limits), want["std y by g"])
    def last_strategies():  # of the last pass's aggregation tasks, merged
        return {k: v for task in df.executor.trace_log[-1]["strategies"] for k, v in task.items()}
    strategies = {"std by g": last_strategies()}
    out = df.groupby("g2", agg={"r": vt.agg.corr("y", "z")}, sort=True)
    strategies["corr by g2"] = last_strategies()
    phase27_check("corr by g2", out["r"].values,
                  want["corr by g2"][np.asarray(out["g2"].values)])
    phase27_check("cov", df.cov(["y", "z"]), want["cov"])
    return strategies


class phase27_old_channels:
    """The channels before shifted moments and float64 means, for timing
    beside them: no shift (the kernels' null pointer) and an int mean's
    sum as int64."""

    def __enter__(self):
        from vaex_tpu_torch import agg, tasks
        self.saved = tasks.moment_shift, agg.OpSumFloat
        tasks.moment_shift = lambda df, expression: None
        agg.OpSumFloat = agg.OpSum
        return self

    def __exit__(self, *exc):
        from vaex_tpu_torch import agg, tasks
        tasks.moment_shift, agg.OpSumFloat = self.saved


def phase27_turns(query):
    """Median seconds of ``query`` with the new channels and with the old
    ones (:class:`phase27_old_channels`), in turns new, old, old, new:
    (new, old)."""
    times = {"new": [], "old": []}
    for which in ("new", "old", "old", "new"):
        if which == "old":
            with phase27_old_channels():
                times[which] += median_s(query)[1]
        else:
            times[which] += median_s(query)[1]
    return statistics.median(times["new"]), statistics.median(times["old"])


def phase27_path(vt, plan, gp, probe, label, n=PHASE27_ROWS):
    """Phase 27 on the card: :func:`phase27_drive` once at ``n`` rows with
    the kernel counts set to 0 (B4 and B5 asserted launched, the std by g on
    B4 and the corr by g2 on B5), then, in one call, B4 (var, G = 103) and
    B5 (corr, G = 10 609) shifted beside unshifted, and ``df.std``, config
    2's group and H2O q4 (its int means) beside the old channels, in turns;
    the repeated unique of config 1's key with the cache on.  Returns
    (launches, the phase's JSON record)."""
    from vaex_tpu_torch import agg, cache
    from vaex_tpu_torch.ops import grid_moments as gm
    record = {"card": label, "rows": n}
    cols = phase27_columns(n, "cuda")
    df = phase27_frame(vt, cols)
    zero_launches(plan, gp)
    probe.probe.launches = probe.probe.wide_launches = 0
    record["strategies"] = phase27_drive(vt, df, cols)
    launches = {**launch_counts(plan, gp), "b6": probe.probe.launches,
                "b6-wide": probe.probe.wide_launches}
    check(launches[plan.B4] > 0 and launches[plan.B5] > 0,
          f"phase 27: B4 and B5 launched {launches}")
    check(record["strategies"]["std by g"].get("moments") == plan.B4
          and record["strategies"]["corr by g2"].get("moments") == plan.B5,
          f"phase 27 strategies {record['strategies']}")
    print(f"phase 27 N={n}: unique after a .data write, int means, std / corr / cov far from "
          f"zero equal plain torch over the centred data; launches {launches}", flush=True)

    g = cols["g"].to(torch.int32)
    g2 = (cols["g2"] + 1).to(torch.int32)
    # each base's shift on the card, as a pass hands it over (first_valid)
    kernels = {"b4 var G=103": (gm.grid_moments, g, [cols["y"]], agg.VAR_TERMS, 103),
               "b5 corr G=10609": (gm.grid_moments_window, g2, [cols["y"], cols["z"]],
                                   agg.CORR_TERMS, PHASE27_G2 + 2)}
    record["kernels"] = {}
    for name, (kernel, idx, bases, terms, G) in kernels.items():
        shift = first_valid(bases)
        shifted = unshifted = 0.0
        for turn in range(4):  # shifted, unshifted, unshifted, shifted
            if turn in (0, 3):
                shifted += cuda_ms(lambda: kernel(idx, bases, terms, G, shift), 5) / 2
            else:
                unshifted += cuda_ms(lambda: kernel(idx, bases, terms, G), 5) / 2
        record["kernels"][name] = {"shifted_ms": shifted, "unshifted_ms": unshifted}
        print(f"[{label}] phase 27 {name} N={n}: shifted {shifted!r} ms, unshifted (null "
              f"pointer) {unshifted!r} ms", flush=True)
    del g, g2

    with cache.off():
        queries = {"df.std(y)": (df, lambda: df.std("y"))}
        cols2 = config2_columns(n, "cuda")
        df2 = config2_frame(vt, cols2)
        queries["config 2 group"] = (df2, lambda: config2_group(df2))
        cols3 = config3_columns(CONFIG3_ROWS, "cuda")
        df3 = vt.from_dataset(vt.DatasetArrays(cols3))
        q4 = config3_questions(vt)["q4"]
        queries["H2O q4"] = (df3, lambda: q4(df3))
        # q4's B1 call with v1 and v2 as int channels (the old int64 sums)
        # beside int64-kind float channels (the new float64 sums), in turns
        from vaex_tpu_torch.ops import grid_additive as ga
        idx4 = cols3["id4"].to(torch.int32)
        ints, three = [cols3["v1"], cols3["v2"]], [cols3["v1"], cols3["v2"], cols3["v3"]]
        b1 = {"int channels": 0.0, "float channels": 0.0}
        for turn in range(4):
            if turn in (0, 3):
                b1["float channels"] += cuda_ms(
                    lambda: ga.grid_additive(idx4, [], three, 103, True), 5) / 2
            else:
                b1["int channels"] += cuda_ms(
                    lambda: ga.grid_additive(idx4, ints, three[2:], 103, True), 5) / 2
        record["kernels"]["b1 q4 channels"] = b1
        print(f"[{label}] phase 27 B1 at q4's shape N={CONFIG3_ROWS}: v1, v2 as int64 "
              f"channels {b1['int channels']!r} ms, as int64-kind float channels "
              f"{b1['float channels']!r} ms", flush=True)
        del idx4, ints, three
        record["queries"] = {}
        for name, (_, query) in queries.items():
            new_s, old_s = phase27_turns(query)
            record["queries"][name] = {"new_ms": new_s * 1e3, "old_ms": old_s * 1e3}
            print(f"[{label}] phase 27 {name}: shifted moments / float64 means {new_s * 1e3!r} "
                  f"ms, the old channels {old_s * 1e3!r} ms (medians of {REPS}, in turns)",
                  flush=True)
        del queries, df2, cols2, df3, cols3
    with cache.memory():
        repeat_s, _ = median_s(lambda: df.unique("i1"))
    record["unique_repeat_ms"] = repeat_s * 1e3
    print(f"[{label}] phase 27 unique(i1) N={n} repeated with the cache on (a card tensor: "
          f"its pass each time): {repeat_s * 1e3!r} ms", flush=True)
    del df, cols
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record


# phase 28: BASELINE config 5 across processes: two processes on one card,
# each holding its hash-partitioned half of config 3's and config 4's tables
# and driving two shards of it, the mesh of four spanning both over gloo
PHASE28_SHARDS = 2  # a process; the global mesh has 4
PHASE28_ROWS = 100_000_000  # config 3's H2O table in all: cut from config 5's 1e9
PHASE28_FACT = 100_000_000  # config 4's fact table: cut from 1e9 (slack 4's buffers)
PHASE28_DIM = 10_000_000
PHASE28_REPS = 3
PHASE28_TIMEOUT = 600  # seconds: the workers, and each collective's wait
PHASE28_QUERIES = ("q3", "q7", "q10", "J1 left", "J1 inner", "J3")
# the trace entry each query's exchange leaves, with world 2
PHASE28_ROUTES = {"q3": "shuffle", "q7": "shuffle", "q10": "fused_mesh_groupby",
                  "J1 left": "join", "J1 inner": "join", "J3": "mesh"}
PHASE28_KERNELS = (("b3", "b3-l2"), ("b6", "b6-wide"))
PHASE28_WORKER = r'''
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.phase28_worker(*sys.argv[2:])
'''


def phase28_own(n, rank, device):
    """The rows a process keeps: those whose row number hashes (murmur3's
    finalizer) to its rank, so that no key is co-located."""
    from vaex_tpu_torch.parallel.join import _mix64
    return (_mix64(torch.arange(n, device=device, dtype=torch.int64)) & 1) == rank


def phase28_frames(vt, device, n, n_fact, n_dim):
    """Config 3's H2O table (raw keys) and config 4's fact and dim tables,
    whole, made on ``device`` from seed 42: their single-device frames and
    the tensors."""
    h2o = config3_columns(n, device)
    fact, dim, _ = config4_tables(n_fact, n_dim, device)
    return {"c3": vt.from_dataset(vt.DatasetArrays(dict(h2o))),
            "fact": vt.from_dataset(vt.DatasetArrays(dict(fact))),
            "dim": vt.from_dataset(vt.DatasetArrays(dict(dim))),
            "cols": {**h2o, "fact_x": fact["x"], "fact_key": fact["key"], "label": dim["label"]}}


def phase28_query(vt, name, frames):
    """Query ``name`` over ``frames`` (c3, fact, dim; J3 reads "joined")."""
    h2o = config3_questions(vt)
    if name in ("q3", "q7", "q10"):
        return h2o[name](frames["c3"])
    if name == "J1 left":
        return frames["fact"].join(frames["dim"], on="key")
    if name == "J1 inner":
        return frames["fact"].join(frames["dim"], on="key", how="inner")
    return frames["joined"].groupby("label", agg={"x": "sum", "n": "count"})


def phase28_joined(joined):
    """A join's rows as tensors: the fact key and x, the label and its mask
    (None: every row matched)."""
    n = len(joined)
    label = joined._evaluate_tile("label", 0, n)
    return {"key": joined._evaluate_tile("key", 0, n).data,
            "x": joined._evaluate_tile("x", 0, n).data, "label": label.data,
            "mask": None if label.mask is None or not bool(label.mask.any()) else label.mask}


def phase28_join_want(single, own):
    """The single-device join of the whole tables cut to this process's left
    rows: how="left" keeps them all, "inner" the matched ones."""
    want = {k: None if v is None else v[own] for k, v in single.items()}
    if want["mask"] is None or not bool(want["mask"].any()):
        want["mask"] = None
    return want


def phase28_check_join(name, got, want):
    """A join's rows against the single-device join's, row for row: the
    fact key and x, the label and the mask of the unmatched rows exactly;
    "inner" keeps the matched rows alone."""
    if name == "J1 inner" and want["mask"] is not None:
        keep = ~want["mask"]
        want = {"key": want["key"][keep], "x": want["x"][keep], "label": want["label"][keep],
                "mask": None}
    check(got["key"].shape == want["key"].shape,
          f"phase 28 {name}: {got['key'].shape[0]} rows against {want['key'].shape[0]}")
    check((got["mask"] is None) == (want["mask"] is None)
          and (got["mask"] is None or torch.equal(got["mask"], want["mask"])),
          f"phase 28 {name}: the unmatched rows differ")
    keep = slice(None) if want["mask"] is None else ~want["mask"]
    for column in ("key", "x", "label"):
        check(torch.equal(got[column][keep], want[column][keep]),
              f"phase 28 {name} {column}: the rows differ from the single device's")


def port_collectives(device):
    """Each collective of the port (:mod:`vaex_tpu_torch.parallel.collectives`)
    across the two processes of the default group on ``device``'s tensors,
    two shards a process, its answer checked: {name: "ok" or what went
    wrong}.  Under gloo a CUDA tensor crosses through host memory."""
    from vaex_tpu_torch.parallel import collectives, data_mesh
    mesh = data_mesh(devices=[device] * PHASE28_SHARDS)
    r, d = mesh.rank, len(mesh.devices)
    parts = [torch.arange(4, device=device, dtype=torch.int64) + r * d + i for i in range(d)]
    want_sum = sum(torch.arange(4) + s for s in range(mesh.size))
    cases = {
        "reduce": lambda: torch.equal(collectives.reduce(parts, "sum", mesh).cpu(), want_sum),
        "total": lambda: collectives.total([r * d + i for i in range(d)], mesh)
        == sum(range(mesh.size)),
        "extreme": lambda: collectives.extreme([r * d + i for i in range(d)], "max", mesh)
        == mesh.size - 1,
        "gather": lambda: [t.shape[0] for t in collectives.gather(
            [torch.ones(r * d + i, device=device) for i in range(d)], mesh)]
        == list(range(mesh.size)),
        "objects": lambda: collectives.objects(r, mesh) == list(range(mesh.world)),
        "broadcast": lambda: int(collectives.broadcast(
            torch.tensor(r + 7, device=device), mesh)) == 7,
        "all_to_all": lambda: all(torch.equal(
            recv.cpu(), torch.arange(mesh.size) * 100 + r * d + j)
            for j, recv in enumerate(collectives.all_to_all(
                [torch.arange(mesh.size, device=device) + (r * d + i) * 100 for i in range(d)],
                mesh))),
    }
    tried = {}
    for name, call in cases.items():
        try:
            tried[name] = "ok" if call() else "a wrong answer"
        except Exception as e:  # recorded: the verdict refuses the phase
            tried[name] = f"{type(e).__name__}: {str(e)[:160]}"
    return tried


def _phase28_timed(fn, reps, across=False, warm=True):
    """Median ms of ``reps`` runs after a warm-up (``warm``: one ran just
    before); ``across``: each run the wall of the slower process (the
    processes start it together)."""
    import torch.distributed as dist
    times = []
    for rep in range(int(warm), reps + 1):
        if across:
            dist.barrier()
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        dt = torch.tensor([(time.perf_counter() - t0) * 1e3], dtype=torch.float64)
        if across:
            dist.all_reduce(dt, op=dist.ReduceOp.MAX)
        if rep:
            times.append(float(dt))
    return statistics.median(times)


def phase28_worker(rank, store, n, n_fact, n_dim, device, reps):
    """One process of phase 28: the whole tables and their single-device
    answers (rank 0 also times them, and the four shards of phase 24 in one
    process), then its own half over the mesh of both processes, each
    query checked, its route and the launches read, then timed.  Prints
    its record as ``RESULT {json}``."""
    import datetime
    import torch.distributed as dist
    import vaex_tpu_torch as vt
    from vaex_tpu_torch import cache
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_plan as plan
    from vaex_tpu_torch.ops import probe
    from vaex_tpu_torch.parallel import distributed_executor
    from vaex_tpu_torch.parallel.mesh import Mesh
    rank, n, n_fact, n_dim, reps = (int(v) for v in (rank, n, n_fact, n_dim, reps))
    # gloo: NCCL refuses two ranks on one card
    dist.init_process_group("gloo", init_method="file://" + store, world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=PHASE28_TIMEOUT))
    record = {"rank": rank, "collectives": port_collectives(device), "queries": {}}
    if any(v != "ok" for v in record["collectives"].values()):
        print("RESULT " + json.dumps(record), flush=True)
        dist.barrier()
        dist.destroy_process_group()
        os._exit(0)
    t0 = time.perf_counter()

    def progress(what):
        print(f"rank {rank}: {what} at {time.perf_counter() - t0:.1f} s", flush=True)
    with cache.off():
        frames = phase28_frames(vt, device, n, n_fact, n_dim)
        progress("tables made")
        wants = {}
        for name in PHASE28_QUERIES:
            if name == "J1 inner":  # held to the left join's matched rows
                continue
            out = phase28_query(vt, name, frames)
            if name == "J1 left":
                frames["joined"] = out
            wants[name] = phase28_joined(out) if name == "J1 left" else phase24_answer(out)
        scales = {name: phase24_scales(frames["cols"], name, n) for name in ("q3", "q7", "q10")}
        progress("single-device answers")
        if rank == 0 and reps:
            four = {k: phase24_sharded(frames[k], Mesh([device] * 4)) for k in ("c3", "fact")}
            four["dim"] = frames["dim"]
            four["joined"] = phase28_query(vt, "J1 left", four)
            for name in PHASE28_QUERIES:
                record["queries"][name] = {
                    "single_ms": _phase28_timed(lambda: phase28_query(vt, name, frames), reps),
                    "four_shards_ms": _phase28_timed(lambda: phase28_query(vt, name, four), reps)}
            del four
            progress("single device and four shards timed")
        own_fact = phase28_own(n_fact, rank, device)
        wants["J1 left"] = wants["J1 inner"] = phase28_join_want(wants["J1 left"], own_fact)
        own = phase28_own(n, rank, device)
        own_dim = phase28_own(n_dim, rank, device)
        cols = frames["cols"]
        halves = {"c3": {k: cols[k][own] for k in (*CONFIG3_KEYS, "v1", "v2", "v3")},
                  "fact": {"key": cols["fact_key"][own_fact], "x": cols["fact_x"][own_fact]},
                  "dim": {"key": frames["dim"].dataset["key"][own_dim],
                          "label": cols["label"][own_dim]}}
        del frames, cols, own, own_fact, own_dim
        gc.collect()
        _empty_cache()
        mine = {}
        for k, columns in halves.items():
            mine[k] = vt.from_dataset(vt.DatasetArrays(columns))
            mine[k].executor = distributed_executor(devices=[device] * PHASE28_SHARDS)
        dist.barrier()
        record["setup_s"] = time.perf_counter() - t0
        progress("own rows staged")
        zero_launches(plan, gp)
        probe.probe.launches = probe.probe.wide_launches = 0
        for name in PHASE28_QUERIES:
            frame = mine["joined" if name == "J3" else ("fact" if name.startswith("J1") else "c3")]
            log = frame.executor.trace_log
            start = len(log)
            out = phase28_query(vt, name, mine)
            _sync()
            if name == "J1 left":
                mine["joined"] = out
            record["queries"].setdefault(name, {}).update(
                phase28_record(name, log[start:], out, wants[name], scales.get(name, {})))
            progress(f"{name} over both processes, ok {record['queries'][name]['ok']}")
        record["launches"] = {**launch_counts(plan, gp), "b6": probe.probe.launches,
                              "b6-wide": probe.probe.wide_launches}
        if reps:  # each query's checked run above was its warm-up
            for name in PHASE28_QUERIES:
                record["queries"][name]["world2_ms"] = _phase28_timed(
                    lambda: phase28_query(vt, name, mine), reps, across=True, warm=False)
                progress(f"{name} timed")
    record["phase_s"] = time.perf_counter() - t0
    print("RESULT " + json.dumps(record), flush=True)
    # leave the group together, then end without the interpreter's teardown:
    # gloo's threads torn down at exit can abort a process whose work is done
    dist.barrier()
    dist.destroy_process_group()
    os._exit(0)


def _empty_cache():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def phase28_record(name, entries, out, want, scales):
    """A world-2 query's check (``ok``, else the failure) and what its trace
    says: the route's entries with their world, a fall-back to the classic
    or the broadcast path, the exchange's bytes a shard and its slack."""
    route = PHASE28_ROUTES[name]
    taken = [e for e in entries if e.get(route)]
    rec = {"route": route, "entries": len(taken),
           "worlds": sorted({(e["mesh"] if route == "mesh" else e)["world"] for e in taken}),
           "fallback": [e for e in entries
                        if e.get("shuffle") in ("overflow", "replicated")
                        or e.get("fused_mesh_groupby") == "classic"
                        or e.get("join") in ("local", "broadcast")]}
    exchange = [e for e in taken if "alltoall_bytes_per_device" in e]
    if exchange:
        rec.update({k: exchange[-1][k] for k in ("alltoall_bytes_per_device", "slack",
                                                  "exchange_s", "gather_s")
                    if k in exchange[-1]})
    try:
        if name.startswith("J1"):
            phase28_check_join(name, phase28_joined(out), want)
        else:
            phase24_check(name, phase24_answer(out), want, scales, phase="phase 28")
        rec["ok"] = True
    except RuntimeError as e:
        rec["ok"] = False
        rec["error"] = str(e)[:300]
    return rec


def phase28_run(n=PHASE28_ROWS, n_fact=PHASE28_FACT, n_dim=PHASE28_DIM, device="cuda:0",
                reps=PHASE28_REPS, timeout=PHASE28_TIMEOUT, env=None):
    """Phase 28's two processes (gloo over a ``file://`` store, two shards of
    ``device`` each); returns each one's record with its exit code
    (``failed``: its output where it printed no result)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="phase28-")
    try:
        script = os.path.join(tmp, "worker.py")
        with open(script, "w") as f:
            f.write(PHASE28_WORKER)
        store = os.path.join(tmp, "store")
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(2)]
        procs = []
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, script, HERE, str(r), store, str(n), str(n_fact),
                     str(n_dim), device, str(reps)], stdout=f, stderr=subprocess.STDOUT,
                    text=True, env=dict(os.environ, **(env or {}))))
        deadline = time.perf_counter() + timeout
        try:
            for p in procs:  # a worker past the deadline is killed: its log says how far
                try:
                    p.wait(timeout=max(deadline - time.perf_counter(), 1))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for log in logs:
            with open(log) as f:
                outs.append(f.read())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    records = []
    for p, out in zip(procs, outs):
        if "RESULT " not in out or p.returncode != 0:
            records.append({"failed": out[-3000:], "rc": p.returncode})
        else:
            records.append({**json.loads(out.split("RESULT ", 1)[1].splitlines()[0]),
                            "rc": p.returncode, "progress": [
                                line for line in out.splitlines() if line.startswith("rank ")]})
    return records


def phase28_verdict(records, kernels=True):
    """What phase 28's processes showed (raises otherwise): both exited 0,
    every collective took the device's tensors, every query's answer
    equals the single device's, took its route with world 2 and fell back
    nowhere; with ``kernels`` B3 (a route) and B6 were launched in each."""
    check(len(records) == 2, f"phase 28: {len(records)} records of 2 processes")
    for r in records:
        check("failed" not in r and r.get("rc") == 0 and "collectives" in r,
              f"phase 28: a process failed: {r}")
        refused = {k: v for k, v in r["collectives"].items() if v != "ok"}
        check(not refused, f"phase 28: a collective refused the tensors: {refused}")
        check(sorted(r["queries"]) == sorted(PHASE28_QUERIES)
              and all("ok" in q for q in r["queries"].values()),
              f"phase 28: rank {r['rank']} ran {sorted(r['queries'])}")
        for name, q in r["queries"].items():
            check(q["ok"], f"phase 28 {name}: rank {r['rank']}: {q.get('error')}")
            check(q["entries"] > 0 and q["worlds"] == [2] and not q["fallback"],
                  f"phase 28 {name}: rank {r['rank']} did not take its route across the "
                  f"processes: {q}")
        if kernels:
            for names in PHASE28_KERNELS:
                check(any(r["launches"][k] > 0 for k in names),
                      f"phase 28: rank {r['rank']} launched none of {names}: {r['launches']}")
    return {"ok": True}


def phase28_path(vt, plan, gp, probe, label):
    """Phase 28 on the card (see the module's docstring).  Returns (the
    launches of both processes' world-2 queries, the phase's record)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    records = phase28_run()
    phase28_verdict(records)
    launches = {k: sum(r["launches"][k] for r in records) for k in records[0]["launches"]}
    print(f"launches in both processes' world-2 queries during phase 28: {launches}", flush=True)
    times = {name: {"world2_ms": records[0]["queries"][name]["world2_ms"],
                    "four_shards_ms": records[0]["queries"][name]["four_shards_ms"],
                    "single_ms": records[0]["queries"][name]["single_ms"]}
             for name in PHASE28_QUERIES}
    for name, t in times.items():
        print(f"[{label}] phase 28 {name}: two processes x {PHASE28_SHARDS} shards "
              f"{t['world2_ms']:.2f} ms; one process x 4 shards {t['four_shards_ms']:.3f} ms; "
              f"one device {t['single_ms']:.3f} ms (medians of {PHASE28_REPS})", flush=True)
    record = {"card": label, "processes": 2, "shards_per_process": PHASE28_SHARDS,
              "rows": PHASE28_ROWS, "fact_rows": PHASE28_FACT, "dim_rows": PHASE28_DIM,
              "reduced": "config 5's 1e9 rows to 1e8 (config 3's table and config 4's fact "
                         "table, as phase 24); two processes on one card, not hosts",
              "times": times, "launches": launches,
              "ranks": [{k: v for k, v in r.items() if k != "launches"} for r in records],
              "phase_s": time.perf_counter() - t_phase}
    return launches, record


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "vaex_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import vaex_tpu_torch as vt
    from vaex_tpu_torch import agg
    from vaex_tpu_torch.ops import grid_additive as ga
    from vaex_tpu_torch.ops import grid_extreme as ge
    from vaex_tpu_torch.ops import grid_partition as gp
    from vaex_tpu_torch.ops import grid_plan as plan
    from vaex_tpu_torch.ops import grid_window as gw
    from vaex_tpu_torch.ops import grid_moments as gm
    from vaex_tpu_torch.ops import kernel_build, probe

    label = card()
    print(label)
    if sys.argv[1:2] == ["--profile"]:
        kernel_build.build("grid_additive", "grid_window", "grid_partition", "grid_moments",
                           "grid_moments_window", "probe")
        profile_phases(vt, [int(a) for a in sys.argv[2:]] or [20, 21, 22, 23], label)
        return 0
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    # B3x is the min/max mode of B3's source, b3-l2 its resident route
    sources = {plan.B1: "grid_additive", plan.B2: "grid_window", plan.B3: "grid_partition",
               plan.B4: "grid_moments", plan.B5: "grid_moments_window", "b6": "probe",
               plan.B3X: "grid_partition", plan.B3X_L2: "grid_partition",
               plan.B3X_DIRECT: "grid_partition", plan.B3_L2: "grid_partition"}
    for name, (path, seconds, log) in kernel_build.build(*dict.fromkeys(
            sources.values())).items():
        print(f"built {os.path.relpath(path, HERE)} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")

    g_max, _ = kernel_vs_plain(ga)
    print(f"kernel vs plain passed; largest G that fits B1: {g_max}", flush=True)
    wide_kernels_vs_plain(plan, gw)
    print("wide kernels vs plain passed", flush=True)
    moment_kernels_vs_plain(plan, gm, agg)
    print("moment kernels vs plain passed", flush=True)
    probe_vs_plain(probe)
    print("probe kernel vs plain passed", flush=True)
    extreme_kernel_vs_plain(gp, ge)
    print("min/max kernel vs plain passed", flush=True)

    # phases 6-21 check and time the passes themselves: the result cache is off
    # there (phase 22 drives it)
    cache_off = vt.cache.off()
    cache_off.__enter__()
    zero_launches(plan, gp)
    probe.probe.launches = 0
    tables = {n: main_path(n, vt) for n in MAIN_SIZES}
    main_launches = {name: kernel.launches for name, kernel in plan.KERNELS.items()}
    check(main_launches[plan.B1] > 0, "grid_additive was not launched during the main path")
    print(f"launches during the main path: {main_launches}", flush=True)
    results = {n: timings(n, *tables[n], vt, ga, label) for n in MAIN_SIZES}
    del tables

    h2o_df, h2o_cols, h2o_launches = h2o_path(vt, plan)
    for name in (plan.B2, plan.B3, plan.B3_L2):
        check(h2o_launches[name] > 0,
              f"{sources[name]} ({name}) was not launched during the H2O path")
    stats_launches = stats_path(vt, plan, h2o_df, h2o_cols)
    for name in (plan.B4, plan.B5):
        check(stats_launches[name] > 0,
              f"{sources[name]} was not launched during the statistics path")
    wide = h2o_timings(h2o_df, h2o_cols, vt, plan, label)
    moments = stats_timings(h2o_df, h2o_cols, vt, plan, agg, gm, label)
    del h2o_df

    sets_df, sets_cols, values, sets_launches = sets_path(vt, plan, probe, h2o_cols)
    check(sets_launches["b6"] > 0, "probe was not launched during the set-based path")
    check(sets_launches["b6-wide"] > 0,
          "the probe's b6-wide route was not launched during the set-based path")
    sets = sets_timings(sets_df, sets_cols, values, vt, probe, label)
    sets["wide_launches"] = sets_launches["b6-wide"]
    del sets_df, sets_cols

    binby_df, binby_cols, binby_launches = binby_path(vt, plan, gp, h2o_cols)
    for route in (plan.B3X_DIRECT, plan.B3X_L2, plan.B3X):
        check(binby_launches[route] > 0,
              f"B3x's route {route} was not launched during the binned-statistics path")
    check(binby_launches[plan.B3_L2] > 0,
          "b3-l2 was not launched during the binned-statistics path")
    extremes = binby_timings(binby_df, binby_cols, vt, gp, ge, plan, label)
    wide[plan.B3]["l2_launches"] = h2o_launches[plan.B3_L2]
    del binby_df, binby_cols, h2o_cols

    config2_launches, _ = config2_path(vt, plan, ga, gm, gp, label)
    results[MAIN_SIZES[0]]["config2_launches"] = config2_launches[plan.B1]
    moments[plan.B4]["config2_launches"] = config2_launches[plan.B4]

    config3_launches, config3_times = config3_path(vt, plan, gp, probe, label)
    torch.cuda.empty_cache()  # the config 3 table is gone with its frame
    print(f"[{label}] config 3 medians (port s, plain torch s): {json.dumps(config3_times)}",
          flush=True)

    config4_launches, config4_times, config4_b6 = config4_path(vt, plan, gp, probe, label)
    torch.cuda.empty_cache()
    print(f"[{label}] config 4 medians (port s, plain torch s): {json.dumps(config4_times)}",
          flush=True)
    sets.update(config4_b6)

    phase19_launches, phase19 = phase19_path(vt, plan, gp, probe, label)
    print(json.dumps({"phase19": phase19}), flush=True)

    phase20_launches, phase20 = phase20_path(vt, plan, gp, probe, label)
    print(json.dumps({"phase20": phase20}), flush=True)

    phase21_launches, phase21 = phase21_path(vt, plan, gp, probe, label, config3_times)
    print(json.dumps({"phase21": phase21}), flush=True)
    wide[plan.B3]["phase21_l2_launches"] = phase21_launches[plan.B3_L2]
    cache_off.__exit__(None, None, None)

    phase22_launches, phase22 = phase22_path(vt, plan, gp, probe, label)
    print(json.dumps({"phase22": phase22}), flush=True)

    phase23_launches, phase23 = phase23_path(vt, plan, gp, probe, label)
    print(json.dumps({"phase23": phase23}), flush=True)

    phase24_launches, phase24 = phase24_path(vt, plan, gp, probe, label)
    print(json.dumps({"phase24": phase24}), flush=True)

    phase25_launches, phase25 = phase25_path(vt, plan, gp, probe, label)
    print(json.dumps({"phase25": phase25}), flush=True)

    phase26_launches, phase26 = phase26_path(vt, plan, gp, probe, label)
    print(json.dumps({"phase26": phase26}), flush=True)

    phase27_launches, phase27 = phase27_path(vt, plan, gp, probe, label)
    print(json.dumps({"phase27": phase27}), flush=True)

    phase28_launches, phase28 = phase28_path(vt, plan, gp, probe, label)
    print(json.dumps({"phase28": phase28}), flush=True)
    print(f"[{label}] chip_smoke.py took {time.perf_counter() - T_START:.1f} s", flush=True)

    measured = {plan.B1: (main_launches[plan.B1], results[MAIN_SIZES[0]]),
                plan.B2: (h2o_launches[plan.B2], wide[plan.B2]),
                plan.B3: (h2o_launches[plan.B3], wide[plan.B3]),
                plan.B4: (stats_launches[plan.B4], moments[plan.B4]),
                plan.B5: (stats_launches[plan.B5], moments[plan.B5]),
                "b6": (sets_launches["b6"], sets),
                **{route: (binby_launches[route], extremes[route])
                   for route in (plan.B3X_L2, plan.B3X, plan.B3X_DIRECT)}}
    replaces = {plan.B1: "vaex_tpu/ops/pallas_gridagg.py:474",
                plan.B2: "vaex_tpu/ops/pallas_gridagg.py:239",
                plan.B3: "vaex_tpu/ops/pallas_partition.py:72",
                plan.B4: "vaex_tpu/ops/pallas_gridagg.py:45",
                plan.B5: "vaex_tpu/ops/pallas_gridagg.py:126",
                "b6": "vaex_tpu/ops/pallas_probe.py:37",
                **dict.fromkeys((plan.B3X_L2, plan.B3X, plan.B3X_DIRECT),
                                "vaex_tpu/ops/pallas_partition.py:287")}
    names = {plan.B3X_L2: "grid_resident_extreme (b3x-l2)",
             plan.B3X: "grid_partition_extreme (b3x)",
             plan.B3X_DIRECT: "grid_partition_extreme (b3x-direct)"}
    print(label)
    print(json.dumps({"kernels": [{
        "name": names.get(name, sources[name]),
        "route": "cuda",
        "source": f"vaex_tpu_torch/csrc/{sources[name]}.cu",
        "replaces": replaces[name],
        "launches": launches,
        "max_abs_err": m["err"],
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": m["library_ms"],
        "config3_launches": config3_launches[name],
        "config4_launches": config4_launches[name],
        "phase19_launches": phase19_launches[name],
        "phase20_launches": phase20_launches[name],
        "phase21_launches": phase21_launches[name],
        "phase22_launches": phase22_launches[name],
        "phase23_launches": phase23_launches[name],
        "phase24_launches": phase24_launches[name],
        "phase25_launches": phase25_launches[name],
        "phase26_launches": phase26_launches[name],
        "phase27_launches": phase27_launches[name],
        "phase28_launches": phase28_launches[name],
        **{key: value for key, value in m.items() if key in EXTRA_KEYS},
    } for name, (launches, m) in measured.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
