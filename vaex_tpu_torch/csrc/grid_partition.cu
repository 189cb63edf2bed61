// Per-bin sums (kernel B3) and per-bin min/max (kernel B3x) for wide grids,
// for Hopper (sm_90a).  Built by nvcc into a shared library with a plain C
// interface and loaded with ctypes (vaex_tpu_torch/ops/grid_partition.py).
//
// Replaces the TPU kernels vaex_tpu/ops/pallas_partition.py:_phase1_kernel
// and _phase2_kernel (via partitioned_additive_channels).  The contract is
// B1's (grid_additive.cu): idx [N] int32, rows outside [0, G) drop; int64
// columns summed mod 2^64; f32/f64 columns summed in f64 with NaN adding
// nothing; an implicit count.
//
// Two routes compute the sums; the plan (ops/grid_plan.py) picks by the
// bytes of the [C, G] grid.
//
// The resident route (resident_add, "b3-l2"), for a grid that stays in the
// card's L2 cache: one pass reads idx and the values once, with streaming
// loads that leave the cache to the grid, and adds every row into the
// zeroed [C, G] grid in device memory with 64-bit reductions
// (red.global.add.u64 / .f64).  The lanes of a warp that share a bin are
// combined first (struct Combine: runs of neighbouring lanes, then
// __match_any_sync across the runs), so keys that pile on few bins do not
// serialise on one address.  It moves what the function must move, 4 + v
// bytes per row; what bounds it is the rate of the L2's atomic units, one
// reduction per row and channel.
//
// The partition route ("b3"), for every wider grid.  The grid is cut into
// P buckets of S = 2^shift bins (the last one holds the G % S tail).  A
// row's bucket is idx >> shift.
//   * Phase 1a, partition_count: each CTA owns one segment of seg_rows
//     consecutive rows and counts its rows per bucket into counts[p, seg].
//     The wrapper turns the counts into exclusive offsets with a cumsum in
//     bucket-major, segment-minor order.  The segments are whole waves of
//     the card's SMs.
//   * Phase 1b, partition_scatter: each CTA walks its segment again in tiles
//     of blockDim.x * SCATTER_ROWS rows.  One histogram per CTA gives every
//     row of the tile its rank in its bucket (a shared-memory atomicAdd per
//     run of neighbouring lanes with one bucket; __match_any_sync costs more
//     than it saves here: PERF.md), a scan of the histogram orders the tile
//     by bucket, and then, one array at a time (the low bits of idx as
//     uint16, then each value column), the tile's values are staged in
//     shared memory in that order and written out with neighbouring threads
//     on neighbouring addresses of each bucket's run.  The work per tile follows its rows
//     (plus one pass over the P counters), and every bucket's place is
//     counted before a row moves, so no bucket can overflow.  The order of
//     the rows inside a bucket is not kept: phase 2 does not need it.
//   * Phase 2, partition_sums: the bucketed rows are cut into equal chunks,
//     one per CTA, whatever the buckets' sizes, so keys that pile into one
//     bucket still spread over the card.  A CTA walks the buckets its chunk
//     overlaps; for each it keeps one [C, S] sub-grid in shared memory that
//     all its warps share, adds the rows with 64-bit shared-memory atomics
//     (lanes that share a bin combined first, as above), and adds the
//     sub-grid's non-zero words into the zeroed [C, G] result with global
//     reductions.  No scratch and no fold.
//   * Phase 2 of the min/max mode (kernel B3x), partition_extremes: beside
//     or instead of the sums, a CTA keeps one [E, S] grid of 64-bit keys in
//     shared memory, the per-bin min or max of E bucketed columns, over the
//     same equal chunks of the bucketed rows, and takes its keys' minimum
//     into a [E, G] grid of keys with global atomics; fold_extremes turns
//     the keys back into values.  It replaces the extreme_cols mode of the
//     same TPU kernels (_phase2_kernel's masked reduce).  See "The min/max
//     mode" below.
// Integer sums and counts are exact on both routes.  Float sums are NOT
// reproducible from run to run: the order in which warps and CTAs reach a
// word varies (as in B2, grid_window.cu).  Clustered or pre-sorted keys
// need no other path (the TPU kernel's fixed run capacity overflowed on
// them and the pass was rerun on the sort path).
//
// What bounds the partition route on an H100: HBM traffic, about three
// trips of the payload: phase 1a reads idx (4 B/row), phase 1b reads idx
// and the values and writes 2 B of low bits plus the values, phase 2 reads
// the low bits and the values: 4 + (4 + v + 2 + v) + (2 + v) = 12 + 3v
// bytes per row for v value bytes per row.  Wide buckets (a CTA-wide
// sub-grid is 8 times wider than warp-private ones) keep P small, so a tile
// gives every bucket a run of whole 32-byte sectors.  PERF.md has the times
// and the designs this one replaced.
//
// The min/max mode.  A column is int64, float64 or float32 and keeps its
// type: a value becomes a 64-bit unsigned key whose order is the value's
// (int64: the sign bit flipped; floats, widened to double: the IEEE bits,
// inverted when negative, else with the sign bit set), a max column takes
// the key's complement, and every cell is one unsigned minimum.  min and
// max are exact and free of order, so the cells need no ordered scheme: a
// thread reads the cell and only where its key is smaller does it make a
// shared-memory atomicMin, which after the first few rows of a cell is
// rare.  NaN rows and rows whose validity byte is 0 never reach a cell.  The
// key of all ones is no value's (it would be a NaN's), so it marks the
// empty cell, which comes back as the identity: +-inf, or the int64 max
// (min) or min (max).  -0.0 orders below 0.0: a cell that holds both keeps
// -0.0 as its min and 0.0 as its max, whatever the order of the rows; by
// value either equals what a comparison of values keeps.
// A grid that fits one CTA's shared memory (E * G * 8 bytes) needs no
// partition: the same kernel reads idx itself, a CTA per chunk of the rows
// with its own [E, G] partial, and fold_extremes takes the minimum over the
// partials (grid_partition_extremes with direct == 1).
// A grid of keys that stays in L2 needs none either: the resident route
// (resident_extremes, "b3x-l2", grid_partition_resident_extremes) reads idx,
// the raw columns and their validity bytes once, with streaming loads, and
// takes every row's keys into one grid in device memory with an L2 read of
// the cell and a 64-bit atomicMin where the row's key is smaller, which
// after a cell's first rows is rare (with about 100 uniform rows a cell,
// H(100) = 5.2 updates).  A cell's E keys lie together (resident_stride),
// so one 16-byte load reads two columns' keys.  What bounds it on an H100
// is that read, one L2 request a row and pair of columns, not the 4 + 8
// bytes a row and column it streams from HBM (PERF.md, section 6).
// Every route forms the keys of a few rows of a column together
// (column_keys), so their loads are in flight at once.  The TPU mode's
// f32-only values in three bf16 pieces, its 0/1 validity channel, its
// finite +-2^126 stand-in for the infinities and its S <= 8192 cap all came
// from relocating rows with a matrix product and have no counterpart here.

#include "grid_common.cuh"

#define MAX_EXT 8
#define SIGN_BIT 0x8000000000000000ull
#define EMPTY_KEY 0xffffffffffffffffull
// rows a thread of the scatter holds per tile
#define SCATTER_ROWS 8
#define NO_ROW 0xffffffffu

// Shared memory of partition_scatter: per bucket its running offset and its
// count (then start) in the tile, one int per warp for the scan, and per row
// of the tile its destination (int) and one staged value (8 bytes).
static inline size_t scatter_smem(int threads, int P) {
    return (size_t)(2 * P + 32) * sizeof(int) + (size_t)threads * SCATTER_ROWS * 12;
}

struct OutColumns {
    void* ptr[MAX_COLS];  // bucketed copies of the Columns, same types
};

// One warp step of U rows per lane: lane `lane` holds rows r[u] of the
// columns with bins b[u] (b[u] < 0: the row adds nothing).  The lanes that
// share a bin are combined, and one of them adds the sum to word b[u] of
// each channel's row of `grid` (rows `stride` words apart; rows
// [0, count + n_int) integers, the rest doubles) with one atomic.  `grid`
// is shared or global memory.  Every lane of the warp must call this.
template <int U, bool STREAM>
__device__ __forceinline__ void warp_atomic_add(const int (&b)[U], const long long (&r)[U],
                                                int lane, int count, const Columns& cols,
                                                int n_int, int n_float, size_t stride,
                                                unsigned long long* grid) {
    Combine same[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        same[u] = Combine(b[u], lane);
        if (count && same[u].lead) atomicAdd(grid + b[u], (unsigned long long)same[u].rows);
    }
    for (int k = 0; k < n_int; ++k) {
        const long long* col = (const long long*)cols.ptr[k];
        unsigned long long v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
            v[u] = b[u] < 0 ? 0ull
                            : (unsigned long long)(STREAM ? __ldcs(col + r[u]) : __ldg(col + r[u]));
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const unsigned long long s = same[u].sum(v[u], lane);
            if (same[u].lead) atomicAdd(grid + (size_t)(count + k) * stride + b[u], s);
        }
    }
    double* grid_f = reinterpret_cast<double*>(grid + (size_t)(count + n_int) * stride);
    for (int k = 0; k < n_float; ++k) {
        const void* col = cols.ptr[n_int + k];
        const int f32 = cols.is_f32[n_int + k];
        double v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            v[u] = 0.0;
            if (b[u] >= 0) {
                if (f32)
                    v[u] = (double)(STREAM ? __ldcs((const float*)col + r[u])
                                           : __ldg((const float*)col + r[u]));
                else
                    v[u] = STREAM ? __ldcs((const double*)col + r[u])
                                  : __ldg((const double*)col + r[u]);
                if (v[u] != v[u]) v[u] = 0.0;  // NaN adds nothing
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const double s = same[u].sum(v[u], lane);
            if (same[u].lead) atomicAdd(grid_f + (size_t)k * stride + b[u], s);
        }
    }
}

// The resident route: every warp takes rows base + u * step + lane and adds
// them into out [C, G], zeroed by the caller.
__global__ void resident_add(const int* __restrict__ idx, long long n, int G, int count,
                             Columns cols, int n_int, int n_float,
                             unsigned long long* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long step = (long long)gridDim.x * blockDim.x;
    // the loop bound is the warp's, so its lanes stay together
    for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x - lane); base < n;
         base += UNROLL * step) {
        int b[UNROLL];
        long long r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            r[u] = base + u * step + lane;
            b[u] = -1;
            if (r[u] < n) {
                const int t = __ldcs(idx + r[u]);
                if ((unsigned)t < (unsigned)G) b[u] = t;
            }
        }
        warp_atomic_add<UNROLL, true>(b, r, lane, count, cols, n_int, n_float, (size_t)G, out);
    }
}

// Phase 1a: CTA seg counts the rows of [seg * seg_rows, (seg + 1) * seg_rows)
// per bucket into counts[p, seg]; a run of neighbouring lanes with one
// bucket adds its count once.
__global__ void partition_count(const int* __restrict__ idx, long long n, int G, int shift,
                                int P, long long seg_rows, int n_seg,
                                int* __restrict__ counts) {
    extern __shared__ int hist[];  // [P]
    const int seg = blockIdx.x;
    const int lane = threadIdx.x & 31;
    for (int p = threadIdx.x; p < P; p += blockDim.x) hist[p] = 0;
    __syncthreads();
    const long long begin = (long long)seg * seg_rows;
    const long long end = min(n, begin + seg_rows);
    for (long long t0 = begin; t0 < end; t0 += (long long)blockDim.x * UNROLL) {
        int p[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long r = t0 + (long long)u * blockDim.x + threadIdx.x;
            p[u] = -1;
            if (r < end) {
                const int t = __ldg(idx + r);
                if ((unsigned)t < (unsigned)G) p[u] = t >> shift;
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            int first, stop;
            run_bounds(run_heads(p[u], lane), lane, first, stop);
            if (p[u] >= 0 && lane == first) atomicAdd(hist + p[u], stop - first);
        }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < P; p += blockDim.x) counts[(size_t)p * n_seg + seg] = hist[p];
}

// Exclusive prefix sum of v[0, m) in place, by the whole CTA; returns the
// total.  Each thread adds a contiguous run of v, the warps scan the
// threads' sums with shuffles, then each thread writes its run back.
__device__ int block_exclusive_scan(int* v, int m, int* warp_sums) {
    const int per = (m + blockDim.x - 1) / blockDim.x;
    const int lo = min(m, (int)threadIdx.x * per), hi = min(m, lo + per);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += v[i];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += x;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int warps = blockDim.x >> 5;
        int w = lane < warps ? warp_sums[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const int x = __shfl_up_sync(FULL_MASK, w, o);
            if (lane >= o) w += x;
        }
        if (lane < warps) warp_sums[lane] = w;  // inclusive, per warp
    }
    __syncthreads();
    int run = incl - sum + (warp ? warp_sums[warp - 1] : 0);
    for (int i = lo; i < hi; ++i) {
        const int x = v[i];
        v[i] = run;
        run += x;
    }
    const int total = warp_sums[(blockDim.x >> 5) - 1];
    __syncthreads();
    return total;
}

// One array of the tile: each thread stages the values of its kept rows at
// their places in bucket order, then the CTA writes the staged tile out, a
// thread per place, so a bucket's run goes out over neighbouring addresses.
template <class T, class Load>
__device__ __forceinline__ void scatter_array(const unsigned (&pos)[SCATTER_ROWS],
                                              long long t0, int kept, const int* dest,
                                              T* stage, T* __restrict__ out, Load load) {
#pragma unroll
    for (int u = 0; u < SCATTER_ROWS; ++u)
        if (pos[u] != NO_ROW) stage[pos[u]] = load(t0 + (long long)u * blockDim.x + threadIdx.x);
    __syncthreads();
    for (int j = threadIdx.x; j < kept; j += blockDim.x) out[dest[j]] = stage[j];
    __syncthreads();
}

// Phase 1b: CTA seg moves the kept rows of its segment, tile by tile of
// blockDim.x * SCATTER_ROWS rows, to their buckets.  A row's place in its
// bucket is the bucket's running offset plus its rank among the tile's rows
// of the bucket, which the CTA's histogram hands out.
__global__ void __launch_bounds__(1024)
partition_scatter(const int* __restrict__ idx, long long n, int G, int shift, int P,
                  long long seg_rows, int n_seg, const int* __restrict__ offsets, Columns cols,
                  int n_cols, OutColumns out, unsigned short* __restrict__ lo_out) {
    extern __shared__ unsigned long long scatter_sm[];
    const int lane = threadIdx.x & 31;
    const int seg = blockIdx.x;
    const int tile = blockDim.x * SCATTER_ROWS;
    unsigned long long* stage = scatter_sm;                // [tile] one array's values
    int* dest = reinterpret_cast<int*>(stage + tile);      // [tile] where each place goes
    int* run = dest + tile;    // [P] where the bucket's next row of the segment goes
    int* hist = run + P;       // [P] the bucket's rows in the tile, then its start there
    int* warp_sums = hist + P; // [32]
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
        run[p] = offsets[(size_t)p * n_seg + seg];
        hist[p] = 0;
    }
    __syncthreads();
    const int low_mask = (1 << shift) - 1;
    const long long begin = (long long)seg * seg_rows;
    const long long end = min(n, begin + seg_rows);
    for (long long t0 = begin; t0 < end; t0 += tile) {
        unsigned pos[SCATTER_ROWS];  // bucket << 16 | rank, then the place in the tile
#pragma unroll
        for (int u = 0; u < SCATTER_ROWS; ++u) {
            const long long r = t0 + (long long)u * blockDim.x + threadIdx.x;
            int p = -1;
            if (r < end) {
                const int t = __ldg(idx + r);
                if ((unsigned)t < (unsigned)G) p = t >> shift;
            }
            // a run of neighbouring lanes with one bucket takes its places
            // with one atomicAdd
            int first, stop, rank = 0;
            run_bounds(run_heads(p, lane), lane, first, stop);
            if (p >= 0 && lane == first) rank = atomicAdd(hist + p, stop - first);
            rank = __shfl_sync(FULL_MASK, rank, first) + lane - first;
            pos[u] = p < 0 ? NO_ROW : ((unsigned)p << 16) | (unsigned)rank;
        }
        __syncthreads();  // the tile's histogram is complete
        const int kept = block_exclusive_scan(hist, P, warp_sums);
#pragma unroll
        for (int u = 0; u < SCATTER_ROWS; ++u) {
            if (pos[u] == NO_ROW) continue;
            const int p = (int)(pos[u] >> 16), rank = (int)(pos[u] & 0xffffu);
            pos[u] = (unsigned)(hist[p] + rank);
            dest[pos[u]] = run[p] + rank;
        }
        __syncthreads();  // every place knows where it goes
        scatter_array(pos, t0, kept, dest, reinterpret_cast<unsigned short*>(stage), lo_out,
                      [&](long long r) { return (unsigned short)(__ldg(idx + r) & low_mask); });
        for (int k = 0; k < n_cols; ++k) {
            if (cols.is_f32[k]) {
                const float* col = (const float*)cols.ptr[k];
                scatter_array(pos, t0, kept, dest, reinterpret_cast<float*>(stage),
                              (float*)out.ptr[k], [&](long long r) { return __ldg(col + r); });
            } else {
                const long long* col = (const long long*)cols.ptr[k];
                scatter_array(pos, t0, kept, dest, reinterpret_cast<long long*>(stage),
                              (long long*)out.ptr[k], [&](long long r) { return __ldg(col + r); });
            }
        }
        // the running offsets move past the tile's rows (hist[] holds each
        // bucket's start in the tile; the next one's is its end), then the
        // histogram is cleared for the next tile
        for (int q = threadIdx.x; q < P; q += blockDim.x)
            run[q] += (q + 1 < P ? hist[q + 1] : kept) - hist[q];
        __syncthreads();
        for (int q = threadIdx.x; q < P; q += blockDim.x) hist[q] = 0;
        __syncthreads();
    }
}

// The bucket that holds bucketed row `row` (row < bucket_start[P]): the last
// one that starts at or before it.
__device__ __forceinline__ int first_bucket(const int* __restrict__ bucket_start, int P,
                                            long long row) {
    int p = 0;
    for (int hi = P; p + 1 < hi;) {
        const int mid = (p + hi) >> 1;
        if (bucket_start[mid] <= row) p = mid; else hi = mid;
    }
    return p;
}

// Phase 2 of the sums.  CTA c takes rows [c * chunk_rows, (c + 1) * chunk_rows)
// of the bucketed arrays and, bucket by bucket, adds them into a [C, S]
// sub-grid in shared memory and the sub-grid into out [C, G], zeroed by the
// caller.
__global__ void __launch_bounds__(1024)
partition_sums(const unsigned short* __restrict__ lo,
                               const int* __restrict__ bucket_start, int G, int S, int P,
                               long long chunk_rows, int count, Columns cols, int n_int,
                               int n_float, unsigned long long* __restrict__ out) {
    extern __shared__ unsigned long long sub[];  // [C, S]
    const int C = count + n_int + n_float;
    const int C_int = count + n_int;
    const int lane = threadIdx.x & 31;
    const long long first_row = (long long)blockIdx.x * chunk_rows;
    const long long last_row = min((long long)bucket_start[P], first_row + chunk_rows);
    if (first_row >= last_row) return;
    int p = first_bucket(bucket_start, P, first_row);
    for (long long cur = first_row; cur < last_row; ++p) {
        const long long stop = min(last_row, (long long)bucket_start[p + 1]);
        if (stop <= cur) continue;  // an empty bucket
        const int w0 = p * S;
        const int Wc = min(S, G - w0);
        for (int j = threadIdx.x; j < C * S; j += blockDim.x) sub[j] = 0ull;
        __syncthreads();
        // a warp takes rows base + u * blockDim.x + lane, u < UNROLL
        for (long long base = cur + (threadIdx.x - lane); base < stop;
             base += (long long)UNROLL * blockDim.x) {
            int b[UNROLL];
            long long r[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                r[u] = base + (long long)u * blockDim.x + lane;
                b[u] = r[u] < stop ? (int)lo[r[u]] : -1;
            }
            warp_atomic_add<UNROLL, false>(b, r, lane, count, cols, n_int, n_float, (size_t)S,
                                           sub);
        }
        __syncthreads();
        for (int j = threadIdx.x; j < C * Wc; j += blockDim.x) {
            const int c = j / Wc;
            const int bin = j - c * Wc;
            const unsigned long long word = sub[(size_t)c * S + bin];
            if (!word) continue;  // as bits, 0 for the integers and the doubles alike
            unsigned long long* dst = out + (size_t)c * G + w0 + bin;
            if (c < C_int)
                atomicAdd(dst, word);
            else
                atomicAdd(reinterpret_cast<double*>(dst), __longlong_as_double((long long)word));
        }
        __syncthreads();
        cur = stop;
    }
}

struct ExtColumns {
    const void* ptr[MAX_EXT];             // the columns (bucketed, or raw with direct)
    const unsigned char* valid[MAX_EXT];  // per row 0/1, or null: every row counts
    void* out[MAX_EXT];                   // [G] each, in the column's type
    int type[MAX_EXT];                    // 0 int64, 1 float64, 2 float32
    int is_max[MAX_EXT];
};

// A load through the read-only path, or a streaming one that leaves L2 to a
// resident grid.
template <bool STREAM, class T>
__device__ __forceinline__ T load(const T* p) {
    if constexpr (STREAM) return __ldcs(p);
    return __ldg(p);
}

// The keys of rows r[u] of column e, EMPTY_KEY for a row that must not
// reach a cell (b[u] < 0, NaN, invalid; the all-ones key changes no cell):
// the branch on the column's type is taken once for the U rows, so all
// their loads are in flight together.
template <int U, bool STREAM>
__device__ __forceinline__ void column_keys(const ExtColumns& c, int e, const long long (&r)[U],
                                            const int (&b)[U], long long n,
                                            unsigned long long (&key)[U]) {
    long long at[U];  // the loads are unconditional: a row past n reads row n - 1
#pragma unroll
    for (int u = 0; u < U; ++u) at[u] = min(r[u], n - 1);
    bool drop[U];
#pragma unroll
    for (int u = 0; u < U; ++u) drop[u] = b[u] < 0;
    if (c.type[e] == 0) {
        const long long* col = (const long long*)c.ptr[e];
#pragma unroll
        for (int u = 0; u < U; ++u) key[u] = (unsigned long long)load<STREAM>(col + at[u]) ^ SIGN_BIT;
    } else {
        double v[U];
        if (c.type[e] == 2) {
            const float* col = (const float*)c.ptr[e];
#pragma unroll
            for (int u = 0; u < U; ++u) v[u] = (double)load<STREAM>(col + at[u]);
        } else {
            const double* col = (const double*)c.ptr[e];
#pragma unroll
            for (int u = 0; u < U; ++u) v[u] = load<STREAM>(col + at[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            drop[u] |= v[u] != v[u];
            const long long bits = __double_as_longlong(v[u]);
            key[u] = bits < 0 ? ~(unsigned long long)bits : (unsigned long long)bits | SIGN_BIT;
        }
    }
    if (c.valid[e]) {
#pragma unroll
        for (int u = 0; u < U; ++u) drop[u] |= !load<STREAM>(c.valid[e] + at[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        if (c.is_max[e]) key[u] = ~key[u];
        if (drop[u]) key[u] = EMPTY_KEY;
    }
}

// The rows [begin, end) into the CTA's cells [n_ext, Wc]: bucketed rows (lo:
// their bins inside the bucket) or, with direct, raw rows (idx: their bins;
// rows outside [0, G) drop).
__device__ __forceinline__ void extreme_rows(const unsigned short* __restrict__ lo,
                                             const int* __restrict__ idx, int direct,
                                             long long begin, long long end, int G, int Wc,
                                             const ExtColumns& cols, int n_ext,
                                             unsigned long long* cells) {
    for (long long base = begin + threadIdx.x; base < end; base += (long long)UNROLL * blockDim.x) {
        int b[UNROLL];
        long long r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            r[u] = base + (long long)u * blockDim.x;
            b[u] = -1;
            if (r[u] < end) {
                if (!direct) {
                    b[u] = (int)lo[r[u]];
                } else {
                    const int t = __ldg(idx + r[u]);
                    if ((unsigned)t < (unsigned)G) b[u] = t;
                }
            }
        }
        for (int e = 0; e < n_ext; ++e) {
            unsigned long long key[UNROLL];
            column_keys<UNROLL, false>(cols, e, r, b, end, key);  // rows past end read end - 1
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                if (key[u] == EMPTY_KEY) continue;
                unsigned long long* cell = cells + (size_t)e * Wc + b[u];
                // cells only ever shrink, so a stale read can only cost a
                // spare atomic, never lose a smaller key
                if (key[u] < *(volatile unsigned long long*)cell) atomicMin(cell, key[u]);
            }
        }
    }
}

// Phase 2 of the min/max mode.  With direct, CTA c takes chunk c of all n
// raw rows (one bucket as wide as the grid) and writes its [E, G] keys to
// scratch[c].  Over a partition, CTA c takes rows [c * chunk_rows,
// (c + 1) * chunk_rows) of the bucketed arrays, whatever the buckets' sizes,
// walks the buckets its chunk overlaps and, for each, takes the minimum of
// its [E, Wc] keys into bins [p * S, p * S + Wc) of scratch[0], which the
// caller filled with EMPTY_KEY.
__global__ void partition_extremes(const unsigned short* __restrict__ lo,
                                   const int* __restrict__ idx,
                                   const int* __restrict__ bucket_start, int direct,
                                   long long n, int G, int S, int P, long long chunk_rows,
                                   ExtColumns cols, int n_ext,
                                   unsigned long long* __restrict__ scratch) {
    extern __shared__ unsigned long long cells[];  // [n_ext, Wc]
    if (direct) {
        for (int j = threadIdx.x; j < n_ext * G; j += blockDim.x) cells[j] = EMPTY_KEY;
        __syncthreads();
        extreme_rows(lo, idx, 1, n * blockIdx.x / gridDim.x, n * (blockIdx.x + 1) / gridDim.x,
                     G, G, cols, n_ext, cells);
        __syncthreads();
        for (int j = threadIdx.x; j < n_ext * G; j += blockDim.x)
            scratch[(size_t)blockIdx.x * n_ext * G + j] = cells[j];
        return;
    }
    const long long first_row = (long long)blockIdx.x * chunk_rows;
    const long long last_row = min((long long)bucket_start[P], first_row + chunk_rows);
    if (first_row >= last_row) return;
    int p = first_bucket(bucket_start, P, first_row);
    for (long long cur = first_row; cur < last_row; ++p) {
        const long long stop = min(last_row, (long long)bucket_start[p + 1]);
        if (stop <= cur) continue;  // an empty bucket
        const int w0 = p * S;
        const int Wc = min(S, G - w0);
        for (int j = threadIdx.x; j < n_ext * Wc; j += blockDim.x) cells[j] = EMPTY_KEY;
        __syncthreads();
        extreme_rows(lo, idx, 0, cur, stop, G, Wc, cols, n_ext, cells);
        __syncthreads();
        for (int j = threadIdx.x; j < n_ext * Wc; j += blockDim.x) {
            const int e = j / Wc;
            if (cells[j] != EMPTY_KEY)
                atomicMin(scratch + (size_t)e * G + w0 + (j - e * Wc), cells[j]);
        }
        __syncthreads();
        cur = stop;
    }
}

// The keys of a cell on the resident route: the E keys of cell g lie
// together at g * stride, stride = 1 for one column, else E rounded up to
// even, so a row reads its cell's keys with 16-byte loads (one L2 request
// for two columns, where a [E, G] grid would take one per column).
__host__ __device__ __forceinline__ int resident_stride(int E) { return E == 1 ? 1 : (E + 1) & ~1; }

// The resident route of the min/max mode ("b3x-l2") for NE columns: every
// warp takes rows base + u * step + lane, as resident_add walks them, with
// streaming loads, and takes each kept row's keys into the grid of keys in
// device memory ([G, stride], resident_stride), which the caller filled with
// EMPTY_KEY and which stays in L2.  The lanes of a run of neighbouring lanes
// with one bin first take the run's minimum (a tree of shuffles, skipped
// when no two neighbours share a bin), and the run's first lane reads the
// cell's keys with L2 loads (__ldcg: L1 is not coherent across SMs) and
// makes a 64-bit atomicMin only where its key is smaller; a stale read costs
// a spare atomic, never a lost key, because a cell only ever shrinks.
template <int NE>
__global__ void __launch_bounds__(256)
resident_extremes(const int* __restrict__ idx, long long n, int G, ExtColumns cols,
                  unsigned long long* __restrict__ keys) {
    constexpr int STRIDE = NE == 1 ? 1 : (NE + 1) & ~1;
    const int lane = threadIdx.x & 31;
    const long long step = (long long)gridDim.x * blockDim.x;
    // the loop bound is the warp's, so its lanes stay together
    for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x - lane); base < n;
         base += UNROLL * step) {
        int b[UNROLL];
        long long r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            r[u] = base + u * step + lane;
            const int t = __ldcs(idx + min(r[u], n - 1));
            b[u] = r[u] < n && (unsigned)t < (unsigned)G ? t : -1;
        }
        unsigned long long key[NE][UNROLL];
#pragma unroll
        for (int e = 0; e < NE; ++e) column_keys<UNROLL, true>(cols, e, r, b, n, key[e]);
        bool lead[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const Combine run = Combine::runs(b[u], lane);
#pragma unroll
            for (int e = 0; e < NE; ++e) key[e][u] = run.run_min(key[e][u], lane);
            lead[u] = run.lead;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (!lead[u]) continue;
            unsigned long long* cell = keys + (size_t)b[u] * STRIDE;
            unsigned long long now[STRIDE];
            if constexpr (STRIDE == 1) {
                now[0] = __ldcg(cell);
            } else {
#pragma unroll
                for (int p = 0; p < STRIDE / 2; ++p) {
                    const ulonglong2 two = __ldcg(reinterpret_cast<const ulonglong2*>(cell) + p);
                    now[2 * p] = two.x;
                    now[2 * p + 1] = two.y;
                }
            }
#pragma unroll
            for (int e = 0; e < NE; ++e)
                if (key[e][u] < now[e]) atomicMin(cell + e, key[e][u]);
        }
    }
}

// The instance for n_ext columns (1 .. MAX_EXT).
static auto resident_kernel(int n_ext) {
    switch (n_ext) {
        case 1: return resident_extremes<1>;
        case 2: return resident_extremes<2>;
        case 3: return resident_extremes<3>;
        case 4: return resident_extremes<4>;
        case 5: return resident_extremes<5>;
        case 6: return resident_extremes<6>;
        case 7: return resident_extremes<7>;
        default: return resident_extremes<8>;
    }
}
static_assert(MAX_EXT == 8, "resident_kernel instantiates 1 .. 8 columns");

// One thread per output cell: the min of the chunks' keys, back as a value.
// The keys are [n_parts, n_ext, G], or with stride > 0 one grid [G, stride]
// (the resident route's).
__global__ void fold_extremes(const unsigned long long* __restrict__ scratch, int n_parts,
                              int stride, int G, ExtColumns cols, int n_ext) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= (long long)n_ext * G) return;
    const int e = (int)(j / G);
    const int g = (int)(j - (long long)e * G);
    unsigned long long key = EMPTY_KEY;
    if (stride) key = scratch[(size_t)g * stride + e];
    for (int p = 0; !stride && p < n_parts; ++p)
        key = min(key, scratch[(size_t)p * n_ext * G + j]);
    const bool empty = key == EMPTY_KEY;
    const unsigned long long ord = cols.is_max[e] ? ~key : key;
    if (cols.type[e] == 0) {
        const long long ident = cols.is_max[e] ? (long long)SIGN_BIT : (long long)~SIGN_BIT;
        ((long long*)cols.out[e])[g] = empty ? ident : (long long)(ord ^ SIGN_BIT);
    } else {
        const double inf = __longlong_as_double(0x7ff0000000000000ll);
        const double v = empty ? (cols.is_max[e] ? -inf : inf)
                               : __longlong_as_double((long long)((ord & SIGN_BIT) ? ord ^ SIGN_BIT
                                                                                   : ~ord));
        if (cols.type[e] == 2)
            ((float*)cols.out[e])[g] = (float)v;
        else
            ((double*)cols.out[e])[g] = v;
    }
}

extern "C" {

int grid_partition_smem_budget(void) { return SMEM_BUDGET; }

int grid_partition_max_cols(void) { return MAX_COLS; }

int grid_partition_scatter_rows(void) { return SCATTER_ROWS; }

// The resident route: out [C, G] 8-byte words, zeroed by the caller.  Returns
// cudaGetLastError(), or -1 when the arguments do not fit.
//   int_cols / float_cols / float_is_f32: HOST arrays as in grid_additive.
int grid_partition_resident(const int* idx, long long n, int G, int count,
                            const void* const* int_cols, int n_int,
                            const void* const* float_cols, const int* float_is_f32, int n_float,
                            int n_ctas, int threads, unsigned long long* out, void* stream) {
    const int C = count + n_int + n_float;
    if (G < 1 || C < 1 || n_int < 0 || n_float < 0 || n_int + n_float > MAX_COLS || n < 0 ||
        n_ctas < 1 || threads < 32 || threads > 1024 || threads % 32 ||
        (long long)C * G > 0x7fffffffLL)
        return -1;
    const Columns cols = make_columns(int_cols, n_int, float_cols, float_is_f32, n_float);
    resident_add<<<n_ctas, threads, 0, (cudaStream_t)stream>>>(idx, n, G, count, cols, n_int,
                                                               n_float, out);
    return (int)cudaGetLastError();
}

// Phase 1a: counts [P, n_seg] int32.  Returns cudaGetLastError(), or -1
// when the arguments do not fit.
int grid_partition_count(const int* idx, long long n, int G, int shift, int P,
                         long long seg_rows, int n_seg, int threads, int* counts,
                         void* stream) {
    const size_t smem = (size_t)P * sizeof(int);
    if (G < 1 || P < 1 || shift < 0 || shift > 15 || ((long long)P << shift) < G ||
        seg_rows < 32 || seg_rows % 32 || n_seg < 1 || threads < 32 || threads > 1024 ||
        threads % 32 || n < 0 || n > 0x7fffffffLL || smem > SMEM_BUDGET)
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = allow_smem(partition_count, smem);
    if (e != cudaSuccess) return (int)e;
    partition_count<<<n_seg, threads, smem, s>>>(idx, n, G, shift, P, seg_rows, n_seg, counts);
    return (int)cudaGetLastError();
}

// Phase 1b: n_cols columns of 8 bytes, or 4 where is_4byte says so.
//   offsets: device [P, n_seg] int32, exclusive offsets of the counts in
//            bucket-major order;
//   src / dst / is_4byte: HOST arrays of device pointers to the columns and
//            to their bucketed copies (as long as the rows kept);
//   lo: device uint16, the bins inside the buckets.
int grid_partition_scatter(const int* idx, long long n, int G, int shift, int P,
                           long long seg_rows, int n_seg, int threads, const int* offsets,
                           const void* const* src, void* const* dst, const int* is_4byte,
                           int n_cols, unsigned short* lo, void* stream) {
    if (threads < 32 || threads > 1024 || threads % 32) return -1;
    const size_t smem = scatter_smem(threads, P);
    if (G < 1 || P < 1 || P > 32768 || shift < 0 || shift > 15 ||
        ((long long)P << shift) < G || n_cols < 0 || n_cols > MAX_COLS || seg_rows < 32 ||
        seg_rows % 32 || n_seg < 1 || n < 0 || n > 0x7fffffffLL || smem > SMEM_BUDGET)
        return -1;
    Columns cols;
    OutColumns out;
    for (int k = 0; k < n_cols; ++k) {
        cols.ptr[k] = src[k];
        cols.is_f32[k] = is_4byte[k];
        out.ptr[k] = dst[k];
    }
    cudaError_t e = allow_smem(partition_scatter, smem);
    if (e != cudaSuccess) return (int)e;
    partition_scatter<<<n_seg, threads, smem, (cudaStream_t)stream>>>(
        idx, n, G, shift, P, seg_rows, n_seg, offsets, cols, n_cols, out, lo);
    return (int)cudaGetLastError();
}

// Phase 2 of the sums, over bucketed columns of n rows at most.
//   bucket_start: device [P + 1] int32;
//   bucketed_int / bucketed_float / float_is_f32: HOST arrays as in
//            grid_additive, of the bucketed copies;
//   out: device [C, G] 8-byte words, C = count + n_int + n_float, zeroed by
//        the caller.
int grid_partition_sums(const unsigned short* lo, const int* bucket_start, long long n, int G,
                        int shift, int P, int count, const void* const* bucketed_int,
                        int n_int, const void* const* bucketed_float, const int* float_is_f32,
                        int n_float, int n_ctas, int threads, unsigned long long* out,
                        void* stream) {
    const int C = count + n_int + n_float;
    const int S = 1 << shift;
    const size_t smem = (size_t)C * S * sizeof(unsigned long long);
    if (G < 1 || P < 1 || shift < 0 || shift > 15 || ((long long)P << shift) < G || C < 1 ||
        n_int < 0 || n_float < 0 || n_int + n_float > MAX_COLS || threads < 32 ||
        threads > 1024 || threads % 32 || n_ctas < 1 || n < 0 || n > 0x7fffffffLL ||
        (long long)C * G > 0x7fffffffLL || smem > SMEM_BUDGET)
        return -1;
    const Columns bucketed = make_columns(bucketed_int, n_int, bucketed_float, float_is_f32,
                                          n_float);
    // whole warp steps per CTA, so that only a bucket's end cuts a step short
    const long long unit = (long long)threads * UNROLL;
    const long long chunk_rows = ((n + n_ctas - 1) / n_ctas + unit - 1) / unit * unit;
    cudaError_t e = allow_smem(partition_sums, smem);
    if (e != cudaSuccess) return (int)e;
    partition_sums<<<n_ctas, threads, smem, (cudaStream_t)stream>>>(
        lo, bucket_start, G, S, P, chunk_rows > 0 ? chunk_rows : unit, count, bucketed, n_int,
        n_float, out);
    return (int)cudaGetLastError();
}

int grid_partition_max_ext(void) { return MAX_EXT; }

// Phase 2 of the min/max mode and its fold.  With direct == 0: over the
// bucketed columns of a partition into P buckets of 2^shift bins (lo, the
// bins inside the buckets, and bucket_start), n_ctas CTAs with an equal
// chunk of the rows each.  With direct == 1: over the raw columns and idx
// [n], for a grid of one bucket (P == 1), n_ctas chunks of the rows.
//   cols / valid / outs / types / is_max: HOST arrays, one entry per column:
//            device pointers to the column, to its validity bytes (or null;
//            only with direct) and to its [G] result, its type (0 int64, 1
//            float64, 2 float32) and 1 for max, 0 for min;
//   scratch: device 8-byte words: [n_ctas, n_ext, G] with direct, else
//            [n_ext, G] filled with all-ones bits by the caller.
int grid_partition_extremes(int direct, const unsigned short* lo, const int* idx, long long n,
                            const int* bucket_start, int G, int shift, int P,
                            const void* const* cols, const void* const* valid,
                            void* const* outs, const int* types, const int* is_max, int n_ext,
                            int n_ctas, int threads, unsigned long long* scratch,
                            void* stream) {
    const int S = 1 << shift;
    const size_t smem = (size_t)n_ext * (S < G ? S : G) * sizeof(unsigned long long);
    if (G < 1 || P < 1 || shift < 0 || shift > 30 || ((long long)P << shift) < G ||
        n_ext < 1 || n_ext > MAX_EXT || n_ctas < 1 || n_ctas > 65535 || threads < 32 ||
        threads > 1024 || threads % 32 || n < 0 || (long long)n_ext * G > 0x7fffffffLL ||
        smem > SMEM_BUDGET || (direct && P != 1) || (n > 0 && !(direct ? (const void*)idx
                                                                        : (const void*)lo)) ||
        (!direct && !bucket_start))
        return -1;
    ExtColumns c;
    for (int e = 0; e < n_ext; ++e) {
        if (types[e] < 0 || types[e] > 2 || (!direct && valid[e])) return -1;
        c.ptr[e] = cols[e];
        c.valid[e] = (const unsigned char*)valid[e];
        c.out[e] = outs[e];
        c.type[e] = types[e];
        c.is_max[e] = is_max[e] != 0;
    }
    const long long unit = (long long)threads * UNROLL;
    long long chunk_rows = ((n + n_ctas - 1) / n_ctas + unit - 1) / unit * unit;
    if (chunk_rows < unit) chunk_rows = unit;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = allow_smem(partition_extremes, smem);
    if (e != cudaSuccess) return (int)e;
    partition_extremes<<<n_ctas, threads, smem, s>>>(direct ? nullptr : lo, idx, bucket_start,
                                                     direct, n, G, S, P, chunk_rows, c, n_ext,
                                                     scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long cells = (long long)n_ext * G;
    fold_extremes<<<(unsigned)((cells + 255) / 256), 256, 0, s>>>(scratch, direct ? n_ctas : 1,
                                                                  0, G, c, n_ext);
    return (int)cudaGetLastError();
}

int grid_partition_resident_stride(int n_ext) { return resident_stride(n_ext); }

// The resident route of the min/max mode: one pass over idx [n] and the raw
// columns into the [G, resident_stride(n_ext)] grid of keys, then its fold.
//   cols / valid / outs / types / is_max: as in grid_partition_extremes
//            (a validity with every column that has one);
//   keys: device [G, resident_stride(n_ext)] 8-byte words, 16-byte aligned,
//         filled with all-ones bits by the caller.
int grid_partition_resident_extremes(const int* idx, long long n, int G,
                                     const void* const* cols, const void* const* valid,
                                     void* const* outs, const int* types, const int* is_max,
                                     int n_ext, int n_ctas, int threads,
                                     unsigned long long* keys, void* stream) {
    if (G < 1 || n_ext < 1 || n_ext > MAX_EXT || n < 0 || n_ctas < 1 || threads < 32 ||
        threads > 256 || threads % 32 || (long long)resident_stride(n_ext) * G > 0x7fffffffLL ||
        (n > 0 && !idx))
        return -1;
    ExtColumns c;
    for (int e = 0; e < n_ext; ++e) {
        if (types[e] < 0 || types[e] > 2) return -1;
        c.ptr[e] = cols[e];
        c.valid[e] = (const unsigned char*)valid[e];
        c.out[e] = outs[e];
        c.type[e] = types[e];
        c.is_max[e] = is_max[e] != 0;
    }
    if ((unsigned long long)keys % 16) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    resident_kernel(n_ext)<<<n_ctas, threads, 0, s>>>(idx, n, G, c, keys);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long cells = (long long)n_ext * G;
    fold_extremes<<<(unsigned)((cells + 255) / 256), 256, 0, s>>>(
        keys, 1, resident_stride(n_ext), G, c, n_ext);
    return (int)cudaGetLastError();
}

const char* grid_partition_error_string(int code) {
    if (code == -1) return "arguments do not fit the grid_partition kernel";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
