// Per-bin sums for wide grids through a partition of the rows by key range
// (kernel B3), for Hopper (sm_90a).  Built by nvcc into a shared library
// with a plain C interface and loaded with ctypes
// (vaex_tpu_torch/ops/grid_partition.py).
//
// Replaces the TPU kernels vaex_tpu/ops/pallas_partition.py:_phase1_kernel
// and _phase2_kernel (via partitioned_additive_channels).  The contract is
// B1's (grid_additive.cu): idx [N] int32, rows outside [0, G) drop; int64
// columns summed mod 2^64; f32/f64 columns summed in f64 with NaN adding
// nothing; an implicit count.
//
// The grid is cut into P buckets of S = 2^shift bins (the last one holds
// the G % S tail).  A row's bucket is idx >> shift.
//   * Phase 1a, partition_count: each CTA owns one segment of seg_rows
//     consecutive rows and counts its rows per bucket into counts[p, seg].
//     The wrapper turns the counts into exclusive offsets with a cumsum in
//     bucket-major, segment-minor order.
//   * Phase 1b, partition_scatter: each CTA walks its segment again, in
//     tiles of 4096 rows, and writes every kept row to offsets[p, seg] + its
//     rank in the segment, taken with __match_any_sync, a lane mask and
//     per-warp histograms, so the scatter is stable: inside a bucket, rows
//     keep their order.  A tile is counting-sorted by bucket in shared
//     memory first, so its writes go out in runs.  It writes the low bits of
//     idx (uint16) and the raw values.  Every bucket's place is counted
//     before a row moves, so no bucket can overflow.
//   * Phase 2, partition_partials: CTA (p, chunk) takes one chunk of bucket
//     p's rows and adds them into warp-private [C, S] grids with the ordered
//     scheme of grid_common.cuh, then writes its window of the partial of
//     its chunk; fold_partials adds the chunks in order.
// Phase 2 has no atomics, the integer atomics of phase 1 only count, and
// every order is fixed by the launch arguments, so floats are reproducible
// and ints exact.  Clustered or pre-sorted keys need no other path (the TPU
// kernel's fixed run capacity overflowed on them and the pass was rerun on
// the sort path).
//
// What bounds it on an H100: HBM traffic, about three trips of the payload:
// phase 1a reads idx (4 B/row), phase 1b reads idx and the values and
// writes 2 B of low bits plus the values, phase 2 reads the low bits and
// the values: 4 + (4 + v + 2 + v) + (2 + v) = 12 + 3v bytes per row for v
// value bytes per row (20 B/row for count + one f64 sum).  In practice the
// scatter's writes, spread over P buckets, cost most: the wrapper sizes the
// segments so that n_seg * P frontiers of partly written 32-byte sectors
// fit in L2, and the tile sort turns single-row stores into runs.  At
// G = 1e6, 1e8 rows, count + int64 + f64: 12.3 ms on an NVIDIA H100 80GB
// HBM3 (700 W; PERF.md has the designs it replaced and their times).

#include "grid_common.cuh"

// Shared memory of partition_scatter: run, start and per-warp counts per
// bucket, the destination (int) and tile row (short) of every row of a
// tile, and one int per warp for the scan.
static inline size_t scatter_smem(int warps, int P) {
    return (size_t)(warps + 2) * P * sizeof(int) + (size_t)warps * STAGE_ROWS * 6 + 32 * 4;
}

struct OutColumns {
    void* ptr[MAX_COLS];  // bucketed copies of the Columns, same types
};

// Phase 1a: CTA seg counts the rows of [seg * seg_rows, (seg + 1) * seg_rows)
// per bucket into counts[p, seg]; the lanes of a warp that share a bucket
// add their count once.
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
            const unsigned group = __match_any_sync(FULL_MASK, p[u]);
            if (p[u] >= 0 && lane == __ffs(group) - 1) atomicAdd(hist + p[u], __popc(group));
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

// Phase 1b: CTA seg moves the kept rows of its segment, tile by tile of
// blockDim.x * UNROLL rows, to their buckets.  Inside a tile, warp w holds
// rows w * STAGE_ROWS + u * 32 + lane, so (warp, u, lane) is row order; a
// row's place in its bucket is the bucket's running offset, plus the rows
// of the bucket in earlier warps of the tile (an exclusive prefix of the
// per-warp histograms), plus its rank inside its own warp: the scatter is
// stable.  The rows of a tile are first ordered by bucket in shared memory
// (a counting sort), so that the writes go out with neighbouring threads
// on neighbouring addresses of a bucket's run: a tile is wide enough (4096
// rows at 32 warps) that a bucket gets a few rows of it.  In row order
// every row is a store of its own, which costs about five times the same
// stores made to neighbouring addresses (PERF.md, section 6).
__global__ void partition_scatter(const int* __restrict__ idx, long long n, int G, int shift,
                                  int P, long long seg_rows, int n_seg,
                                  const int* __restrict__ offsets, Columns cols, int n_cols,
                                  OutColumns out, unsigned short* __restrict__ lo_out) {
    extern __shared__ int sm[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int seg = blockIdx.x;
    const int tile = blockDim.x * UNROLL;
    int* run = sm;                  // [P] where the bucket's next row of the segment goes
    int* start = run + P;           // [P] where the bucket's rows start in the sorted tile
    int* hist = start + P;          // [warps, P] rows of the tile per warp and bucket
    int* place = hist + (size_t)warps * P;  // [tile] destination of the sorted tile's rows
    short* row_of = reinterpret_cast<short*>(place + tile);  // [tile] their tile rows
    int* warp_sums = reinterpret_cast<int*>(row_of + tile);  // [32]
    int* h = hist + (size_t)warp * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) run[p] = offsets[(size_t)p * n_seg + seg];
    for (int j = threadIdx.x; j < warps * P; j += blockDim.x) hist[j] = 0;
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
    const int low_mask = (1 << shift) - 1;
    const long long begin = (long long)seg * seg_rows;
    const long long end = min(n, begin + seg_rows);
    for (long long t0 = begin; t0 < end; t0 += tile) {
        int p[UNROLL], rank[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long r = t0 + warp * STAGE_ROWS + u * 32 + lane;
            p[u] = -1;
            if (r < end) {
                const int t = __ldg(idx + r);
                if ((unsigned)t < (unsigned)G) p[u] = t >> shift;
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const unsigned group = __match_any_sync(FULL_MASK, p[u]);
            if (p[u] >= 0) rank[u] = h[p[u]] + __popc(group & below);
            __syncwarp();
            if (p[u] >= 0 && lane == __ffs(group) - 1) h[p[u]] += __popc(group);
            __syncwarp();
        }
        __syncthreads();  // every warp's histogram of the tile is complete
        // per bucket: the warps' counts become an exclusive prefix in warp
        // order, and start[] the bucket's count in the tile
        for (int q = threadIdx.x; q < P; q += blockDim.x) {
            int sum = 0;
            for (int w = 0; w < warps; ++w) {
                const int c = hist[(size_t)w * P + q];
                hist[(size_t)w * P + q] = sum;
                sum += c;
            }
            start[q] = sum;
        }
        __syncthreads();
        const int kept = block_exclusive_scan(start, P, warp_sums);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (p[u] < 0) continue;
            const int in_bucket = h[p[u]] + rank[u];
            const int pos = start[p[u]] + in_bucket;
            place[pos] = run[p[u]] + in_bucket;
            row_of[pos] = (short)(warp * STAGE_ROWS + u * 32 + lane);
        }
        __syncthreads();  // the tile is sorted by bucket
        for (int pos = threadIdx.x; pos < kept; pos += blockDim.x) {
            const int d = place[pos];
            const long long r = t0 + row_of[pos];
            lo_out[d] = (unsigned short)(__ldg(idx + r) & low_mask);
            for (int k = 0; k < n_cols; ++k) {
                if (cols.is_f32[k])
                    ((float*)out.ptr[k])[d] = __ldg((const float*)cols.ptr[k] + r);
                else
                    ((long long*)out.ptr[k])[d] = __ldg((const long long*)cols.ptr[k] + r);
            }
        }
        // the running offsets move past the tile's rows (start[] still holds
        // each bucket's offset in the tile; the next one's is its end)
        for (int q = threadIdx.x; q < P; q += blockDim.x)
            run[q] += (q + 1 < P ? start[q + 1] : kept) - start[q];
        for (int j = threadIdx.x; j < warps * P; j += blockDim.x) hist[j] = 0;
        __syncthreads();
    }
}

__global__ void partition_partials(const unsigned short* __restrict__ lo,
                                   const int* __restrict__ bucket_start, int G, int S,
                                   int count, Columns cols, int n_int, int n_float,
                                   unsigned long long* __restrict__ scratch) {
    extern __shared__ unsigned long long smem[];
    const int C = count + n_int + n_float;
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int p = blockIdx.x;
    const int w0 = p * S;
    const int Wc = min(S, G - w0);
    unsigned long long* grid = smem + (size_t)warp * C * S;
    unsigned long long* stage = smem + (size_t)warps * C * S + (size_t)warp * C * STAGE_ROWS;

    zero_smem(smem, smem_words(warps, C, S));
    __syncthreads();

    const long long start = bucket_start[p];
    const long long len = bucket_start[p + 1] - start;
    const long long begin = start + len * blockIdx.y / gridDim.y;
    const long long end = start + len * (blockIdx.y + 1) / gridDim.y;
    // a warp takes rows base + u * warp_step + lane, u < UNROLL
    const long long warp_step = (long long)warps * 32;
    for (long long base = begin + warp * 32; base < end; base += UNROLL * warp_step) {
        int b[UNROLL];
        long long r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            r[u] = base + u * warp_step + lane;
            b[u] = r[u] < end ? (int)lo[r[u]] : -1;
        }
        warp_add<UNROLL>(b, r, lane, count, cols, n_int, n_float, S, grid, stage);
    }
    __syncthreads();
    fold_warps(smem, warps, C, count + n_int, S, Wc, G, w0,
               scratch + (size_t)blockIdx.y * C * G);
}

extern "C" {

int grid_partition_smem_budget(void) { return SMEM_BUDGET; }

int grid_partition_max_cols(void) { return MAX_COLS; }

// Phase 1a: counts [P, n_seg] int32.  Returns cudaGetLastError(), or -1
// when the arguments do not fit.
int grid_partition_count(const int* idx, long long n, int G, int shift, int P,
                         long long seg_rows, int n_seg, int warps, int* counts, void* stream) {
    const size_t smem = (size_t)P * sizeof(int);
    if (G < 1 || P < 1 || shift < 0 || shift > 16 || ((long long)P << shift) < G ||
        seg_rows < 32 || seg_rows % 32 || n_seg < 1 || warps < 1 || warps > 32 ||
        n < 0 || n > 0x7fffffffLL || smem > SMEM_BUDGET)
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = allow_smem(partition_count, smem);
    if (e != cudaSuccess) return (int)e;
    partition_count<<<n_seg, warps * 32, smem, s>>>(idx, n, G, shift, P, seg_rows, n_seg,
                                                    counts);
    return (int)cudaGetLastError();
}

// Phase 1b, phase 2 and the fold.
//   offsets: device [P, n_seg] int32, exclusive offsets of the counts in
//            bucket-major order; bucket_start: device [P + 1] int32;
//   int_cols / float_cols / float_is_f32: HOST arrays as in grid_additive;
//   bucketed_int / bucketed_float: HOST arrays of device pointers to the
//            bucketed copies (as long as the rows kept), lo: device uint16;
//   scratch: device [chunks, C, G] 8-byte words.
int grid_partition_finish(const int* idx, long long n, int G, int shift, int P,
                          long long seg_rows, int n_seg, int warps1, const int* offsets,
                          const int* bucket_start, int count,
                          const void* const* int_cols, int n_int,
                          const void* const* float_cols, const int* float_is_f32, int n_float,
                          void* const* bucketed_int, void* const* bucketed_float,
                          unsigned short* lo, int chunks, int warps2,
                          unsigned long long* scratch, long long* out_int, double* out_float,
                          void* stream) {
    const int C = count + n_int + n_float;
    const int S = 1 << shift;
    const size_t smem1 = scatter_smem(warps1, P);
    const size_t smem2 = smem_words(warps2, C, S) * sizeof(unsigned long long);
    if (G < 1 || P < 1 || shift < 0 || shift > 16 || ((long long)P << shift) < G ||
        C < 1 || n_int + n_float > MAX_COLS || seg_rows < 32 || seg_rows % 32 || n_seg < 1 ||
        warps1 < 1 || warps1 > 32 || warps2 < 1 || warps2 > 32 || chunks < 1 ||
        chunks > 65535 || n < 0 || n > 0x7fffffffLL || (long long)C * G > 0x7fffffffLL ||
        smem1 > SMEM_BUDGET || smem2 > SMEM_BUDGET)
        return -1;
    const Columns cols = make_columns(int_cols, n_int, float_cols, float_is_f32, n_float);
    OutColumns out;
    for (int k = 0; k < n_int; ++k) out.ptr[k] = bucketed_int[k];
    for (int k = 0; k < n_float; ++k) out.ptr[n_int + k] = bucketed_float[k];
    const Columns bucketed = make_columns((const void* const*)bucketed_int, n_int,
                                          (const void* const*)bucketed_float, float_is_f32,
                                          n_float);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = allow_smem(partition_scatter, smem1);
    if (e != cudaSuccess) return (int)e;
    partition_scatter<<<n_seg, warps1 * 32, smem1, s>>>(
        idx, n, G, shift, P, seg_rows, n_seg, offsets, cols, n_int + n_float, out, lo);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = allow_smem(partition_partials, smem2);
    if (e != cudaSuccess) return (int)e;
    partition_partials<<<dim3((unsigned)P, (unsigned)chunks), warps2 * 32, smem2, s>>>(
        lo, bucket_start, G, S, count, bucketed, n_int, n_float, scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)launch_fold(scratch, chunks, C * G, (count + n_int) * G, out_int, out_float, s);
}

const char* grid_partition_error_string(int code) {
    if (code == -1) return "arguments do not fit the grid_partition kernel";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
