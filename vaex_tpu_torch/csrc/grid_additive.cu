// Per-bin sums of int64 and float columns plus an implicit count, for Hopper
// (sm_90a).  Built by nvcc into a shared library with a plain C interface
// and loaded with ctypes (vaex_tpu_torch/ops/grid_additive.py).
//
// Replaces the TPU kernel vaex_tpu/ops/pallas_gridagg.py:_channels_kernel
// (via fused_additive_channels).  That kernel split every value into 8-bit
// limbs and block-quantised floats so a bf16 one-hot matmul could add them
// exactly; Hopper has native int64 and f64, so this kernel adds the raw
// values and keeps nothing of the limb scheme.
//
// Contract (the plain version is grid_additive_reference in the wrapper):
//   idx [N] int32; rows whose idx lies outside [0, G) add nothing.
//   out_int   [count + n_int, G] int64: row 0 is the number of rows with
//             0 <= idx < G when `count` is set, then one row per int64
//             column; sums wrap mod 2^64 like the reference's C++ int64
//             accumulation.
//   out_float [n_float, G] float64: f32 columns are widened on load; NaN
//             adds nothing (sums skip NaN, as the reference's do).
//
// What bounds it on an H100: the HBM read of idx and the value columns,
// 12 bytes/row for the main path (i32 bin + f64 value), up to about 20
// with an int64 column too; at the datasheet peak of 3.35 TB/s for the
// H100 SXM (700 W) that is 0.36 ms per 1e8 rows (chip_smoke.py also prints
// the floor at the copy bandwidth it measures).  Measured on an NVIDIA H100
// 80GB HBM3, power limit 700.00 W, per 1e8 rows at G = 103 with count +
// f64: 0.567 ms on the lane route, 0.955 on the warp route (PERF.md).
// The column pointers reach the kernel in a Columns struct passed by value
// as a kernel parameter, so no column is stacked or copied first.
// Every addition happens in an order fixed by (N, G, the column count and
// the SM count), so float results are reproducible from run to run and
// integer results are exact.  A per-CTA grid updated with shared-memory
// atomics would instead be bound by atomic contention when G is small
// (G = 1 for df.sum: every lane of every warp hits one word).  Two routes,
// which the wrapper's plan (ops/grid_additive.py:route) picks by G and C:
//
// The lane route ("b1", lane_partials): every lane owns a private grid, laid
// out [C][G][32 lanes] so a warp's 32 lanes touch 32 banks: a 32-bit count
// and an 8-byte word per column for each bin.  A lane adds its own rows
// with plain read-modify-writes: no __match_any_sync, no staging, no
// __syncwarp, no atomics.  A lane issues the loads of LANE_UNROLL rows of
// idx and of the first column before its first add, so that the few warps
// its shared memory leaves an SM (count + f64 at G = 103: 39.5 KB a warp,
// five warps) still keep enough bytes in flight.  At G = 1 (df.sum, the
// isin count) a lane sums its step's rows in registers and makes one add.
// The CTA folds its lanes in lane order, its warps in warp order (a warp
// per output word: lane l adds warp grids 0, 1, ... of its lane's column,
// then a fixed shuffle tree), and a second kernel folds the CTA partials in
// CTA order.  A lane's 32-bit count takes fewer than 2^32 rows of a call.
//
// The warp route ("b1-warp", grid_partials): the ordered scheme of
// grid_common.cuh with one window covering the whole grid: every warp owns
// a private [C, G] grid, a bin costs one update per warp step however many
// lanes hit it, the CTA folds its warps in warp order and a second kernel
// folds the CTA partials in CTA order.  It takes the grids whose lane grids
// would leave an SM too few warps (PERF.md, section 6).
//
// Shared-memory budget: the warp route holds warps * C * (G + STAGE_ROWS)
// 8-byte words within SMEM_BUDGET bytes per CTA (the wrapper picks warps in
// [1, 8] to fit, so any G with C * (G + STAGE_ROWS) * 8 <= SMEM_BUDGET runs
// here); the lane route holds warps * 32 * G * (4 + 8 * columns) bytes
// within CLUSTER_SMEM (227 KiB).  Wider grids go to grid_window.cu (B2) or
// grid_partition.cu (B3).

#include "grid_common.cuh"

// One CTA: warps_per_cta private warp grids, grid-stride over rows in warp
// steps of U * 32, then one [C, G] partial written to scratch[blockIdx.x].
template <int U>
__global__ void grid_partials(const int* __restrict__ idx, long long n, int G, int count,
                              Columns cols, int n_int, int n_float,
                              unsigned long long* __restrict__ scratch) {
    extern __shared__ unsigned long long smem[];
    const int C = count + n_int + n_float;
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    unsigned long long* grid = smem + (size_t)warp * C * G;
    unsigned long long* stage = smem + (size_t)warps * C * G + (size_t)warp * C * STAGE_ROWS;

    zero_smem(smem, smem_words(warps, C, G));
    __syncthreads();

    // a warp takes rows base + u * warp_step + lane, u < U
    const long long warp_step = (long long)gridDim.x * warps * 32;
    for (long long base = ((long long)blockIdx.x * warps + warp) * 32; base < n;
         base += U * warp_step) {  // trip count is uniform across the warp
        int b[U];
        long long r[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            r[u] = base + u * warp_step + lane;
            b[u] = -1;
            if (r[u] < n) {
                const int t = __ldg(idx + r[u]);
                if ((unsigned)t < (unsigned)G) b[u] = t;
            }
        }
        warp_add(b, r, lane, count, cols, n_int, n_float, G, grid, stage);
    }
    __syncthreads();
    fold_warps(smem, warps, C, count + n_int, G, G, G, 0,
               scratch + (size_t)blockIdx.x * C * G);
}

// Rows a lane of the lane route takes per step.
#define LANE_UNROLL 32

// Words (8 bytes) of one warp's lane grids: [G][32] 32-bit counts when
// `count`, then [n_cols][G][32] 8-byte sums.
__host__ __device__ __forceinline__ size_t lane_words(int G, int count, int n_cols) {
    return (size_t)(count ? G * 16 : 0) + (size_t)n_cols * G * 32;
}

// Row u of the step into the lane's grid: bin b[u] (< 0: nothing), the
// value v[u]; at G = 1 the step's rows are summed in registers first, in u
// order, and added once.
template <int U, bool G1, class T>
__device__ __forceinline__ void lane_add(const int (&b)[U], const T (&v)[U], T* grid, int lane) {
    if constexpr (G1) {
        T s = 0;
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (b[u] == 0) s += v[u];
        grid[lane] += s;
    } else {
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (b[u] >= 0) grid[(size_t)b[u] * 32 + lane] += v[u];
    }
}

// The step's bins, -1 for a row past n or outside [0, G).
template <int U>
__device__ __forceinline__ void drop_rows(int (&b)[U], long long base, long long warp_step,
                                          long long n, int G) {
#pragma unroll
    for (int u = 0; u < U; ++u)
        if (base + u * warp_step >= n || (unsigned)b[u] >= (unsigned)G) b[u] = -1;
}

template <int U, bool G1>
__device__ __forceinline__ void lane_count(const int (&b)[U], unsigned* grid, int lane) {
    unsigned ones[U];
#pragma unroll
    for (int u = 0; u < U; ++u) ones[u] = 1u;
    lane_add<U, G1>(b, ones, grid, lane);
}

// One CTA of the lane route: every lane a private grid (see the top of this
// file), grid-stride over rows in warp steps of U * 32, then one [C, G]
// partial written to scratch[blockIdx.x].
template <bool G1>
__global__ void __launch_bounds__(256)
lane_partials(const int* __restrict__ idx, long long n, int G, int count, Columns cols, int n_int,
              int n_float, unsigned long long* __restrict__ scratch) {
    constexpr int U = LANE_UNROLL;
    extern __shared__ unsigned long long smem[];
    const int n_cols = n_int + n_float;
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const size_t words = lane_words(G, count, n_cols);
    unsigned* counts = reinterpret_cast<unsigned*>(smem + (size_t)warp * words);
    unsigned long long* sums = smem + (size_t)warp * words + (count ? (size_t)G * 16 : 0);

    zero_smem(smem, (size_t)warps * words);
    __syncthreads();

    // a lane takes rows base + u * warp_step, u < U.  Every load is
    // unconditional (a row past n reads row n - 1 and adds nothing), so the
    // compiler issues all of a step's loads before the first add.
    const long long warp_step = (long long)gridDim.x * warps * 32;
    for (long long base = ((long long)blockIdx.x * warps + warp) * 32 + lane;
         base - lane < n; base += U * warp_step) {
        long long r[U];
        int b[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            r[u] = min(base + u * warp_step, n - 1);
            b[u] = __ldg(idx + r[u]);
        }
        // each column's loads are issued before the adds that wait on idx
        for (int k = 0; k < n_cols; ++k) {
            unsigned long long* grid = sums + (size_t)k * G * 32;
            unsigned long long v[U];
            if (k < n_int) {
                const long long* col = (const long long*)cols.ptr[k];
#pragma unroll
                for (int u = 0; u < U; ++u) v[u] = (unsigned long long)__ldg(col + r[u]);
            } else if (cols.fkind[k] == FLOAT_F32) {
                const float* col = (const float*)cols.ptr[k];
#pragma unroll
                for (int u = 0; u < U; ++u)
                    v[u] = __double_as_longlong((double)__ldg(col + r[u]));
            } else if (cols.fkind[k] == FLOAT_I64) {
                const long long* col = (const long long*)cols.ptr[k];
#pragma unroll
                for (int u = 0; u < U; ++u)
                    v[u] = __double_as_longlong((double)__ldg(col + r[u]));
            } else {
                const unsigned long long* col = (const unsigned long long*)cols.ptr[k];
#pragma unroll
                for (int u = 0; u < U; ++u) v[u] = __ldg(col + r[u]);
            }
            if (k == 0) drop_rows(b, base, warp_step, n, G);
            if (k == 0 && count) lane_count<U, G1>(b, counts, lane);
            if (k < n_int) {
                lane_add<U, G1>(b, v, grid, lane);
            } else {
                double f[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    f[u] = __longlong_as_double((long long)v[u]);
                    f[u] = f[u] != f[u] ? 0.0 : f[u];  // NaN adds nothing
                }
                lane_add<U, G1>(b, f, reinterpret_cast<double*>(grid), lane);
            }
        }
        if (n_cols == 0) {
            drop_rows(b, base, warp_step, n, G);
            lane_count<U, G1>(b, counts, lane);
        }
    }
    __syncthreads();

    // a warp per output word: lane l adds its lane's word of warp grids
    // 0, 1, ... in order, then a fixed shuffle tree adds the lanes
    const int C = count + n_cols;
    unsigned long long* out = scratch + (size_t)blockIdx.x * C * G;
    for (int j = warp; j < C * G; j += warps) {
        const int c = j / G, bin = j - c * G;
        if (c < count + n_int) {
            unsigned long long s = 0ull;
            for (int w = 0; w < warps; ++w) {
                const unsigned long long* region = smem + (size_t)w * words;
                s += c < count ? (unsigned long long)reinterpret_cast<const unsigned*>(
                                     region)[(size_t)bin * 32 + lane]
                               : region[(count ? (size_t)G * 16 : 0) +
                                        ((size_t)(c - count) * G + bin) * 32 + lane];
            }
            for (int o = 16; o; o >>= 1) s += __shfl_down_sync(FULL_MASK, s, o);
            if (lane == 0) out[(size_t)c * G + bin] = s;
        } else {
            double s = 0.0;
            for (int w = 0; w < warps; ++w)
                s += reinterpret_cast<const double*>(
                    smem + (size_t)w * words + (count ? (size_t)G * 16 : 0))[
                    ((size_t)(c - count) * G + bin) * 32 + lane];
            for (int o = 16; o; o >>= 1) s += __shfl_down_sync(FULL_MASK, s, o);
            if (lane == 0) reinterpret_cast<double*>(out)[(size_t)c * G + bin] = s;
        }
    }
}

extern "C" {

int grid_additive_smem_budget(void) { return SMEM_BUDGET; }

int grid_additive_max_cols(void) { return MAX_COLS; }

int grid_additive_lane_unroll(void) { return LANE_UNROLL; }

// Launches both kernels on `stream`; returns cudaGetLastError() (0 on
// success), or -1 when the arguments do not fit the kernel.
//   int_cols / float_cols: HOST arrays of device pointers;
//   float_kinds: HOST array, one kind per float column (FLOAT_F64, FLOAT_F32
//     or FLOAT_I64: an int64 column summed as float64);
//   scratch: device [n_ctas, C, G] 8-byte words, C = count + n_int + n_float.
//   lane: the lane route (n < 2^32), else the warp route with `unroll` (1
//     or UNROLL) rows per lane and warp step.
int grid_additive_run(const int* idx, long long n, int G, int count,
                      const void* const* int_cols, int n_int,
                      const void* const* float_cols, const int* float_kinds, int n_float,
                      int n_ctas, int warps, int lane, int unroll,
                      unsigned long long* scratch, long long* out_int, double* out_float,
                      void* stream) {
    const int C = count + n_int + n_float;
    if (G < 1 || C < 1 || n_int + n_float > MAX_COLS || warps < 1 || warps > 32 ||
        n_ctas < 1 || n < 0 || (!lane && unroll != 1 && unroll != UNROLL))
        return -1;
    const Columns cols = make_columns(int_cols, n_int, float_cols, float_kinds, n_float);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e;
    if (lane) {
        const size_t smem = (size_t)warps * lane_words(G, count, n_int + n_float) * 8;
        if (smem > CLUSTER_SMEM || warps > 8 || n >= (1LL << 32)) return -1;
        auto kernel = G == 1 ? lane_partials<true> : lane_partials<false>;
        if ((e = allow_smem(kernel, smem)) != cudaSuccess) return (int)e;
        kernel<<<n_ctas, warps * 32, smem, s>>>(idx, n, G, count, cols, n_int, n_float, scratch);
    } else {
        const size_t smem = smem_words(warps, C, G) * sizeof(unsigned long long);
        if (smem > SMEM_BUDGET) return -1;
        auto kernel = unroll == 1 ? grid_partials<1> : grid_partials<UNROLL>;
        if ((e = allow_smem(kernel, smem)) != cudaSuccess) return (int)e;
        kernel<<<n_ctas, warps * 32, smem, s>>>(idx, n, G, count, cols, n_int, n_float, scratch);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)launch_fold(scratch, n_ctas, C * G, (count + n_int) * G, out_int, out_float, s);
}

const char* grid_additive_error_string(int code) {
    if (code == -1) return "arguments do not fit the grid_additive kernel";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
