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
// the floor at the copy bandwidth it measures).  Measured: 0.97 ms per 1e8
// rows at G = 103 on an NVIDIA H100 80GB HBM3, power limit 700.00 W.
// The column pointers reach the kernel in a Columns struct passed by value
// as a kernel parameter, so no column is stacked or copied first.
// A per-CTA grid updated with shared-memory atomics would instead be bound
// by atomic contention when G is small (G = 1 for df.sum: every lane of
// every warp hits one word).  The design is the ordered scheme of
// grid_common.cuh with one window covering the whole grid: every warp owns
// a private [C, G] grid, a bin costs one update per warp step however many
// lanes hit it, the CTA folds its warps in warp order and a second kernel
// folds the CTA partials in CTA order.
// Every addition happens in an order fixed by (N, G, the column count and
// the SM count), so float results are reproducible from run to run and
// integer results are exact.
//
// Shared-memory budget: SMEM_BUDGET bytes per CTA (below the 227 KB a
// Hopper block may take as dynamic shared memory).  A CTA holds
// warps * C * (G + STAGE_ROWS) 8-byte words; the wrapper picks warps in
// [1, 8] to fit, so any G with C * (G + STAGE_ROWS) * 8 <= SMEM_BUDGET runs
// here.  Wider
// grids go to grid_window.cu (B2) or grid_partition.cu (B3).

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

extern "C" {

int grid_additive_smem_budget(void) { return SMEM_BUDGET; }

int grid_additive_max_cols(void) { return MAX_COLS; }

// Launches both kernels on `stream`; returns cudaGetLastError() (0 on
// success), or -1 when the arguments do not fit the kernel.
//   int_cols / float_cols: HOST arrays of device pointers;
//   float_is_f32: HOST array, one flag per float column;
//   scratch: device [n_ctas, C, G] 8-byte words, C = count + n_int + n_float.
//   unroll: rows per lane and warp step, 1 or UNROLL.
int grid_additive_run(const int* idx, long long n, int G, int count,
                      const void* const* int_cols, int n_int,
                      const void* const* float_cols, const int* float_is_f32, int n_float,
                      int n_ctas, int warps, int unroll, unsigned long long* scratch,
                      long long* out_int, double* out_float, void* stream) {
    const int C = count + n_int + n_float;
    if (G < 1 || C < 1 || n_int + n_float > MAX_COLS || warps < 1 || warps > 32 ||
        n_ctas < 1 || n < 0 || (unroll != 1 && unroll != UNROLL))
        return -1;
    const size_t smem = smem_words(warps, C, G) * sizeof(unsigned long long);
    if (smem > SMEM_BUDGET) return -1;
    const Columns cols = make_columns(int_cols, n_int, float_cols, float_is_f32, n_float);
    cudaStream_t s = (cudaStream_t)stream;
    auto kernel = unroll == 1 ? grid_partials<1> : grid_partials<UNROLL>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<n_ctas, warps * 32, smem, s>>>(idx, n, G, count, cols, n_int, n_float, scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)launch_fold(scratch, n_ctas, C * G, (count + n_int) * G, out_int, out_float, s);
}

const char* grid_additive_error_string(int code) {
    if (code == -1) return "arguments do not fit the grid_additive kernel";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
