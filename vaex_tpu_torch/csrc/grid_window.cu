// Per-bin sums for grids too wide for one warp-private grid (kernel B2), for
// Hopper (sm_90a).  Built by nvcc into a shared library with a plain C
// interface and loaded with ctypes (vaex_tpu_torch/ops/grid_window.py).
//
// Replaces the TPU kernel vaex_tpu/ops/pallas_gridagg.py:_channels2_kernel
// (via fused_additive_two_level_channels).  That kernel factored the grid
// as hi * 128 + lo so the one-hot matmul on the MXU stayed narrow, and
// split the values into limbs; neither carries over.  The contract is
// B1's (grid_additive.cu): idx [N] int32, rows outside [0, G) drop; int64
// columns summed mod 2^64; f32/f64 columns summed in f64 with NaN adding
// nothing; an implicit count.
//
// The design: the grid is cut into n_win bin windows of W bins; a CTA keeps
// one [C, W] window grid in shared memory that all its warps share, and
// blockIdx.x is the window, blockIdx.y the row slice.  The CTAs of one row
// slice are launched next to each other and walk the same rows, so idx is
// read from HBM about once and from L2 by the other windows; a value
// column is loaded only by the window its row falls in, UNROLL rows per
// lane at a time.  Every lane adds its row with native 64-bit shared-memory
// atomics (atom.shared.add.u64 / .f64); the CTAs' window partials are
// folded in slice order by fold_partials.  Integer sums are exact.  Float
// sums are NOT reproducible from run to run: the order in which the warps
// of a CTA reach a word varies.
//
// Why atomics, where B1 and B3 keep warp-private grids in a fixed order:
// warp-private windows leave room for few warps per SM while every window
// still walks every row, and with them this kernel was slower than B1 or
// B3 at every G on an H100 (PERF.md, section 6).  A shared window is
// C * W words for the whole CTA, so W is about 8x wider at 32 warps per SM.
//
// What bounds it on an H100: every window's warps step through every row,
// so the work per row grows with n_win (idx from L2, the compare and the
// skip of rows outside the window), while the HBM traffic stays near B1's
// 12-20 bytes per row.  The plan (ops/grid_plan.py) gives B2 the grids up
// to a measured number of windows and hands wider ones to the partitioned
// kernel B3 (grid_partition.cu).

#include "grid_common.cuh"

__global__ void window_partials(const int* __restrict__ idx, long long n, int G, int W,
                                int count, Columns cols, int n_int, int n_float,
                                unsigned long long* __restrict__ scratch) {
    extern __shared__ unsigned long long smem[];
    const int C = count + n_int + n_float;
    const int C_int = count + n_int;
    const int w0 = blockIdx.x * W;
    const int Wc = min(W, G - w0);
    double* grid_f = reinterpret_cast<double*>(smem + (size_t)C_int * W);

    zero_smem(smem, (size_t)C * W);
    __syncthreads();

    // a thread takes rows base + u * step, u < UNROLL
    const long long step = (long long)gridDim.y * blockDim.x;
    for (long long base = (long long)blockIdx.y * blockDim.x + threadIdx.x; base < n;
         base += UNROLL * step) {
        int b[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long r = base + u * step;
            b[u] = -1;
            if (r < n) {
                // unsigned: idx below w0, negative idx included, wraps past Wc
                const unsigned d = (unsigned)__ldg(idx + r) - (unsigned)w0;
                if (d < (unsigned)Wc) b[u] = (int)d;
            }
        }
        if (count) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                if (b[u] >= 0) atomicAdd(smem + b[u], 1ull);
        }
        for (int k = 0; k < n_int; ++k) {
            long long v[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                v[u] = b[u] >= 0 ? __ldg((const long long*)cols.ptr[k] + base + u * step) : 0;
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                if (b[u] >= 0)
                    atomicAdd(smem + (size_t)(count + k) * W + b[u], (unsigned long long)v[u]);
        }
        for (int k = 0; k < n_float; ++k) {
            const void* col = cols.ptr[n_int + k];
            const int f32 = cols.is_f32[n_int + k];
            double v[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                v[u] = b[u] >= 0 ? load_float(col, f32, base + u * step) : 0.0;
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                if (b[u] >= 0) atomicAdd(grid_f + (size_t)k * W + b[u], v[u]);
        }
    }
    __syncthreads();
    fold_warps(smem, 1, C, C_int, W, Wc, G, w0, scratch + (size_t)blockIdx.y * C * G);
}

extern "C" {

int grid_window_smem_budget(void) { return SMEM_BUDGET; }

int grid_window_max_cols(void) { return MAX_COLS; }

// Launches the window kernel on a (n_win, n_slices) grid and the fold on
// `stream`; returns cudaGetLastError() (0 on success), or -1 when the
// arguments do not fit the kernel.
//   int_cols / float_cols: HOST arrays of device pointers;
//   float_is_f32: HOST array, one flag per float column;
//   scratch: device [n_slices, C, G] 8-byte words, C = count + n_int + n_float.
int grid_window_run(const int* idx, long long n, int G, int W, int count,
                    const void* const* int_cols, int n_int,
                    const void* const* float_cols, const int* float_is_f32, int n_float,
                    int n_slices, int warps, unsigned long long* scratch,
                    long long* out_int, double* out_float, void* stream) {
    const int C = count + n_int + n_float;
    if (G < 1 || W < 1 || C < 1 || n_int + n_float > MAX_COLS || warps < 1 || warps > 32 ||
        n_slices < 1 || n_slices > 65535 || n < 0 || (long long)C * G > 0x7fffffffLL)
        return -1;
    const long long n_win = (G + (long long)W - 1) / W;
    const size_t smem = (size_t)C * W * sizeof(unsigned long long);
    if (smem > SMEM_BUDGET || n_win > 0x7fffffffLL) return -1;
    const Columns cols = make_columns(int_cols, n_int, float_cols, float_is_f32, n_float);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = allow_smem(window_partials, smem);
    if (e != cudaSuccess) return (int)e;
    window_partials<<<dim3((unsigned)n_win, (unsigned)n_slices), warps * 32, smem, s>>>(
        idx, n, G, W, count, cols, n_int, n_float, scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)launch_fold(scratch, n_slices, C * G, (count + n_int) * G, out_int, out_float,
                            s);
}

const char* grid_window_error_string(int code) {
    if (code == -1) return "arguments do not fit the grid_window kernel";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
