// Per-bin sums of moment terms for grids too wide for one warp-private grid
// (kernel B5), for Hopper (sm_90a).  Built by nvcc into a shared library
// with a plain C interface and loaded with ctypes
// (vaex_tpu_torch/ops/grid_moments.py, which holds the contract and the
// plain version).
//
// Replaces the TPU kernel vaex_tpu/ops/pallas_gridagg.py:_agg2_kernel (via
// fused_additive_two_level).  That kernel factored the grid as hi * 128 + lo
// so the MXU's one-hot stayed narrow, and split every value into three bf16
// parts for it; neither carries over.  Like B4 (grid_moments.cu) it forms
// the term columns in registers from the base columns instead of reading
// columns formed in device memory.
//
// The design is B2's (grid_window.cu): the grid is cut into n_win bin
// windows of W bins; a CTA keeps one [C, W] window grid in shared memory
// that all its warps share (count terms as integer words, then the float
// terms as doubles); blockIdx.x is the window, blockIdx.y the row slice.
// The CTAs of one row slice walk the same rows, so idx is read from HBM
// about once and from L2 by the other windows; a row's bases are loaded only
// by the window its bin falls in.  Every lane adds its row's terms with
// native 64-bit shared-memory atomics (atom.shared.add.u64 / .f64); the
// window partials are folded in slice order by launch_fold.  Counts are
// exact.  Float sums are NOT reproducible from run to run: the order in
// which the warps of a CTA reach a word varies.
//
// What bounds it on an H100: the shared-memory atomics, one per term and
// row (6 for corr), and the walk of every row by every window; the HBM
// traffic stays near 4 + 8 per base bytes/row.  Past a measured number of
// windows ops/grid_plan.py:moment_strategy hands the grid to the
// partitioned kernel B3 (grid_partition.cu) over formed term columns.

#include "moments_common.cuh"

template <int NB>
__global__ void moment_window_partials(const int* __restrict__ idx, long long n, int G, int W,
                                       Bases bases, Terms terms, int n_count, int n_float,
                                       unsigned long long* __restrict__ scratch) {
    extern __shared__ unsigned long long smem[];
    const int C = n_count + n_float;
    const int w0 = blockIdx.x * W;
    const int Wc = min(W, G - w0);
    double* grid_f = reinterpret_cast<double*>(smem + (size_t)n_count * W);

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
        double v[UNROLL][BASE_SLOTS(NB)];
        unsigned missing[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            missing[u] = 0u;
            if (b[u] >= 0) {
                missing[u] = load_row<NB>(bases, base + u * step, v[u]);
            } else {
#pragma unroll
                for (int j = 0; j < BASE_SLOTS(NB); ++j) v[u][j] = 0.0;
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (b[u] < 0) continue;
            for (int k = 0; k < n_count; ++k)
                if (!(terms.need[k] & missing[u])) atomicAdd(smem + (size_t)k * W + b[u], 1ull);
            for (int k = 0; k < n_float; ++k)
                if (!(terms.need[n_count + k] & missing[u]))
                    atomicAdd(grid_f + (size_t)k * W + b[u],
                              term_value<NB>(terms, n_count + k, v[u], missing[u]));
        }
    }
    __syncthreads();
    fold_warps(smem, 1, C, n_count, W, Wc, G, w0, scratch + (size_t)blockIdx.y * C * G);
}

extern "C" {

MOMENT_LIBRARY_INFO(grid_moments_window)

// Launches the window kernel on a (n_win, n_slices) grid and the fold on
// `stream`; returns cudaGetLastError() (0 on success), or -1 when the
// arguments do not fit the kernel.  Arguments as grid_moments_run, with
//   W: bins per window; n_slices: row slices (the partials folded);
//   scratch: device [n_slices, C, G] 8-byte words.
int grid_moments_window_run(const int* idx, long long n, int G, int W,
                            const void* const* base_ptrs, const int* base_kinds, int nb,
                            const int* term_a, const int* term_b, const unsigned* term_need,
                            int n_count, int n_float, int n_slices, int warps,
                            unsigned long long* scratch, long long* out_int, double* out_float,
                            void* stream) {
    Bases bases;
    Terms terms;
    if (G < 1 || W < 1 || n < 0 || warps < 1 || warps > 32 || n_slices < 1 ||
        n_slices > 65535 ||
        !make_tables(base_ptrs, base_kinds, nb, term_a, term_b, term_need, n_count, n_float,
                     &bases, &terms))
        return -1;
    const int C = n_count + n_float;
    const long long n_win = (G + (long long)W - 1) / W;
    const size_t smem = (size_t)C * W * sizeof(unsigned long long);
    if (smem > SMEM_BUDGET || (long long)C * G > 0x7fffffffLL || n_win > 0x7fffffffLL)
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    auto kernel = FOR_NB(moment_window_partials, nb);
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((unsigned)n_win, (unsigned)n_slices), warps * 32, smem, s>>>(
        idx, n, G, W, bases, terms, n_count, n_float, scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)launch_fold(scratch, n_slices, C * G, n_count * G, out_int, out_float, s);
}

}  // extern "C"
