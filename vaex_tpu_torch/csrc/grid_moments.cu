// Per-bin sums of moment terms (kernel B4), for Hopper (sm_90a).  Built by
// nvcc into a shared library with a plain C interface and loaded with ctypes
// (vaex_tpu_torch/ops/grid_moments.py, which holds the contract and the
// plain version).
//
// Replaces the TPU kernel vaex_tpu/ops/pallas_gridagg.py:_agg_kernel (via
// fused_additive_pallas).  That kernel summed A float64 columns per bin,
// formed in XLA before it ran (x, x^2, x*y, ...), as a compensated one-hot
// matmul of hi/lo f32 halves, because the MXU has no f64.  Hopper adds f64
// natively, so nothing of the split or the one-hot carries over; and the
// columns are formed here, in registers, from the 1-2 base columns each
// statistic reads: var(x) reads 8 bytes of x per row, where its three
// formed columns would be 24 written and 24 read again.
//
// The design is B1's ordered scheme (grid_common.cuh): every warp owns a
// private [C, G] grid in shared memory (count terms as integer words, then
// the float terms as doubles); a lane loads UNROLL rows' bin and bases at
// once, then, row step by row step, __match_any_sync groups the lanes that
// share a bin; a count term adds the popcount of the group's lanes whose
// row is valid for it (exact), a float term stages every lane's value in
// shared memory and the group's lowest lane adds them in lane order; where
// the whole warp shares one bin (G = 1, skewed keys), a fixed shuffle tree
// adds them instead of one lane.  The CTA folds its warps in warp order
// (fold_warps) and a second kernel folds the CTA partials in CTA order
// (launch_fold).  Every addition happens in an order fixed by the launch
// arguments and the card: float sums are reproducible from run to run,
// counts exact.
//
// What bounds it on an H100: the HBM read of idx and the bases, 4 + 8 per
// base bytes/row (12 for var of an f64, 20 for corr), while the grid fits
// few warps per SM; past some G the window kernel B5 (grid_moments_window.cu)
// is faster, and ops/grid_plan.py:moment_strategy hands the grid over at
// the cut-off measured with scripts/sweep_grid_kernels.py.  Shared memory:
// warps * (C * G + n_float * 32) words, within SMEM_BUDGET.

#include "moments_common.cuh"

template <int NB>
__global__ void moment_partials(const int* __restrict__ idx, long long n, int G, Bases bases,
                                Terms terms, int n_count, int n_float,
                                unsigned long long* __restrict__ scratch) {
    extern __shared__ unsigned long long smem[];
    const int C = n_count + n_float;
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    unsigned long long* grid = smem + (size_t)warp * C * G;
    double* grid_f = reinterpret_cast<double*>(grid + (size_t)n_count * G);
    // [n_float, UNROLL, 32]: every float term of the warp's UNROLL rows
    double* stage = reinterpret_cast<double*>(smem + (size_t)warps * C * G) +
                    (size_t)warp * n_float * STAGE_ROWS;

    zero_smem(smem, (size_t)warps * ((size_t)C * G + (size_t)n_float * STAGE_ROWS));
    __syncthreads();

    // a warp takes rows base + u * warp_step + lane, u < UNROLL
    const long long warp_step = (long long)gridDim.x * warps * 32;
    for (long long base = ((long long)blockIdx.x * warps + warp) * 32; base < n;
         base += UNROLL * warp_step) {  // trip count is uniform across the warp
        int b[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long r = base + u * warp_step + lane;
            b[u] = -1;
            if (r < n) {
                const int t = __ldg(idx + r);
                if ((unsigned)t < (unsigned)G) b[u] = t;
            }
        }
        // every load of the UNROLL rows is issued before any is used
        double v[UNROLL][BASE_SLOTS(NB)];
        unsigned missing[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            missing[u] = 0u;
            if (b[u] >= 0) {
                missing[u] = load_row<NB>(bases, base + u * warp_step + lane, v[u]);
            } else {
#pragma unroll
                for (int j = 0; j < BASE_SLOTS(NB); ++j) v[u][j] = 0.0;
            }
        }
        for (int k = 0; k < n_float; ++k) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                stage[(k * UNROLL + u) * 32 + lane] =
                    b[u] >= 0 ? term_value<NB>(terms, n_count + k, v[u], missing[u]) : 0.0;
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (!__any_sync(FULL_MASK, b[u] >= 0)) continue;  // uniform across the warp
            const unsigned group = __match_any_sync(FULL_MASK, b[u]);
            if (group == FULL_MASK) {
                // the whole warp in one bin (G = 1, or skewed keys): uniform,
                // and summed by a fixed shuffle tree instead of one lane
                for (int k = 0; k < n_count; ++k) {
                    const unsigned ok = __ballot_sync(FULL_MASK, !(terms.need[k] & missing[u]));
                    if (lane == 0) grid[(size_t)k * G + b[u]] += (unsigned long long)__popc(ok);
                }
                for (int k = 0; k < n_float; ++k) {
                    double s = stage[(k * UNROLL + u) * 32 + lane];
                    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
                    if (lane == 0) grid_f[(size_t)k * G + b[u]] += s;
                }
            } else {
                const bool lead = b[u] >= 0 && lane == __ffs(group) - 1;
                for (int k = 0; k < n_count; ++k) {
                    const unsigned ok =
                        __ballot_sync(FULL_MASK, b[u] >= 0 && !(terms.need[k] & missing[u]));
                    if (lead)
                        grid[(size_t)k * G + b[u]] += (unsigned long long)__popc(group & ok);
                }
                if (lead) {
                    for (int k = 0; k < n_float; ++k) {
                        const double* row = stage + (k * UNROLL + u) * 32;
                        double s = 0.0;
                        for (unsigned m = group; m; m &= m - 1) s += row[__ffs(m) - 1];
                        grid_f[(size_t)k * G + b[u]] += s;
                    }
                }
            }
            __syncwarp();  // the next step's leaders may add to the same words
        }
    }
    __syncthreads();
    fold_warps(smem, warps, C, n_count, G, G, G, 0, scratch + (size_t)blockIdx.x * C * G);
}

extern "C" {

MOMENT_LIBRARY_INFO(grid_moments)

// Launches both kernels on `stream`; returns cudaGetLastError() (0 on
// success), or -1 when the arguments do not fit the kernel.
//   base_ptrs / base_kinds: HOST arrays, nb entries (BASE_F64/F32/I64);
//   term_a / term_b / term_need: HOST arrays, n_count count terms, then
//     n_float float terms;
//   W: must equal G (the window kernel's argument, one window here);
//   n_ctas: CTAs at most; the launch takes fewer where fewer of them fit an
//     SM at once than the plan assumed (it counts shared memory only), so
//     that no second wave of CTAs runs on a part of the card;
//   scratch: device [n_ctas, C, G] 8-byte words, C = n_count + n_float;
//   out_int [n_count, G] int64, out_float [n_float, G] float64.
int grid_moments_run(const int* idx, long long n, int G, int W, const void* const* base_ptrs,
                     const int* base_kinds, int nb, const int* term_a, const int* term_b,
                     const unsigned* term_need, int n_count, int n_float, int n_ctas,
                     int warps, unsigned long long* scratch, long long* out_int,
                     double* out_float, void* stream) {
    Bases bases;
    Terms terms;
    if (G < 1 || W != G || n < 0 || n_ctas < 1 || warps < 1 || warps > 32 ||
        !make_tables(base_ptrs, base_kinds, nb, term_a, term_b, term_need, n_count, n_float,
                     &bases, &terms))
        return -1;
    const int C = n_count + n_float;
    const size_t smem = (size_t)warps * ((size_t)C * G + (size_t)n_float * STAGE_ROWS) *
                        sizeof(unsigned long long);
    if (smem > SMEM_BUDGET) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    auto kernel = FOR_NB(moment_partials, nb);
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    int device = 0, sm_count = 0, per_sm = 0;
    if ((e = cudaGetDevice(&device)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem)) !=
            cudaSuccess)
        return (int)e;
    if (per_sm < 1) return -1;
    if (n_ctas > per_sm * sm_count) n_ctas = per_sm * sm_count;
    kernel<<<n_ctas, warps * 32, smem, s>>>(idx, n, G, bases, terms, n_count, n_float, scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)launch_fold(scratch, n_ctas, C * G, n_count * G, out_int, out_float, s);
}

}  // extern "C"
