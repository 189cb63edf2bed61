// Pieces shared by the grid kernels (grid_additive.cu, grid_window.cu,
// grid_partition.cu, and through moments_common.cuh grid_moments.cu and
// grid_moments_window.cu): the column table, the ordered warp-group update
// of a warp-private grid in shared memory, the combine of the lanes that
// share a bin before an atomic (struct Combine), the fold of a CTA's warp
// grids into a partial, and the fold of the partials.  Each kernel library
// includes this header and is built on its own
// (vaex_tpu_torch/ops/kernel_build.py hashes the header with each source).
//
// The ordered scheme, used by every kernel (ported from B1):
//   * every warp owns a private [C, W] grid of a bin window in shared
//     memory, so no two warps ever touch one word and no atomics are needed;
//   * inside a warp, __match_any_sync groups the lanes that share a bin; the
//     lowest lane of each group adds the group's values in lane order with a
//     plain read-modify-write;
//   * at the end the CTA folds its warps' grids in warp order into one
//     partial; fold_partials adds the partials in partial order.
// Every addition happens in an order fixed by the launch arguments, so
// float sums are reproducible from run to run and integer sums are exact
// (mod 2^64).
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SMEM_BUDGET (192 * 1024)
// the most dynamic shared memory a CTA may take on sm_90: the kernels that
// keep one CTA per SM (B2's cluster, B1's lane-private grids, B5's windows)
// take all of it, the others keep SMEM_BUDGET
#define CLUSTER_SMEM (227 * 1024)
#define MAX_COLS 32
#define FULL_MASK 0xffffffffu

struct Columns {
    const void* ptr[MAX_COLS];  // n_int int64 columns, then n_float float columns
    int is_f32[MAX_COLS];       // float columns only: 1 for float32, 0 for float64
};

// Host side: the column table from HOST arrays of device pointers.
static inline Columns make_columns(const void* const* int_cols, int n_int,
                                   const void* const* float_cols, const int* float_is_f32,
                                   int n_float) {
    Columns cols;
    for (int k = 0; k < n_int; ++k) {
        cols.ptr[k] = int_cols[k];
        cols.is_f32[k] = 0;
    }
    for (int k = 0; k < n_float; ++k) {
        cols.ptr[n_int + k] = float_cols[k];
        cols.is_f32[n_int + k] = float_is_f32[k];
    }
    return cols;
}

// Host side: opt in to more than 48 KiB of dynamic shared memory.
template <class Kernel>
static inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

__device__ __forceinline__ double load_float(const void* col, int is_f32, long long r) {
    double v = is_f32 ? (double)__ldg((const float*)col + r) : __ldg((const double*)col + r);
    return v != v ? 0.0 : v;  // NaN adds nothing
}

// Rows a warp takes per step and lane, at most: the loads of UNROLL rows
// are in flight together, which hides memory latency when shared memory
// leaves room for few warps.  Each warp stages [C, UNROLL * 32] words.
#define UNROLL 4
#define STAGE_ROWS (UNROLL * 32)

// Shared memory of a CTA: per warp a private [C, W] grid, then
// [C, STAGE_ROWS] staging words (one row per channel is spare for the count,
// which stages nothing).
__host__ __device__ __forceinline__ size_t smem_words(int warps, int C, int W) {
    return (size_t)warps * C * ((size_t)W + STAGE_ROWS);
}

__device__ __forceinline__ void zero_smem(unsigned long long* smem, size_t words) {
    // all-zero bits are 0 for both the integer and the double words
    for (size_t j = threadIdx.x; j < words; j += blockDim.x) smem[j] = 0ull;
}

// One warp step of U rows per lane: lane `lane` holds rows r[u] of the
// columns with bins b[u] of the window (b[u] < 0: the row adds nothing).
// Step by step in u order, the lowest lane of each __match_any_sync group
// adds the group's values, staged in shared memory, in lane order.  Rows
// [0, count + n_int) of the warp's grid are integer words, the rest
// doubles.  With U > 1 every value is first copied to the staging words
// with cp.async, so all U * n_cols loads of the lane are in flight at once
// (for few warps per SM); with U = 1 each column is loaded and staged in
// turn, which costs less where many warps hide the latency.
template <int U>
__device__ __forceinline__ void warp_add(const int (&b)[U], const long long (&r)[U],
                                         int lane, int count, const Columns& cols, int n_int,
                                         int n_float, int W, unsigned long long* grid,
                                         unsigned long long* stage) {
    static_assert(U <= UNROLL, "the staging words hold UNROLL rows per lane");
    bool some = false;
#pragma unroll
    for (int u = 0; u < U; ++u) some |= b[u] >= 0;
    if (!__any_sync(FULL_MASK, some)) return;  // uniform across the warp
    double* grid_f = reinterpret_cast<double*>(grid + (size_t)(count + n_int) * W);
    if constexpr (U == 1) {
        const int bin = b[0];
        const unsigned group = __match_any_sync(FULL_MASK, bin);
        const bool lead = bin >= 0 && lane == __ffs(group) - 1;
        if (count && lead) grid[bin] += (unsigned long long)__popc(group);
        for (int k = 0; k < n_int; ++k) {
            stage[lane] = bin >= 0 ? (unsigned long long)__ldg((const long long*)cols.ptr[k] + r[0])
                                   : 0ull;
            __syncwarp();
            if (lead) {
                unsigned long long s = 0ull;
                for (unsigned m = group; m; m &= m - 1) s += stage[__ffs(m) - 1];
                grid[(size_t)(count + k) * W + bin] += s;
            }
            __syncwarp();
        }
        double* stage_f = reinterpret_cast<double*>(stage);
        for (int k = 0; k < n_float; ++k) {
            stage_f[lane] = bin >= 0 ? load_float(cols.ptr[n_int + k], cols.is_f32[n_int + k], r[0])
                                     : 0.0;
            __syncwarp();
            if (lead) {
                double s = 0.0;
                for (unsigned m = group; m; m &= m - 1) s += stage_f[__ffs(m) - 1];
                grid_f[(size_t)k * W + bin] += s;
            }
            __syncwarp();
        }
        return;
    }
    const int n_cols = n_int + n_float;
    for (int k = 0; k < n_cols; ++k) {
        const int bytes = (k >= n_int && cols.is_f32[k]) ? 4 : 8;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            unsigned long long* slot = stage + (k * U + u) * 32 + lane;
            if (b[u] >= 0)
                __pipeline_memcpy_async(slot, (const char*)cols.ptr[k] + r[u] * bytes, bytes);
            else
                *slot = 0ull;  // as bits, 0 for int64, float and double alike
        }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const unsigned group = __match_any_sync(FULL_MASK, b[u]);
        if (b[u] >= 0 && lane == __ffs(group) - 1) {
            if (count) grid[b[u]] += (unsigned long long)__popc(group);
            for (int k = 0; k < n_int; ++k) {
                const unsigned long long* row = stage + (k * U + u) * 32;
                unsigned long long s = 0ull;
                for (unsigned m = group; m; m &= m - 1) s += row[__ffs(m) - 1];
                grid[(size_t)(count + k) * W + b[u]] += s;
            }
            for (int k = 0; k < n_float; ++k) {
                const unsigned long long* row = stage + ((n_int + k) * U + u) * 32;
                const bool f32 = cols.is_f32[n_int + k];
                double s = 0.0;
                for (unsigned m = group; m; m &= m - 1) {
                    const unsigned long long* w = row + __ffs(m) - 1;
                    double v = f32 ? (double)*reinterpret_cast<const float*>(w)
                                   : *reinterpret_cast<const double*>(w);
                    s += v != v ? 0.0 : v;  // NaN adds nothing
                }
                grid_f[(size_t)k * W + b[u]] += s;
            }
        }
        __syncwarp();  // the next step's leaders may add to the same words
    }
}

// The lanes that start a run of equal keys among neighbouring lanes.
__device__ __forceinline__ unsigned run_heads(int key, int lane) {
    const int before = __shfl_up_sync(FULL_MASK, key, 1);
    return __ballot_sync(FULL_MASK, lane == 0 || key != before);
}

// The first lane of the run that holds `lane`, and the lane past its end.
__device__ __forceinline__ void run_bounds(unsigned heads, int lane, int& first, int& end) {
    first = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
    const unsigned later = lane == 31 ? 0u : heads & (0xffffffffu << (lane + 1));
    end = later ? __ffs(later) - 1 : 32;
}

// How the lanes of a warp that hold the same bin become one atomic.  First
// the runs of neighbouring lanes with one bin (sorted or clustered keys: a
// ballot and, where a run is longer than one lane, a tree of shuffles).
// Then, where the warp still has several runs, __match_any_sync over the
// runs' first lanes finds the runs that share a bin (keys that pile on few
// bins in any order); its cost grows with the distinct bins of the warp,
// which is why the runs come first.  Every sum is taken in an order fixed
// by the lanes.
struct Combine {
    unsigned heads;  // the lanes that start a run
    unsigned group;  // the run starts that share this lane's bin (0: no second step)
    int end;         // the lane past this lane's run
    int steps;       // shuffles of the second step
    int rows;        // on the leader: the rows it adds for
    bool lead;       // this lane makes the atomics

    __device__ __forceinline__ Combine() {}

    __device__ __forceinline__ Combine(int bin, int lane) {
        heads = run_heads(bin, lane);
        int first;
        run_bounds(heads, lane, first, end);
        const bool head = bin >= 0 && lane == first;
        rows = end - first;
        lead = head;
        group = 0u;
        steps = 0;
        if (heads & (heads - 1)) {  // more than one run: uniform across the warp
            group = __match_any_sync(FULL_MASK, head ? bin : -1);
            lead = head && lane == __ffs(group) - 1;
            steps = __reduce_max_sync(FULL_MASK, head ? __popc(group) : 1) - 1;
            rows = across_runs(rows, lane);
        }
    }

    // Runs of neighbouring lanes only: where the runs leave two lanes with
    // one bin, each adds (a sorted or single key costs one atomic a run,
    // keys that repeat out of order one each).
    __device__ __forceinline__ static Combine runs(int bin, int lane) {
        Combine c;
        c.heads = run_heads(bin, lane);
        int first;
        run_bounds(c.heads, lane, first, c.end);
        c.lead = bin >= 0 && lane == first;
        c.rows = c.end - first;
        c.group = 0u;
        c.steps = 0;
        return c;
    }

    // The minimum of v over this lane's run [lane, end), on the run's first
    // lane (for Combine::runs: the runs of neighbouring lanes only).
    __device__ __forceinline__ unsigned long long run_min(unsigned long long v, int lane) const {
        if (heads != FULL_MASK) {
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned long long x = __shfl_down_sync(FULL_MASK, v, o);
                if (lane + o < end) v = min(v, x);
            }
        }
        return v;
    }

    // The sum of v over the lanes that share this lane's bin, on the leader.
    template <class T>
    __device__ __forceinline__ T sum(T v, int lane) const {
        if (heads != FULL_MASK) {  // the run [lane, end), a fixed tree of shuffles
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const T x = __shfl_down_sync(FULL_MASK, v, o);
                if (lane + o < end) v += x;
            }
        }
        return group ? across_runs(v, lane) : v;
    }

    // The sum of the run sums v over the runs of this lane's group, in lane
    // order; `steps` is the size of the warp's largest group less one, so
    // every lane makes the same shuffles.
    template <class T>
    __device__ __forceinline__ T across_runs(T v, int lane) const {
        T s = v;
        unsigned rest = group & (group - 1);  // the group without its leader
        for (int i = 0; i < steps; ++i) {
            const T x = __shfl_sync(FULL_MASK, v, rest ? __ffs(rest) - 1 : lane);
            if (rest) s += x;
            rest &= rest - 1;
        }
        return s;
    }
};

// Fold the warps' [C, W] grids in warp order into bins [w0, w0 + Wc) of the
// partial out [C, G]; rows [0, C_int) are integer words.  Call after
// __syncthreads().
__device__ __forceinline__ void fold_warps(const unsigned long long* smem, int warps, int C,
                                           int C_int, int W, int Wc, int G, int w0,
                                           unsigned long long* out) {
    const size_t CW = (size_t)C * W;  // warp w's grid starts at w * CW
    for (int j = threadIdx.x; j < C * Wc; j += blockDim.x) {
        const int c = j / Wc;
        const size_t src = (size_t)c * W + (j - c * Wc);
        unsigned long long* dst = out + (size_t)c * G + w0 + (j - c * Wc);
        if (c < C_int) {
            unsigned long long s = 0ull;
            for (int w = 0; w < warps; ++w) s += smem[w * CW + src];
            *dst = s;
        } else {
            double s = 0.0;
            for (int w = 0; w < warps; ++w)
                s += reinterpret_cast<const double*>(smem)[w * CW + src];
            *reinterpret_cast<double*>(dst) = s;
        }
    }
}

// One warp per output word: lane l adds partials l, l + 32, ... in order,
// then a fixed shuffle tree adds the lanes.
__global__ void fold_partials(const unsigned long long* __restrict__ scratch, int n_parts,
                              int CG, int CG_int, long long* __restrict__ out_int,
                              double* __restrict__ out_float) {
    const int j = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
    const int lane = threadIdx.x & 31;
    if (j >= CG) return;  // whole warps leave together
    if (j < CG_int) {
        unsigned long long s = 0ull;
        for (int p = lane; p < n_parts; p += 32) s += scratch[(size_t)p * CG + j];
        for (int o = 16; o; o >>= 1) s += __shfl_down_sync(FULL_MASK, s, o);
        if (lane == 0) out_int[j] = (long long)s;
    } else {
        double s = 0.0;
        for (int p = lane; p < n_parts; p += 32)
            s += reinterpret_cast<const double*>(scratch)[(size_t)p * CG + j];
        for (int o = 16; o; o >>= 1) s += __shfl_down_sync(FULL_MASK, s, o);
        if (lane == 0) out_float[j - CG_int] = s;
    }
}

// One thread per output word, adding the partials in order: for few
// partials over a wide grid, where a warp per word would idle most lanes.
__global__ void fold_partials_seq(const unsigned long long* __restrict__ scratch, int n_parts,
                                  int CG, int CG_int, long long* __restrict__ out_int,
                                  double* __restrict__ out_float) {
    const int j = (int)((long long)blockIdx.x * blockDim.x + threadIdx.x);
    if (j >= CG) return;
    if (j < CG_int) {
        unsigned long long s = 0ull;
        for (int p = 0; p < n_parts; ++p) s += scratch[(size_t)p * CG + j];
        out_int[j] = (long long)s;
    } else {
        double s = 0.0;
        for (int p = 0; p < n_parts; ++p)
            s += reinterpret_cast<const double*>(scratch)[(size_t)p * CG + j];
        out_float[j - CG_int] = s;
    }
}

// Host side: fold n_parts partials [C, G] into the outputs.  Which of the
// two folds runs depends on n_parts alone, so the order of the additions
// stays fixed by the launch arguments.
static inline cudaError_t launch_fold(const unsigned long long* scratch, int n_parts, int CG,
                                      int CG_int, long long* out_int, double* out_float,
                                      cudaStream_t s) {
    const int threads = 256;
    if (n_parts < 32) {
        const int blocks = (CG + threads - 1) / threads;
        fold_partials_seq<<<blocks, threads, 0, s>>>(scratch, n_parts, CG, CG_int, out_int,
                                                     out_float);
    } else {
        const int blocks = (int)(((long long)CG * 32 + threads - 1) / threads);
        fold_partials<<<blocks, threads, 0, s>>>(scratch, n_parts, CG, CG_int, out_int,
                                                 out_float);
    }
    return cudaGetLastError();
}
