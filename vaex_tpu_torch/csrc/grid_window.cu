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
// The design: a thread-block cluster of n_win CTAs (at most 8, the
// portable cluster size) holds the whole grid in its distributed shared
// memory, each CTA one window of W bins.  Each CTA walks its own rows once,
// with no window test, and adds each row into the window that owns its bin:
// a shared-memory atomic when the CTA owns it, else an atomic on the
// owner's shared memory through the address
// cooperative_groups::this_cluster().map_shared_rank gives.  The grid of
// CTAs is a whole number of clusters, as many as the occupancy query says
// can be resident (cudaOccupancyMaxActiveClusters), each cluster one row
// slice; each writes its [C, G] partial, and fold_partials adds the
// partials in slice order.  A cluster.sync() after zeroing keeps remote adds
// out of unzeroed windows, and one before the fold keeps every CTA alive
// while another may still add into its shared memory.  A grid that fits one
// window takes the kernel's ONE form: a plain launch, no owner to find and
// __syncthreads() for the two syncs, because on an NVIDIA H100 the same walk
// launched as clusters of one CTA was much slower (PERF.md, section 6).
//
// A window is a plane of W 32-bit counts, then a plane of W 8-byte words per
// value column; W is even, so the value planes stay 8-byte aligned.  On
// sm_90a a 64-bit atomic add on shared memory, integer or double, is a
// compare-and-swap loop (ATOMS.CAST.SPIN.64 in the SASS), while 32-bit adds
// are native (ATOMS.ADD, ATOMS.POPC.INC), and so are 32-bit, 64-bit and
// double adds into another CTA's shared memory (ATOM.E.ADD[.64|.F64]).
// Hence two levers for the local adds:
//   * the count in 32-bit words, widened in the fold: exact, because a
//     launch takes fewer than 2^32 rows; it also lets a window hold more
//     bins (20 bytes a bin for count + int64 + f64, not 24);
//   * an int64 value is a 32-bit add on the low word and, where that
//     carries or the value has high bits, a 32-bit add on the high word:
//     exact mod 2^64 because the adds commute, also beside the native 64-bit
//     adds that other CTAs make into the same word.  It measured at least
//     as fast as the 64-bit loop at every shape (PERF.md, section 6).
//
// Integer sums are exact; float sums are NOT reproducible from run to run:
// the order in which rows reach a word varies.
//
// What bounds it on an H100: the HBM read of idx and the value columns
// (12-20 bytes per row), then the rate of shared-memory atomics, of which a
// row makes C, (n_win - 1) / n_win of them remote.  The plan
// (ops/grid_plan.py) gives B2 the grids up to a measured cluster size and
// hands wider ones to the partitioned kernel B3 (grid_partition.cu).

#include <cooperative_groups.h>

#include "grid_common.cuh"

namespace cg = cooperative_groups;

#define MAX_CLUSTER 8

// v into the shared-memory word *p as two native 32-bit adds (see above).
__device__ __forceinline__ void add_int(unsigned long long* p, unsigned long long v) {
    unsigned* w = reinterpret_cast<unsigned*>(p);
    const unsigned lo = (unsigned)v;
    const unsigned old = atomicAdd(w, lo);
    const unsigned hi = (unsigned)(v >> 32) + (old + lo < old ? 1u : 0u);
    if (hi) atomicAdd(w + 1, hi);
}

// A row's add into the word `local` of this CTA's window (a shared-memory
// address: shared-memory atomics) or, for a bin another CTA owns, into the
// same word of its window (an address in distributed shared memory).
template <typename T, typename Local, typename Remote>
__device__ __forceinline__ void at_owner(const cg::cluster_group& cluster, T* local, int owner,
                                         int rank, Local add_local, Remote add_remote) {
    if (owner == rank)
        add_local(local);
    else
        add_remote(cluster.map_shared_rank(local, owner));
}

// Words of shared memory of a window: W / 2 for the 32-bit counts, W per
// value column.
__host__ __device__ __forceinline__ size_t window_words(int W, int count, int n_cols) {
    return (size_t)(count ? W / 2 : 0) + (size_t)n_cols * W;
}

template <bool ONE>
__global__ void __launch_bounds__(1024)
window_cluster(const int* __restrict__ idx, long long n, int G, int W, int count, Columns cols,
               int n_int, int n_float, unsigned long long* __restrict__ scratch) {
    extern __shared__ unsigned long long smem[];
    const cg::cluster_group cluster = cg::this_cluster();
    const int n_win = ONE ? 1 : (int)cluster.num_blocks();
    const int rank = ONE ? 0 : (int)cluster.block_rank();
    unsigned* counts = reinterpret_cast<unsigned*>(smem);  // [W] when count
    unsigned long long* sums = smem + (count ? W / 2 : 0);  // [n_int + n_float, W]

    zero_smem(smem, window_words(W, count, n_int + n_float));
    // no remote add may land in an unzeroed window
    if (ONE)
        __syncthreads();
    else
        cluster.sync();

    // a thread takes rows base + u * step, u < UNROLL
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x; base < n;
         base += UNROLL * step) {
        int owner[UNROLL];  // the CTA whose window holds the row's bin, -1 for none
        int bin[UNROLL];    // the bin within that window
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long r = base + u * step;
            owner[u] = -1;
            bin[u] = 0;
            if (r < n) {
                const unsigned d = (unsigned)__ldg(idx + r);  // negative idx wraps past G
                if (d < (unsigned)G) {
                    int o = 0;
#pragma unroll
                    for (int k = 1; k < (ONE ? 1 : MAX_CLUSTER); ++k)
                        o += (k < n_win) & (d >= (unsigned)(k * W));
                    owner[u] = o;
                    bin[u] = (int)d - o * W;
                }
            }
        }
        if (count) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                if (owner[u] >= 0)
                    at_owner(cluster, counts + bin[u], owner[u], rank,
                             [](unsigned* p) { atomicAdd(p, 1u); },
                             [](unsigned* p) { atomicAdd(p, 1u); });
        }
        for (int k = 0; k < n_int; ++k) {
            long long v[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                v[u] = owner[u] >= 0 ? __ldg((const long long*)cols.ptr[k] + base + u * step) : 0;
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const unsigned long long w = (unsigned long long)v[u];
                if (owner[u] >= 0)
                    at_owner(cluster, sums + (size_t)k * W + bin[u], owner[u], rank,
                             [w](unsigned long long* p) { add_int(p, w); },
                             [w](unsigned long long* p) { atomicAdd(p, w); });
            }
        }
        for (int k = 0; k < n_float; ++k) {
            const void* col = cols.ptr[n_int + k];
            const int f32 = cols.is_f32[n_int + k];
            double v[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                v[u] = owner[u] >= 0 ? load_float(col, f32, base + u * step) : 0.0;
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const double w = v[u];
                if (owner[u] >= 0)
                    at_owner(cluster,
                             reinterpret_cast<double*>(sums + (size_t)(n_int + k) * W + bin[u]),
                             owner[u], rank, [w](double* p) { atomicAdd(p, w); },
                             [w](double* p) { atomicAdd(p, w); });
            }
        }
    }
    // every remote add has landed; no CTA leaves while others add
    if (ONE)
        __syncthreads();
    else
        cluster.sync();

    // this window's bins [w0, w0 + Wc) of the cluster's partial [C, G], the
    // counts widened to 8-byte words
    const int w0 = rank * W;
    const int Wc = max(0, min(W, G - w0));
    const int C = count + n_int + n_float;
    unsigned long long* out = scratch + (size_t)(blockIdx.x / n_win) * C * G + w0;
    for (int j = threadIdx.x; j < C * Wc; j += blockDim.x) {
        const int c = j / Wc, b = j - c * Wc;
        out[(size_t)c * G + b] = c < count ? (unsigned long long)counts[b]
                                           : sums[(size_t)(c - count) * W + b];
    }
}

template <bool ONE>
static cudaError_t prepare(size_t smem) {
    return cudaFuncSetAttribute(window_cluster<ONE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

static cudaLaunchConfig_t config(int n_win, int n_clusters, int threads, size_t smem,
                                 cudaStream_t s, cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(n_win * n_clusters), 1, 1);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)n_win;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = n_win > 1;  // one window: a plain launch
    return cfg;
}

template <bool ONE>
static cudaError_t max_clusters(int n_win, int threads, size_t smem, int* out) {
    cudaError_t e = prepare<ONE>(smem);
    if (e != cudaSuccess) return e;
    if (ONE) {
        int device = 0, per_sm = 0, sms = 0;
        e = cudaGetDevice(&device);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_cluster<ONE>,
                                                              threads, smem);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        *out = per_sm * sms;
        return e;
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(n_win, 1, threads, smem, 0, attr);
    return cudaOccupancyMaxActiveClusters(out, (void*)window_cluster<ONE>, &cfg);
}

template <bool ONE>
static cudaError_t launch(int n_win, int n_clusters, int threads, size_t smem, cudaStream_t s,
                          const int* idx, long long n, int G, int W, int count,
                          const Columns& cols, int n_int, int n_float,
                          unsigned long long* scratch) {
    cudaError_t e = prepare<ONE>(smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(n_win, n_clusters, threads, smem, s, attr);
    return cudaLaunchKernelEx(&cfg, window_cluster<ONE>, idx, n, G, W, count, cols, n_int,
                              n_float, scratch);
}

// Shared memory of a window of W bins (W even when count), or 0 when it
// does not fit.
static size_t window_smem(int W, int count, int n_cols) {
    if (W < 1 || (count && W % 2) || count + n_cols < 1) return 0;
    const size_t smem = window_words(W, count, n_cols) * sizeof(unsigned long long);
    return smem <= CLUSTER_SMEM ? smem : 0;
}

extern "C" {

int grid_window_smem_budget(void) { return CLUSTER_SMEM; }

int grid_window_max_cluster(void) { return MAX_CLUSTER; }

int grid_window_max_cols(void) { return MAX_COLS; }

// The number of clusters of n_win <= MAX_CLUSTER CTAs (warps * 32 threads,
// smem bytes of window each; one window: the plain launch) the card holds
// at once, into *out; returns the CUDA error code.
int grid_window_clusters(int n_win, int smem, int warps, int* out) {
    if (n_win < 1 || n_win > MAX_CLUSTER || warps < 1 || warps > 32 || smem < 1 ||
        smem > CLUSTER_SMEM)
        return -1;
    const int threads = warps * 32;
    return n_win == 1 ? (int)max_clusters<true>(n_win, threads, smem, out)
                      : (int)max_clusters<false>(n_win, threads, smem, out);
}

// Launches n_clusters clusters of n_win CTAs, the windows of W bins, and the
// fold on `stream`; returns cudaGetLastError() (0 on success), or -1 when
// the arguments do not fit the kernel.
//   n < 2^32: the counts are 32-bit words;
//   int_cols / float_cols: HOST arrays of device pointers;
//   float_is_f32: HOST array, one flag per float column;
//   scratch: device [n_clusters, C, G] 8-byte words, C = count + n_int + n_float.
int grid_window_run(const int* idx, long long n, int G, int W, int n_win, int count,
                    const void* const* int_cols, int n_int,
                    const void* const* float_cols, const int* float_is_f32, int n_float,
                    int n_clusters, int warps, unsigned long long* scratch,
                    long long* out_int, double* out_float, void* stream) {
    const int C = count + n_int + n_float;
    const size_t smem = window_smem(W, count, n_int + n_float);
    if (G < 1 || smem == 0 || n_int < 0 || n_float < 0 || n_int + n_float > MAX_COLS ||
        warps < 1 || warps > 32 || n_win < 1 || n_win > MAX_CLUSTER ||
        (long long)n_win * W < G || n_clusters < 1 || n < 0 || n >= (1LL << 32) ||
        (long long)C * G > 0x7fffffffLL || (long long)n_win * n_clusters > 0x7fffffffLL)
        return -1;
    const Columns cols = make_columns(int_cols, n_int, float_cols, float_is_f32, n_float);
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = warps * 32;
    cudaError_t e = n_win == 1 ? launch<true>(n_win, n_clusters, threads, smem, s, idx, n, G, W,
                                              count, cols, n_int, n_float, scratch)
                               : launch<false>(n_win, n_clusters, threads, smem, s, idx, n, G,
                                               W, count, cols, n_int, n_float, scratch);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)launch_fold(scratch, n_clusters, C * G, (count + n_int) * G, out_int, out_float,
                            s);
}

const char* grid_window_error_string(int code) {
    if (code == -1) return "arguments do not fit the grid_window kernel";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
