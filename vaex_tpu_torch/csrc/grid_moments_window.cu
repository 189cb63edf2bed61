// Per-bin sums of moment terms for grids too wide for one warp-private grid
// (kernel B5), for Hopper (sm_90a).  Built by nvcc into a shared library
// with a plain C interface and loaded with ctypes
// (vaex_tpu_torch/ops/grid_moments.py, which holds the contract, the plan
// of the parts and the plain version).
//
// Replaces the TPU kernel vaex_tpu/ops/pallas_gridagg.py:_agg2_kernel (via
// fused_additive_two_level).  That kernel factored the grid as hi * 128 + lo
// so the MXU's one-hot stayed narrow, and split every value into three bf16
// parts for it; neither carries over.  Like B4 (grid_moments.cu) it forms
// the term columns in registers from the base columns instead of reading
// columns formed in device memory.
//
// What bounds it on an H100: the shared-memory atomics, one per term and
// row, and each part's walk over the rows.  A 32-bit add is native
// (ATOMS.ADD); a double add is a compare-and-swap loop (ATOMS.CAST.SPIN.64),
// and through a generic or a cluster-mapped address the compiler only adds
// a test of the address space before the same loop (PERF.md, section 6).
// A warp's atomic costs about the same with one active lane as with 32, so
// the design keeps the lanes of every atomic busy.  The HBM traffic is 4 +
// 8 per base bytes/row (12 for var of an f64, 20 for corr).
//
// The design: the [C, G] grid of the call's terms (counts first, then the
// float terms) is cut into parts, each one CTA's shared memory, all 227 KiB
// a block may take: a plane of W 32-bit words per count term of the part
// (a call takes fewer than 2^31 rows, so no word overflows; the partial
// widens them) and a plane of W doubles per float term.  First the bins are
// cut into the fewest windows of W bins in which one term's plane fits, then
// each window's terms into the fewest groups of consecutive planes that fit,
// of near-equal size (ops/grid_moments.py:part_plan).  Var at H2O's
// G = 10 609 is one part (20 bytes a bin); corr is one window of three
// groups of two terms.  blockIdx.x is the part, blockIdx.y the row slice:
// every part walks the rows of its slice and adds the terms of its group
// for the rows of its window, so each atomic has every lane busy, where
// bin windows of all terms would leave two thirds of the lanes of every
// atomic idle at three windows.  idx is read by every part, a base by the parts
// whose terms multiply it or need it valid where it can be NaN (the wrapper
// puts the float terms of one base next to each other and the kernel
// writes each term to the caller's row: corr of two int64
// columns loads x and y for [count, x*y], x alone for [x, x*x], y alone for
// [y, y*y]); a part of the only window loads its bases beside idx, so that
// a step waits on one round trip.
//
// Every add: the lanes of a warp in a run of neighbouring lanes with one
// bin are combined first (Combine::runs, grid_common.cuh), so sorted keys
// or one key cost one atomic a run; then the leader adds each count with a
// 32-bit atomic and each float term with a double atomic.  Terms of var
// and corr are compiled (moments_common.cuh: SET_VAR, SET_CORR); other
// batches read the run-time tables (SET_ANY).  Counts are exact; float sums
// are NOT reproducible from run to run (the order in which rows reach a
// word varies).  The partials [n_slices, C, G] are folded by launch_fold.

#include "moments_common.cuh"

#define WALK_UNROLL 4

// A part: the terms [lo[g], lo[g + 1]) (counts first) of group g over bins
// [win * W, win * W + W) of window win, for part win * n_groups + g; term k
// is row row[k] of the partials.
struct Groups {
    int lo[MAX_TERMS + 1];
    int row[MAX_TERMS];
};

// The adds of one warp step: lane `lane` holds a row whose bin in this
// part's window is key (< 0: not this window's; every lane a distinct
// negative key, so rows of other windows form no runs), its bases v and
// NaN mask; the part holds terms [t_lo, t_hi) in the planes at counts and
// sums.  Every lane of the warp must call this.
template <int NB, int SET>
__device__ __forceinline__ void add_row(int key, const double (&v)[BASE_SLOTS(NB)],
                                        unsigned missing, int lane, const Terms& terms,
                                        int n_count, int n_float, int t_lo, int t_hi, int W,
                                        unsigned* counts, double* sums) {
    const Combine same = Combine::runs(key, lane);
    // the part's planes: its count terms from t_lo, its float terms from
    // max(t_lo, n_count)
    const int f_lo = max(t_lo, n_count);
    auto count = [&](int k) {
        const unsigned s = same.sum(key >= 0 ? set_count<SET>(terms, k, missing) : 0u, lane);
        if (same.lead && s) atomicAdd(counts + (size_t)(k - t_lo) * W + key, s);
    };
    auto term = [&](int k) {  // k: the float term's index among the terms
        const double x = key >= 0 ? set_term<NB, SET>(terms, k, v, missing) : 0.0;
        const double s = same.sum(x, lane);
        if (same.lead) atomicAdd(sums + (size_t)(k - f_lo) * W + key, s);
    };
    if constexpr (SET == SET_ANY) {  // run-time tables: loops, not unrolled
        for (int k = t_lo; k < min(t_hi, n_count); ++k) count(k);
        for (int k = f_lo; k < t_hi; ++k) term(k);
    } else {
        if (t_lo == 0) count(0);  // uniform across the CTA
#pragma unroll
        for (int k = 1; k <= set_floats<SET>(); ++k)
            if (k >= t_lo && k < t_hi) term(k);
    }
}

// The bases a part loads (bit j: base j): those its float terms multiply,
// and those its terms need valid that can be NaN (an int64 base cannot), so
// that a part loads no column it does not need.
__device__ __forceinline__ unsigned part_bases(const Bases& bases, const Terms& terms,
                                               int n_count, int t_lo, int t_hi) {
    unsigned load = 0u;
    for (int k = t_lo; k < t_hi; ++k) {
        unsigned need = terms.need[k];
        for (int j = 0; j < MAX_BASES; ++j)
            if (bases.kind[j] == BASE_I64) need &= ~(1u << j);
        load |= need;
        if (k >= n_count) load |= (1u << terms.a[k]) | (terms.b[k] >= 0 ? 1u << terms.b[k] : 0u);
    }
    return load;
}

// Rows [lo, hi) of the call walked warp by warp with plain loads, from row
// lo + first * 32 on in steps of step * 32 rows, adding the part's terms
// [t_lo, t_hi) of the rows of the window [w0, w0 + Wc) (one_window: the
// window holds every bin).
template <int NB, int SET>
__device__ __forceinline__ void walk_rows(const int* __restrict__ idx, long long lo, long long hi,
                                          long long first, long long step, int w0, int Wc,
                                          bool one_window, unsigned need, const Bases& bases,
                                          const Terms& terms, int n_count, int n_float, int t_lo,
                                          int t_hi, int W, unsigned* counts, double* sums) {
    const int lane = threadIdx.x & 31;
    // a warp takes rows base + u * step * 32 + lane, u < WALK_UNROLL
    for (long long base = lo + first * 32; base < hi; base += WALK_UNROLL * step * 32) {
        // every idx load of the step is issued before any is used (a row past
        // hi reads row hi - 1 and adds nothing)
        int key[WALK_UNROLL];
#pragma unroll
        for (int u = 0; u < WALK_UNROLL; ++u)
            key[u] = __ldg(idx + min(base + u * step * 32 + lane, hi - 1));
        // the row's bin in this window, or -1 - lane: now where the bases
        // wait on it, after them for the only window
        auto own = [&](int u) {
            // unsigned: idx below w0, negative idx included, wraps past Wc
            const unsigned d = (unsigned)key[u] - (unsigned)w0;
            key[u] = base + u * step * 32 + lane < hi && d < (unsigned)Wc ? (int)d : -1 - lane;
        };
        if (!one_window) {
#pragma unroll
            for (int u = 0; u < WALK_UNROLL; ++u) own(u);
        }
        // a part of the only window loads its bases beside idx for every row
        // (a dropped row's bases cost no extra sector), so that a step waits
        // on one round trip; a part of one of several windows loads the
        // bases of its own rows only
        double v[WALK_UNROLL][BASE_SLOTS(NB)];
        unsigned missing[WALK_UNROLL];
#pragma unroll
        for (int u = 0; u < WALK_UNROLL; ++u) {
#pragma unroll
            for (int j = 0; j < BASE_SLOTS(NB); ++j) {
                v[u][j] = 0.0;
                if (j < NB && (need >> j & 1u) && (one_window || key[u] >= 0))
                    v[u][j] = load_base(bases.ptr[j], bases.kind[j],
                                        min(base + u * step * 32 + lane, hi - 1));
            }
        }
#pragma unroll
        for (int u = 0; u < WALK_UNROLL; ++u) {
            if (one_window) own(u);
            missing[u] = 0u;
#pragma unroll
            for (int j = 0; j < BASE_SLOTS(NB); ++j)
                if (key[u] >= 0 && v[u][j] != v[u][j]) missing[u] |= 1u << j;
        }
#pragma unroll
        for (int u = 0; u < WALK_UNROLL; ++u) {
            if (!__any_sync(FULL_MASK, key[u] >= 0)) continue;  // uniform across the warp
            add_row<NB, SET>(key[u], v[u], missing[u], lane, terms, n_count, n_float, t_lo, t_hi,
                             W, counts, sums);
        }
    }
}

// The part's planes: [part_counts] 32-bit, then [part_floats] doubles.
struct Part {
    int t_lo, t_hi, counts, floats;
    __device__ __forceinline__ Part(const Groups& groups, int g, int n_count) {
        t_lo = groups.lo[g];
        t_hi = groups.lo[g + 1];
        counts = max(0, min(t_hi, n_count) - t_lo);
        floats = t_hi - max(t_lo, n_count);
    }
    __device__ __forceinline__ size_t words(int W) const {  // W is even
        return (size_t)W * (counts + 2 * floats) / 2;
    }
};

// The part's terms over bins [w0, w0 + Wc) of the partial out [C, G], each
// in its row, the counts widened to 8-byte words.  Call after a barrier.
__device__ __forceinline__ void write_part(const Part& part, const Groups& groups,
                                           const unsigned* counts, const double* sums, int G,
                                           int W, int w0, int Wc, unsigned long long* out) {
    for (int j = threadIdx.x; j < (part.counts + part.floats) * Wc; j += blockDim.x) {
        const int c = j / Wc, b = j - c * Wc;
        unsigned long long* dst = out + (size_t)groups.row[part.t_lo + c] * G + w0 + b;
        if (c < part.counts)
            *dst = (unsigned long long)counts[(size_t)c * W + b];
        else
            *reinterpret_cast<double*>(dst) = sums[(size_t)(c - part.counts) * W + b];
    }
}

template <int NB, int SET>
__global__ void __launch_bounds__(1024)
moment_window_walk(const int* __restrict__ idx, long long n, int G, int W, int n_groups,
                   Groups groups, Bases bases, Terms terms, int n_count, int n_float,
                   unsigned long long* __restrict__ scratch) {
    extern __shared__ __align__(128) unsigned long long smem[];
    if constexpr (SET != SET_ANY) {
        n_count = 1;
        n_float = set_floats<SET>();
    }
    const int win = blockIdx.x / n_groups;
    const Part part(groups, blockIdx.x - win * n_groups, n_count);
    unsigned* counts = reinterpret_cast<unsigned*>(smem);
    double* sums = reinterpret_cast<double*>(counts + (size_t)part.counts * W);
    const int w0 = win * W;
    const int Wc = min(W, G - w0);
    for (size_t j = threadIdx.x; j < part.words(W); j += blockDim.x) smem[j] = 0ull;
    __syncthreads();
    const int warps = blockDim.x >> 5;
    walk_rows<NB, SET>(idx, 0, n, (long long)blockIdx.y * warps + (threadIdx.x >> 5),
                       (long long)gridDim.y * warps, w0, Wc, W >= G,
                       part_bases(bases, terms, n_count, part.t_lo, part.t_hi), bases, terms,
                       n_count, n_float,
                       part.t_lo, part.t_hi, W, counts, sums);
    __syncthreads();
    write_part(part, groups, counts, sums, G, W, w0, Wc,
               scratch + (size_t)blockIdx.y * (n_count + n_float) * G);
}

typedef void (*WalkKernel)(const int*, long long, int, int, int, Groups, Bases, Terms, int, int,
                           unsigned long long*);

// The instance for nb bases and the compiled set.
static WalkKernel walk_kernel(int nb, int set) {
    if (set == SET_VAR) return moment_window_walk<1, SET_VAR>;
    if (set == SET_CORR) return moment_window_walk<2, SET_CORR>;
    return nb == 0   ? moment_window_walk<0, SET_ANY>
           : nb == 1 ? moment_window_walk<1, SET_ANY>
           : nb == 2 ? moment_window_walk<2, SET_ANY>
           : nb == 3 ? moment_window_walk<3, SET_ANY>
                     : moment_window_walk<4, SET_ANY>;
}

extern "C" {

int grid_moments_window_smem_budget(void) { return CLUSTER_SMEM; }
int grid_moments_window_max_cols(void) { return MAX_TERMS; }
int grid_moments_window_max_bases(void) { return MAX_BASES; }
const char* grid_moments_window_error_string(int code) {
    if (code == -1) return "arguments do not fit the grid_moments_window kernel";
    return cudaGetErrorString((cudaError_t)code);
}

// Launches the parts and the fold on `stream`; returns cudaGetLastError()
// (0 on success), or -1 when the arguments do not fit the kernel.
//   group_lo: HOST array of n_groups + 1 term boundaries, 0 = group_lo[0]
//     < ... = n_count + n_float, each group's planes within CLUSTER_SMEM at
//     width W; W: bins per window (even), n_win windows;
//   term_row: HOST array, the output row of each term (a permutation of
//     [0, C) that keeps the counts in [0, n_count));
//   base_ptrs / base_kinds: HOST arrays, nb entries (BASE_F64/F32/I64);
//   term_a / term_b / term_need: HOST arrays, n_count count terms, then
//     n_float float terms;
//   n_slices row slices of n_win * n_groups CTAs of `threads`;
//   scratch: device [n_slices, C, G] 8-byte words.
int grid_moments_window_run(const int* idx, long long n, int G, int W, int n_win,
                            const int* group_lo, int n_groups, const int* term_row,
                            const void* const* base_ptrs,
                            const int* base_kinds, int nb, const int* term_a, const int* term_b,
                            const unsigned* term_need, int n_count, int n_float, int n_slices,
                            int threads, unsigned long long* scratch, long long* out_int,
                            double* out_float, void* stream) {
    Bases bases;
    Terms terms;
    const int C = n_count + n_float;
    if (G < 1 || W < 2 || W % 2 || n_win < 1 || (long long)n_win * W < G || n_groups < 1 ||
        n_groups > MAX_TERMS || n < 0 || n >= (1LL << 31) || threads < 32 || threads > 1024 ||
        threads % 32 || n_slices < 1 || n_slices > 65535 ||
        !make_tables(base_ptrs, base_kinds, nb, term_a, term_b, term_need, n_count, n_float,
                     &bases, &terms) ||
        (long long)C * G > 0x7fffffffLL || (long long)n_win * n_groups > 0x7fffffffLL ||
        group_lo[0] != 0 || group_lo[n_groups] != C)
        return -1;
    Groups groups;
    for (int g = 0; g <= MAX_TERMS; ++g) groups.lo[g] = g <= n_groups ? group_lo[g] : C;
    unsigned rows = 0u;  // the rows taken, so that each is taken once
    for (int k = 0; k < MAX_TERMS; ++k) {
        groups.row[k] = k < C ? term_row[k] : k;
        if (k >= C) continue;
        if (term_row[k] < 0 || term_row[k] >= C || (k < n_count) != (term_row[k] < n_count) ||
            (rows >> term_row[k] & 1u))
            return -1;
        rows |= 1u << term_row[k];
    }
    size_t smem = 0;  // the widest part's planes
    for (int g = 0; g < n_groups; ++g) {
        const int lo = group_lo[g], hi = group_lo[g + 1];
        if (hi <= lo) return -1;
        const int cnt = max(0, min(hi, n_count) - lo), flt = hi - max(lo, n_count);
        const size_t bytes = (size_t)W * (4 * cnt + 8 * flt);
        if (bytes > CLUSTER_SMEM) return -1;
        smem = bytes > smem ? bytes : smem;
    }
    cudaStream_t s = (cudaStream_t)stream;
    WalkKernel kernel =
        walk_kernel(nb, term_set(nb, term_a, term_b, term_need, n_count, n_float));
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((unsigned)(n_win * n_groups), (unsigned)n_slices), threads, smem, s>>>(
        idx, n, G, W, n_groups, groups, bases, terms, n_count, n_float, scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)launch_fold(scratch, n_slices, C * G, n_count * G, out_int, out_float, s);
}

}  // extern "C"
