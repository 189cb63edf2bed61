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
// Every base is read less its shift (shifted moments, moments_common.cuh):
// one word per base in device memory, read once by each thread, subtracted
// in the base's own type before the cast to double, so var of values far
// from zero keeps its digits.  With a shift a cell (TABLE: the second pass
// of a statistic whose cells lie far from one shift) each CTA copies the
// [nb][G] table into shared memory after its grids, 8 bytes a base and bin,
// and a row subtracts its bin's word, read once its bin is back.
//
// Two routes, which the wrapper picks by G and the terms
// (ops/grid_moments.py:route).  Every addition of both happens in an order
// fixed by the launch arguments and the card: float sums are reproducible
// from run to run, counts exact.
//
// The lane route (moment_lanes), B1's lane route (grid_additive.cu) for
// moment terms: every lane owns a private grid in shared memory, laid out
// [term][G][32 lanes] so a warp's 32 lanes touch 32 banks: a 32-bit count
// word per count term and a double per float term, for each bin.  A lane
// takes lane_rows<NB>() rows a step in two halves held in two register
// sets: the loads of the next half (its bins and bases, rows clamped to
// n - 1 and dropped after, each base's kind taken once) are in flight while
// the lane adds this one, which a CTA of three warps needs to keep the
// memory busy.  It forms the terms in registers (set_term) and adds them
// with plain read-modify-writes: no __match_any_sync, no staging, no
// ballots, no atomics.  For a compiled term set (var, corr) a row's words
// are read together and written together, so a step waits on one
// shared-memory round trip a row, not one a term; at G = 1 (df.std,
// df.correlation: a statistic without binby) a lane keeps such a set's
// terms in registers for the whole call and writes them once, and without
// a selection the call passes no idx (every row in bin 0).  Other batches
// read the run-time tables, a read-modify-write a term.  The CTA folds
// its lanes and warps (a warp per output word: lane l adds its lane's word
// of the warps' grids in warp order, then a fixed shuffle tree), and
// launch_fold folds the CTA partials in CTA order.  A lane's 32-bit counts
// take fewer than 2^32 rows of a call.
//
// The warp route (moment_partials), for the grids whose lane grids leave a
// CTA too few warps: B1's ordered warp scheme (grid_common.cuh): every warp
// owns a private [C, G] grid in shared memory (count terms as integer
// words, then the float terms as doubles); a lane loads UNROLL rows' bin and
// bases at once, then, row step by row step, __match_any_sync groups the
// lanes that share a bin; a count term adds the popcount of the group's
// lanes whose row is valid for it (exact), a float term stages every lane's
// value in shared memory and the group's lowest lane adds them in lane
// order; where the whole warp shares one bin (skewed keys), a fixed shuffle
// tree adds them instead of one lane.  The CTA folds its warps in warp order
// (fold_warps) and launch_fold the CTA partials in CTA order.
//
// What bounds it on an H100: the HBM read of idx and the bases, 4 + 8 per
// base bytes/row (12 for var of an f64, 20 for corr); on the lane route at
// few warps a CTA also the chain of shared-memory read-modify-writes of a
// lane (each waits on the last, which may have hit the same word).  Past
// some G the window kernel B5 (grid_moments_window.cu) is faster, and
// ops/grid_plan.py:moment_strategy hands the grid over at the cut-off
// measured with scripts/sweep_grid_kernels.py --moments.  Shared memory: the
// lane route warps * 32 * G * (4 * n_count + 8 * n_float) bytes within
// CLUSTER_SMEM, the warp route warps * (C * G + n_float * 32) words within
// SMEM_BUDGET.

#include "moments_common.cuh"

// The bins and bases of H rows of a lane, loaded together (both routes).
template <int NB, int H>
struct Rows {
    int b[H];
    double v[H][BASE_SLOTS(NB)];
};

// Issues the loads of rows hb + u * step, u < H, clamped to n - 1 (every
// load is unconditional: a row past n adds nothing), each base's raw value
// (load_raw: shift_rows makes them values); the branch on a base's kind is
// taken once for the H rows, and nothing here waits on a load.  Without
// IDX every row is in bin 0 and no idx is read.
template <int NB, int H, bool IDX = true>
__device__ __forceinline__ void issue_rows(Rows<NB, H>& rows, const int* __restrict__ idx,
                                           const Bases& bases, long long n, long long hb,
                                           long long step) {
    long long r[H];
#pragma unroll
    for (int u = 0; u < H; ++u) {
        r[u] = min(hb + u * step, n - 1);
        rows.b[u] = IDX ? __ldg(idx + r[u]) : 0;
#pragma unroll
        for (int j = 0; j < BASE_SLOTS(NB); ++j) rows.v[u][j] = 0.0;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        const int kind = bases.kind[j];
        if (kind == BASE_F32) {
            const float* p = (const float*)bases.ptr[j];
#pragma unroll
            for (int u = 0; u < H; ++u) rows.v[u][j] = (double)__ldg(p + r[u]);
        } else if (kind == BASE_I64) {
            const long long* p = (const long long*)bases.ptr[j];
#pragma unroll
            for (int u = 0; u < H; ++u) rows.v[u][j] = __longlong_as_double(__ldg(p + r[u]));
        } else {
            const double* p = (const double*)bases.ptr[j];
#pragma unroll
            for (int u = 0; u < H; ++u) rows.v[u][j] = __ldg(p + r[u]);
        }
    }
}

// The raw values of issue_rows' H rows as values less each base's shift
// (moments_common.cuh), once their loads are back: the word sh[j], or with
// TABLE the word of the row's bin in the CTA's copy of the tables, tab
// ([nb][G], load_table); the branch on a base's kind is taken once for the
// H rows.
template <int NB, int H, bool TABLE = false>
__device__ __forceinline__ void shift_rows(Rows<NB, H>& rows, const Bases& bases,
                                           const unsigned long long (&sh)[BASE_SLOTS(NB)],
                                           const unsigned long long* tab = nullptr, int G = 1) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        if (bases.kind[j] == BASE_I64) {
#pragma unroll
            for (int u = 0; u < H; ++u)
                rows.v[u][j] = shifted_i64(__double_as_longlong(rows.v[u][j]),
                                           TABLE ? table_word(tab, j, G, G, rows.b[u]) : sh[j]);
        } else {
#pragma unroll
            for (int u = 0; u < H; ++u)
                rows.v[u][j] = shifted_f(rows.v[u][j],
                                         TABLE ? table_word(tab, j, G, G, rows.b[u]) : sh[j]);
        }
    }
}

// The bitmask of a row's bases that are NaN.
template <int NB>
__device__ __forceinline__ unsigned missing_bases(const double (&v)[BASE_SLOTS(NB)]) {
    unsigned missing = 0u;
#pragma unroll
    for (int j = 0; j < NB; ++j)
        if (v[j] != v[j]) missing |= 1u << j;
    return missing;
}

template <int NB, bool TABLE>
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

    const size_t grid_words = (size_t)warps * ((size_t)C * G + (size_t)n_float * STAGE_ROWS);
    unsigned long long* tab = smem + grid_words;  // TABLE: [NB][G] shift words
    zero_smem(smem, grid_words);
    unsigned long long sh[BASE_SLOTS(NB)];
    load_shifts<NB>(bases, sh);
    if constexpr (TABLE) load_table<NB>(bases, G, 0, G, G, tab);
    __syncthreads();

    // a warp takes rows base + u * warp_step + lane, u < UNROLL
    const long long warp_step = (long long)gridDim.x * warps * 32;
    for (long long base = ((long long)blockIdx.x * warps + warp) * 32; base < n;
         base += UNROLL * warp_step) {  // trip count is uniform across the warp
        // every load of the UNROLL rows is issued before any is used
        Rows<NB, UNROLL> rows;
        issue_rows(rows, idx, bases, n, base + lane, warp_step);
        shift_rows<NB, UNROLL, TABLE>(rows, bases, sh, tab, G);
        const auto& v = rows.v;
        int b[UNROLL];
        unsigned missing[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const bool kept = base + u * warp_step + lane < n && (unsigned)rows.b[u] < (unsigned)G;
            b[u] = kept ? rows.b[u] : -1;
            missing[u] = missing_bases<NB>(v[u]);
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

// Rows a lane of the lane route takes per step: its bases stay in registers
// until the step's adds, so the more bases, the fewer rows.
template <int NB>
__host__ __device__ constexpr int lane_rows() {
    return NB <= 1 ? 32 : NB == 2 ? 16 : 8;
}

// Words (8 bytes) of one warp's lane grids: [n_count][G][32] 32-bit counts,
// then [n_float][G][32] doubles.
__host__ __device__ __forceinline__ size_t lane_words(int G, int n_count, int n_float) {
    return (size_t)n_count * G * 16 + (size_t)n_float * G * 32;
}

// One CTA of the lane route (see the top of this file): every lane a private
// grid, grid-stride over rows in warp steps of lane_rows<NB>() * 32, then one
// [C, G] partial written to scratch[blockIdx.x].  SET is a compiled term set
// (SET_VAR, SET_CORR) or SET_ANY (the run-time tables); with G1 and a
// compiled set a lane keeps its terms in registers for the whole call; IDX
// false (G1 only): no idx, every row in bin 0; TABLE (not G1): a shift a
// cell, its [NB][G] words copied after the warps' grids.
template <int NB, int SET, bool G1, bool IDX, bool TABLE>
__global__ void __launch_bounds__(256)
moment_lanes(const int* __restrict__ idx, long long n, int G, Bases bases, Terms terms,
             int n_count, int n_float, unsigned long long* __restrict__ scratch) {
    constexpr int H = lane_rows<NB>() / 2;  // rows of a half step
    constexpr bool FIXED = SET != SET_ANY;
    constexpr int NF = FIXED ? set_floats<SET>() : 1;
    extern __shared__ unsigned long long smem[];
    const int warps = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const size_t words = lane_words(G, n_count, n_float);
    const size_t count_words = (size_t)n_count * G * 16;
    unsigned* counts = reinterpret_cast<unsigned*>(smem + (size_t)warp * words);
    double* sums = reinterpret_cast<double*>(smem + (size_t)warp * words + count_words);
    const size_t plane = (size_t)G * 32;  // a term's lane grid

    unsigned long long* tab = smem + (size_t)warps * words;  // TABLE: [NB][G] shift words
    zero_smem(smem, (size_t)warps * words);
    unsigned long long sh[BASE_SLOTS(NB)];
    load_shifts<NB>(bases, sh);
    if constexpr (TABLE) load_table<NB>(bases, G, 0, G, G, tab);
    __syncthreads();

    unsigned held_count = 0u;  // G1 and a compiled set: the lane's terms
    double held[NF];
#pragma unroll
    for (int k = 0; k < NF; ++k) held[k] = 0.0;

    // The rows [hb + u * step, u < H] of a half step into the lane's grid
    // (their loads issued a half step before).
    auto add = [&](Rows<NB, H>& rows, long long hb, long long step) {
        shift_rows<NB, H, TABLE>(rows, bases, sh, tab, G);
#pragma unroll
        for (int u = 0; u < H; ++u) {
            const int b = rows.b[u];
            if (hb + u * step >= n || (unsigned)b >= (unsigned)G) continue;
            const unsigned missing = missing_bases<NB>(rows.v[u]);
            if constexpr (FIXED && G1) {
                held_count += set_count<SET>(terms, 0, missing);
#pragma unroll
                for (int k = 0; k < NF; ++k)
                    held[k] += set_term<NB, SET>(terms, 1 + k, rows.v[u], missing);
            } else if constexpr (FIXED) {
                // every word of a row is read before any is written (they
                // are distinct), so the reads of the row's planes issue
                // together
                unsigned* cw = counts + (size_t)b * 32 + lane;
                double* sw = sums + (size_t)b * 32 + lane;
                unsigned c = *cw;
                double x[NF];
#pragma unroll
                for (int k = 0; k < NF; ++k) x[k] = sw[k * plane];
                c += set_count<SET>(terms, 0, missing);
#pragma unroll
                for (int k = 0; k < NF; ++k)
                    x[k] += set_term<NB, SET>(terms, 1 + k, rows.v[u], missing);
                *cw = c;
#pragma unroll
                for (int k = 0; k < NF; ++k) sw[k * plane] = x[k];
            } else {
                for (int k = 0; k < n_count; ++k)
                    counts[k * plane + (size_t)b * 32 + lane] += set_count<SET>(terms, k, missing);
                for (int k = 0; k < n_float; ++k)
                    sums[k * plane + (size_t)b * 32 + lane] +=
                        term_value<NB>(terms, n_count + k, rows.v[u], missing);
            }
        }
    };

    // A lane takes its rows in half steps of H rows, hb + u * step, u < H,
    // in two register sets: the loads of the next half step are issued
    // before the adds of this one, so they are in flight while it adds
    // (instructions issue in order: an add waits on its own loads only).
    // The loop bounds are the warp's (hb - lane), so its lanes stay together.
    const long long step = (long long)gridDim.x * warps * 32;
    long long hb = ((long long)blockIdx.x * warps + warp) * 32 + lane;
    Rows<NB, H> first, second;
    if (hb - lane < n) issue_rows<NB, H, IDX>(first, idx, bases, n, hb, step);
    while (hb - lane < n) {
        const long long next = hb + H * step;
        const bool more = next - lane < n;
        if (more) issue_rows<NB, H, IDX>(second, idx, bases, n, next, step);
        add(first, hb, step);
        if (!more) break;
        hb = next + H * step;
        if (hb - lane < n) issue_rows<NB, H, IDX>(first, idx, bases, n, hb, step);
        add(second, next, step);
    }
    if constexpr (FIXED && G1) {  // bin 0's words
        counts[lane] = held_count;
#pragma unroll
        for (int k = 0; k < NF; ++k) sums[k * plane + lane] = held[k];
    }
    __syncthreads();

    // a warp per output word: lane l adds its lane's word of warp grids
    // 0, 1, ... in order, then a fixed shuffle tree adds the lanes
    const int C = n_count + n_float;
    unsigned long long* out = scratch + (size_t)blockIdx.x * C * G;
    for (int j = warp; j < C * G; j += warps) {
        const size_t at = (size_t)j * 32 + lane;  // word j of the lane's [C, G] grid
        if (j < n_count * G) {
            unsigned long long s = 0ull;
            for (int w = 0; w < warps; ++w)
                s += reinterpret_cast<const unsigned*>(smem + (size_t)w * words)[at];
            for (int o = 16; o; o >>= 1) s += __shfl_down_sync(FULL_MASK, s, o);
            if (lane == 0) out[j] = s;
        } else {
            double s = 0.0;
            for (int w = 0; w < warps; ++w)
                s += reinterpret_cast<const double*>(smem + (size_t)w * words + count_words)[
                    at - (size_t)n_count * G * 32];
            for (int o = 16; o; o >>= 1) s += __shfl_down_sync(FULL_MASK, s, o);
            if (lane == 0) reinterpret_cast<double*>(out)[j] = s;
        }
    }
}

// The lane route's instance for nb bases and a compiled set (var, corr) or
// the run-time tables.
template <bool G1, bool IDX, bool TABLE = false>
static auto lane_kernel(int nb, int set) {
    if (set == SET_VAR) return moment_lanes<1, SET_VAR, G1, IDX, TABLE>;
    if (set == SET_CORR) return moment_lanes<2, SET_CORR, G1, IDX, TABLE>;
    return nb == 0   ? moment_lanes<0, SET_ANY, G1, IDX, TABLE>
           : nb == 1 ? moment_lanes<1, SET_ANY, G1, IDX, TABLE>
           : nb == 2 ? moment_lanes<2, SET_ANY, G1, IDX, TABLE>
           : nb == 3 ? moment_lanes<3, SET_ANY, G1, IDX, TABLE>
                     : moment_lanes<4, SET_ANY, G1, IDX, TABLE>;
}

// The warp route's instance for nb bases, with or without a shift table.
template <bool TABLE>
static auto partials_kernel(int nb) {
    return nb == 0   ? moment_partials<0, TABLE>
           : nb == 1 ? moment_partials<1, TABLE>
           : nb == 2 ? moment_partials<2, TABLE>
           : nb == 3 ? moment_partials<3, TABLE>
                     : moment_partials<4, TABLE>;
}

extern "C" {

MOMENT_LIBRARY_INFO(grid_moments)

// Rows a lane of the lane route takes per step, for nb bases.
int grid_moments_lane_rows(int nb) {
    return nb <= 1 ? lane_rows<1>() : nb == 2 ? lane_rows<2>() : lane_rows<3>();
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 on
// success), or -1 when the arguments do not fit the kernel.
//   idx: device [n] int32, or null on the lane route at G = 1: every row in
//     bin 0;
//   base_ptrs / base_kinds: HOST arrays, nb entries (BASE_F64/F32/I64);
//   shift: DEVICE array of nb shift words (moments_common.cuh), or null;
//     per_cell: [nb][G] words instead, a shift a cell (G > 1; the table
//     takes 8 * nb * G bytes of shared memory beside the grids: within
//     CLUSTER_SMEM on both routes);
//   term_a / term_b / term_need: HOST arrays, n_count count terms, then
//     n_float float terms;
//   W: must equal G (the window kernel's argument, one window here);
//   n_ctas: CTAs at most; the launch takes fewer where fewer of them fit an
//     SM at once than the plan assumed (it counts shared memory only), so
//     that no second wave of CTAs runs on a part of the card;
//   lane: the lane route (n < 2^32, at most 8 warps), else the warp route;
//   scratch: device [n_ctas, C, G] 8-byte words, C = n_count + n_float;
//   out_int [n_count, G] int64, out_float [n_float, G] float64.
int grid_moments_run(const int* idx, long long n, int G, int W, const void* const* base_ptrs,
                     const int* base_kinds, int nb, const void* shift, int per_cell,
                     const int* term_a, const int* term_b,
                     const unsigned* term_need, int n_count, int n_float, int n_ctas,
                     int warps, int lane, unsigned long long* scratch, long long* out_int,
                     double* out_float, void* stream) {
    Bases bases;
    Terms terms;
    if (G < 1 || W != G || n < 0 || n_ctas < 1 || warps < 1 || warps > 32 ||
        (!idx && n > 0 && (G != 1 || !lane)) || (per_cell && (G < 2 || !idx)) ||
        !make_tables(base_ptrs, base_kinds, nb, shift, per_cell, term_a, term_b, term_need,
                     n_count, n_float, &bases, &terms))
        return -1;
    const int C = n_count + n_float;
    const size_t table = per_cell ? (size_t)nb * G * sizeof(unsigned long long) : 0;
    size_t smem;
    void (*kernel)(const int*, long long, int, Bases, Terms, int, int, unsigned long long*);
    if (lane) {
        smem = lane_words(G, n_count, n_float) * warps * sizeof(unsigned long long) + table;
        if (smem > CLUSTER_SMEM || warps > 8 || n >= (1LL << 32)) return -1;
        const int set = term_set(nb, term_a, term_b, term_need, n_count, n_float);
        kernel = per_cell ? lane_kernel<false, true, true>(nb, set)
                 : G > 1  ? lane_kernel<false, true>(nb, set)
                 : idx    ? lane_kernel<true, true>(nb, set)
                          : lane_kernel<true, false>(nb, set);
    } else {
        smem = (size_t)warps * ((size_t)C * G + (size_t)n_float * STAGE_ROWS) *
               sizeof(unsigned long long);
        if (smem > SMEM_BUDGET || smem + table > CLUSTER_SMEM) return -1;
        smem += table;
        kernel = per_cell ? partials_kernel<true>(nb) : partials_kernel<false>(nb);
    }
    cudaStream_t s = (cudaStream_t)stream;
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
