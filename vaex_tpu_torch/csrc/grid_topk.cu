// Per-cell top-k of small k on the resident route ("b3x-l2-topk"), for
// Hopper (sm_90a).  Built by nvcc into a shared library with a plain C
// interface and loaded with ctypes (vaex_tpu_torch/ops/grid_topk.py).
//
// Replaces no TPU kernel: vaex_tpu computes the top-k with XLA sorts
// (vaex_tpu/agg.py:629-716), and the port's first version sorted every tile
// by (cell, value) twice, with gathers, to keep at most k values a cell.
// This kernel finds them in k rounds over the rows instead, each a pass as
// cheap as the resident min/max route of grid_partition.cu (resident_extremes,
// "b3x-l2"), whose order image and run combine it shares.
//
// The order image: a value becomes a 64-bit unsigned key whose order is the
// value's (int64: the sign bit flipped; floats, widened to double: the IEEE
// bits, inverted when negative, else with the sign bit set), complemented
// for the largest values, so that the best value of a cell has the smallest
// key.  A missing row (a masked row, NaN, NaT, an index outside [0, G)) takes
// the key of all ones, EMPTY_KEY, which no round counts.  -0.0 orders below
// 0.0; by value the slots equal what a sort by value keeps.
//
// The rounds, over one [G, 2] grid of key pairs in device memory that stays
// in L2 up to about 1.5e6 cells (a cell's pair side by side, so one 16-byte
// L2 load reads both; past that each load goes to HBM and a round costs
// more, so the plan takes fewer slots there):
//   * round 1 takes, per cell, the smallest key m1 of its rows into the
//     pair's second word (a run-combine, an L2 read of the cell and an
//     atomicMin only where the row's key is smaller: resident_extremes's
//     scheme);
//   * before round j > 1, topk_shift keeps m(j-1) in the levels [k, G] and
//     moves it into the pair's first word, the threshold, the second word
//     back to EMPTY_KEY;
//   * round j reads each row's pair: a row whose key equals the threshold
//     adds to the cell's count c(j-1) (saturating at k: a count is needed
//     only up to k), a row whose key is strictly larger competes for mj.
// A cell's k best values are then m1 repeated c1 times, m2 repeated c2
// times, and so on, cut at k: every level a cell holds has a count of at
// least one, so after levels 1 .. k-1 at most one slot is left, which mk
// fills when the cell has it.  That is exactly the multiset a sort keeps,
// ties included.  topk_finish, one thread per cell, writes those k slots
// merged with the cell's k values from earlier tiles (the state, in place,
// in its type), so a pass keeps one [G, k] state; an empty slot holds the
// fill: -inf (+inf) for floats, the int64 min (max), for the largest
// (smallest).
//
// What bounds it on an H100: each round streams idx and the values (4 + 8
// bytes a row, 0.36 ms per 1e8 rows at 3.35 TB/s) and makes one L2 request
// a row for the cell's pair, as b3x-l2 makes one for its cell: that request
// rate, not HBM, sets its pace.  The atomics are few: after a cell's first
// rows a row's key rarely beats the cell's (about H(100) = 5.2 updates a
// cell of 100 uniform rows), and a count stops at k.

#include "grid_common.cuh"

#define SIGN_BIT 0x8000000000000000ull
#define EMPTY_KEY 0xffffffffffffffffull
#define INT64_LOWEST ((long long)SIGN_BIT)
// the most slots a cell may ask for: topk_finish holds two lists of MAX_K keys
#define MAX_K 16

struct TopkColumn {
    const void* values;         // [n] int64, float64 or float32
    const unsigned char* mask;  // [n] nonzero where the row is missing, or null
    int type;                   // 0 int64, 1 float64, 2 float32
    int nat;                    // 1: an int64 value of INT64_LOWEST (NaT) is missing
    int largest;                // 1: the k largest values, 0: the k smallest
};

__device__ __forceinline__ unsigned long long double_key(double v) {
    const long long bits = __double_as_longlong(v);
    return bits < 0 ? ~(unsigned long long)bits : (unsigned long long)bits | SIGN_BIT;
}

// The keys of rows r[u] (b[u] < 0: the row reaches no cell), read with
// streaming loads that leave L2 to the grid; the branch on the type is taken
// once for the U rows, so all their loads are in flight together.
template <int U>
__device__ __forceinline__ void row_keys(const TopkColumn& c, const long long (&r)[U],
                                         const int (&b)[U], long long n,
                                         unsigned long long (&key)[U]) {
    long long at[U];  // the loads are unconditional: a row past n reads row n - 1
    bool drop[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        at[u] = min(r[u], n - 1);
        drop[u] = b[u] < 0;
    }
    if (c.type == 0) {
        const long long* col = (const long long*)c.values;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long v = __ldcs(col + at[u]);
            drop[u] |= c.nat && v == INT64_LOWEST;
            key[u] = (unsigned long long)v ^ SIGN_BIT;
        }
    } else {
        double v[U];
        if (c.type == 2) {
#pragma unroll
            for (int u = 0; u < U; ++u) v[u] = (double)__ldcs((const float*)c.values + at[u]);
        } else {
#pragma unroll
            for (int u = 0; u < U; ++u) v[u] = __ldcs((const double*)c.values + at[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            drop[u] |= v[u] != v[u];
            key[u] = double_key(v[u]);
        }
    }
    if (c.mask) {
#pragma unroll
        for (int u = 0; u < U; ++u) drop[u] |= __ldcs(c.mask + at[u]) != 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        if (c.largest) key[u] = ~key[u];
        if (drop[u]) key[u] = EMPTY_KEY;
    }
}

// The first lane of the run of neighbouring lanes that holds `lane`.
__device__ __forceinline__ int run_first(unsigned heads, int lane) {
    return 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
}

// One round over the rows: every warp takes rows base + u * step + lane, as
// resident_extremes walks them.  The lanes of a run of neighbouring lanes
// with one cell are combined first; the run's first lane reads the cell's
// pair with an L2 load (__ldcg: L1 is not coherent across SMs) and makes the
// atomics.  FIRST: the smallest key into the pair's second word.  Else: the
// rows equal to the pair's first word (the threshold) add to count[cell]
// while it is below k, and the smallest key above it goes into the second
// word; a stale read costs a spare atomic, never a lost key or count.
template <bool FIRST>
__global__ void __launch_bounds__(256)
topk_round(const int* __restrict__ idx, long long n, int G, TopkColumn col, unsigned k,
           unsigned long long* __restrict__ pair, unsigned* __restrict__ count) {
    const int lane = threadIdx.x & 31;
    const long long step = (long long)gridDim.x * blockDim.x;
    // the loop bound is the warp's, so its lanes stay together
    for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x - lane); base < n;
         base += UNROLL * step) {
        int b[UNROLL];
        long long r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            r[u] = base + u * step + lane;
            const int t = __ldcs(idx + min(r[u], n - 1));
            b[u] = r[u] < n && (unsigned)t < (unsigned)G ? t : -1;
        }
        unsigned long long key[UNROLL];
        row_keys<UNROLL>(col, r, b, n, key);
        Combine run[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) run[u] = Combine::runs(b[u], lane);
        if constexpr (FIRST) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) key[u] = run[u].run_min(key[u], lane);
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                if (!run[u].lead || key[u] == EMPTY_KEY) continue;
                unsigned long long* best = pair + 2 * (size_t)b[u] + 1;
                if (key[u] < __ldcg(best)) atomicMin(best, key[u]);
            }
        } else {
            ulonglong2 now[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                now[u] = run[u].lead ? __ldcg(reinterpret_cast<const ulonglong2*>(pair) + b[u])
                                     : make_ulonglong2(EMPTY_KEY, EMPTY_KEY);
            unsigned ties[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                unsigned long long threshold = now[u].x;
                if (run[u].heads != FULL_MASK)  // uniform across the warp
                    threshold = __shfl_sync(FULL_MASK, threshold, run_first(run[u].heads, lane));
                ties[u] = run[u].sum((unsigned)(key[u] != EMPTY_KEY && key[u] == threshold), lane);
                key[u] = run[u].run_min(key[u] > threshold ? key[u] : EMPTY_KEY, lane);
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                if (!run[u].lead) continue;
                if (ties[u] && __ldcg(count + b[u]) < k) atomicAdd(count + b[u], ties[u]);
                if (key[u] < now[u].y) atomicMin(pair + 2 * (size_t)b[u] + 1, key[u]);
            }
        }
    }
}

// Between rounds, one thread per cell: the round's best key kept as a level
// and made the next round's threshold.
__global__ void topk_shift(int G, ulonglong2* __restrict__ pair,
                           unsigned long long* __restrict__ level) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= G) return;
    const unsigned long long best = pair[g].y;
    level[g] = best;
    pair[g] = make_ulonglong2(best, EMPTY_KEY);
}

__device__ __forceinline__ unsigned long long state_key(const TopkColumn& c, const void* state,
                                                        size_t j) {
    const unsigned long long key =
        c.type == 0   ? (unsigned long long)((const long long*)state)[j] ^ SIGN_BIT
        : c.type == 2 ? double_key((double)((const float*)state)[j])
                      : double_key(((const double*)state)[j]);
    return c.largest ? ~key : key;
}

__device__ __forceinline__ void store_key(const TopkColumn& c, void* state, size_t j,
                                          unsigned long long key) {
    const unsigned long long ord = c.largest ? ~key : key;
    if (c.type == 0) {  // the empty key is the fill's: the int64 min (max) for largest (smallest)
        ((long long*)state)[j] = (long long)(ord ^ SIGN_BIT);
        return;
    }
    const double inf = __longlong_as_double(0x7ff0000000000000ll);
    const double v = key == EMPTY_KEY ? (c.largest ? -inf : inf)
                     : __longlong_as_double((long long)((ord & SIGN_BIT) ? ord ^ SIGN_BIT : ~ord));
    if (c.type == 2)
        ((float*)state)[j] = (float)v;
    else
        ((double*)state)[j] = v;
}

// One thread per cell: the tile's k slots from the levels and their counts,
// merged with the cell's k values of the state [G, k], which it overwrites.
__global__ void topk_finish(int G, int k, TopkColumn col, const ulonglong2* __restrict__ pair,
                            const unsigned long long* __restrict__ levels,
                            const unsigned* __restrict__ counts, void* __restrict__ state) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= G) return;
    unsigned long long tile[MAX_K], held[MAX_K];
    int filled = 0;
    bool more = true;  // false past the cell's last value
    for (int l = 0; l + 1 < k && more && filled < k; ++l) {
        const unsigned long long m = levels[(size_t)l * G + g];
        more = m != EMPTY_KEY;
        for (unsigned c = more ? counts[(size_t)l * G + g] : 0u; c && filled < k; --c)
            tile[filled++] = m;
    }
    if (more && filled < k && pair[g].y != EMPTY_KEY) tile[filled++] = pair[g].y;
    for (int i = filled; i < k; ++i) tile[i] = EMPTY_KEY;
    // the state's k keys, in order (insertion: k is small)
    for (int i = 0; i < k; ++i) {
        const unsigned long long v = state_key(col, state, (size_t)g * k + i);
        int at = i;
        for (; at > 0 && held[at - 1] > v; --at) held[at] = held[at - 1];
        held[at] = v;
    }
    int a = 0, h = 0;
    for (int i = 0; i < k; ++i) {
        const unsigned long long v = tile[a] <= held[h] ? tile[a++] : held[h++];
        store_key(col, state, (size_t)g * k + i, v);
    }
}

extern "C" {

int grid_topk_max_k(void) { return MAX_K; }

// The k best values per cell of one tile, merged into the state.
//   idx: device [n] int32, rows outside [0, G) drop;
//   values: device [n], type 0 int64, 1 float64, 2 float32;
//   mask: device [n] bytes, nonzero where the row is missing, or null;
//   nat: 1 where an int64 value of the int64 min is missing (NaT);
//   state: device [G, k] in the values' type, overwritten with the k best of
//          its own values and the tile's, in order (best first);
//   pair: device [G, 2] 8-byte words, 16-byte aligned; levels: device
//         [k - 1, G] 8-byte words; counts: device [k - 1, G] 4-byte words
//         (scratch, set here).
// Returns cudaGetLastError(), or -1 when the arguments do not fit.
int grid_topk(const int* idx, long long n, int G, const void* values, int type,
              const unsigned char* mask, int nat, int largest, int k, int n_ctas, int threads,
              void* state, unsigned long long* pair, unsigned long long* levels,
              unsigned* counts, void* stream) {
    if (G < 1 || k < 1 || k > MAX_K || type < 0 || type > 2 || n < 0 || n_ctas < 1 ||
        threads < 32 || threads > 256 || threads % 32 || (n > 0 && !(idx && values)) ||
        !state || !pair || (k > 1 && !(levels && counts)) ||
        (unsigned long long)pair % 16)
        return -1;
    const TopkColumn col = {values, mask, type, nat != 0, largest != 0};
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(pair, 0xff, (size_t)G * 16, s);  // every key EMPTY_KEY
    if (e == cudaSuccess && k > 1) e = cudaMemsetAsync(counts, 0, (size_t)(k - 1) * G * 4, s);
    if (e != cudaSuccess) return (int)e;
    const unsigned cells = (unsigned)((G + 255) / 256);
    topk_round<true><<<n_ctas, threads, 0, s>>>(idx, n, G, col, (unsigned)k, pair, nullptr);
    for (int j = 1; j < k; ++j) {
        topk_shift<<<cells, 256, 0, s>>>(G, reinterpret_cast<ulonglong2*>(pair),
                                          levels + (size_t)(j - 1) * G);
        topk_round<false><<<n_ctas, threads, 0, s>>>(idx, n, G, col, (unsigned)k, pair,
                                                      counts + (size_t)(j - 1) * G);
    }
    topk_finish<<<cells, 256, 0, s>>>(G, k, col, reinterpret_cast<const ulonglong2*>(pair),
                                       levels, counts, state);
    return (int)cudaGetLastError();
}

const char* grid_topk_error_string(int code) {
    if (code == -1) return "arguments do not fit the grid_topk kernel";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
