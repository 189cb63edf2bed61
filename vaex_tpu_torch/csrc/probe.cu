// Ordinal of each row's value among M sorted, unique, NaN-free keys, or -1,
// for Hopper (sm_90a).  Built by nvcc into a shared library with a plain C
// interface and loaded with ctypes (vaex_tpu_torch/ops/probe.py).
//
// Replaces the TPU kernel vaex_tpu/ops/pallas_probe.py:_probe_kernel (via
// probe_ordinals).  That kernel compares a block of rows against every key,
// O(N * M), as (lo32, hi32) word pairs after normalising -0.0, because the
// TPU has no 64-bit integers and no cheap gather.  Hopper has both, so this
// kernel keeps only the function and searches a static tree with native
// compares.  With IEEE compares -0.0 equals 0.0 and NaN equals nothing, so a
// -0.0 row finds the key 0.0 and a NaN row gives -1 with no normalisation.
//
// The layout (built once per set by the wrapper with torch indexing) is a
// static B+-tree whose nodes are one line of L keys, LINE = 32 bytes (it
// beat 64 and 128 at every set size the paths use on an NVIDIA H100,
// PERF.md section 6):
//   * the leaves are the sorted keys themselves, cut into lines of L keys,
//     the last line padded with the type's maximum (a pad never matches: a
//     hit is taken only at a position below M, since INT64_MAX and +inf are
//     legal keys);
//   * an inner node holds L separators, the first keys of its children 1..L
//     (it has L + 1 children), level by level from the root, node by node;
//     only the last node of a level is padded, and the child index a row
//     takes is clamped to the level below, so a pad counted by a row equal
//     to the maximum still leads to the last real child.
// A row counts the separators <= v in one node per level (one line read
// with independent 16-byte vector loads, no dependent step inside a node),
// steps to that child, and in its leaf tests equality against the same
// registers.  At M = 500 in 32-byte lines (4 int64 keys) that is 3
// dependent steps and a leaf, where a binary search takes 9; each step
// reads 32 bytes a lane, so a warp's read of a level costs 8 shared-memory
// wavefronts where 64-byte lines cost 16.
//
// Routes:
//   * leaves_shared = 1 ("b6"): the whole tree, leaves included, is staged
//     into each CTA's shared memory while it fits;
//   * leaves_shared = 0 ("b6-wide"): the top shared_levels levels in shared
//     memory, the rest and the leaves in global memory (L2), one line per
//     level and row.  Sets of 1e7 keys and beyond.
// In shared memory each lane reads the chunks of its line in an order
// rotated by its lane number, so that lanes reading one line at once spread
// over its 16-byte bank groups.
//
// Key kinds: int64 or float64 keys, or, for an integer set whose range
// keys[M-1] - keys[0] is below 2^32, uint32 offsets from keys[0] (twice
// the keys per line); a row outside [keys[0], keys[M-1]] then misses
// before the search.
//
// Contract (the plain version is probe_reference in the wrapper; the
// layout's own plain search is tree_search_reference):
//   x    [N] int64 or int32 against integer keys, float64 or float32 against
//        float64 keys (narrow types widen exactly in the load);
//   out  [N] int32: the position of the key equal to x[r], else -1.
//
// What bounds it on an H100: the HBM read of x and the write of out, 12
// bytes/row for 8-byte rows, 0.36 ms per 1e8 rows at the datasheet peak of
// 3.35 TB/s; then the shared-memory bandwidth (one line per inner level and
// row below the root, whose line every lane of a warp shares), and on the
// wide route the L2's (one line per global level and row).  Every thread
// runs U searches at once, on rows a CTA-width apart, so that loads and
// stores stay coalesced: U = 8 on b6, 4 on b6-wide, where rows wait on L2
// (each measured best on its route).

#include <cuda_runtime.h>

#define SMEM_BUDGET (227 * 1024)
#define MAX_LEVELS 14
#define LINE 32

struct Tree {
    int levels;                     // inner levels, root first
    int shared_levels;              // the first shared_levels are staged in shared memory
    int node_off[MAX_LEVELS + 1];   // first node of each level; [levels] = inner nodes
    int count[MAX_LEVELS + 1];      // nodes of each level; [levels] = leaves
};

// One 16-byte vector of keys.
template <typename K> struct Vec;
template <> struct Vec<long long> {
    typedef longlong2 T;
    enum { N = 2 };
    static __device__ __forceinline__ long long at(const T& v, int j) { return j ? v.y : v.x; }
};
template <> struct Vec<double> {
    typedef double2 T;
    enum { N = 2 };
    static __device__ __forceinline__ double at(const T& v, int j) { return j ? v.y : v.x; }
};
template <> struct Vec<unsigned> {
    typedef uint4 T;
    enum { N = 4 };
    static __device__ __forceinline__ unsigned at(const T& v, int j) {
        return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
    }
};

// Row r of x as a key of the tree; false when it cannot be in the set.
template <typename K, typename X> struct Row {
    static __device__ __forceinline__ bool load(const X* x, long long r, long long, unsigned long long,
                                                K& v) {
        v = (K)__ldg(x + r);
        return true;
    }
};
template <typename X> struct Row<unsigned, X> {
    static __device__ __forceinline__ bool load(const X* x, long long r, long long base,
                                                unsigned long long range, unsigned& v) {
        const long long w = (long long)__ldg(x + r);
        const unsigned long long d = (unsigned long long)w - (unsigned long long)base;
        v = (unsigned)d;
        return w >= base && d <= range;
    }
};

// The number of keys <= v in one node of L keys.
template <typename K, int L, bool SMEM>
__device__ __forceinline__ int count_le(const K* node, K v, int rot) {
    typedef Vec<K> V;
    constexpr int NCH = L / V::N;
    const typename V::T* p = reinterpret_cast<const typename V::T*>(node);
    int r = 0;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
        const int c = SMEM ? ((i + rot) & (NCH - 1)) : i;
        const typename V::T w = SMEM ? p[c] : __ldg(p + c);
#pragma unroll
        for (int j = 0; j < V::N; ++j) r += V::at(w, j) <= v;
    }
    return r;
}

// The position of the key equal to v in the leaf of L keys that starts at
// position `first`, or -1; positions at or past M are pads.
template <typename K, int L, bool SMEM>
__device__ __forceinline__ int leaf_find(const K* leaf, K v, int first, int M, int rot) {
    typedef Vec<K> V;
    constexpr int NCH = L / V::N;
    const typename V::T* p = reinterpret_cast<const typename V::T*>(leaf);
    int hit = -1;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
        const int c = SMEM ? ((i + rot) & (NCH - 1)) : i;
        const typename V::T w = SMEM ? p[c] : __ldg(p + c);
#pragma unroll
        for (int j = 0; j < V::N; ++j) {
            const int pos = first + c * V::N + j;
            if (V::at(w, j) == v && pos < M) hit = pos;
        }
    }
    return hit;
}

template <typename K, typename X, bool LEAVES_SHARED>
__global__ void __launch_bounds__(1024)
probe_tree(const K* __restrict__ inner, const K* __restrict__ leaves, Tree t, int M,
           long long base, unsigned long long range, const X* __restrict__ x, long long n,
           int* __restrict__ out) {
    constexpr int L = LINE / sizeof(K);
    constexpr int U = LEAVES_SHARED ? 8 : 4;
    extern __shared__ uint4 smem_v[];
    const K* sk = reinterpret_cast<const K*>(smem_v);
    // stage the top levels (and the leaves) with 16-byte copies, two a node
    const int shared_keys = t.node_off[t.shared_levels] * L;
    const int inner16 = shared_keys * (int)sizeof(K) / 16;
    for (int i = threadIdx.x; i < inner16; i += blockDim.x)
        smem_v[i] = __ldg(reinterpret_cast<const uint4*>(inner) + i);
    if (LEAVES_SHARED) {
        const int leaf16 = t.count[t.levels] * L * (int)sizeof(K) / 16;
        for (int i = threadIdx.x; i < leaf16; i += blockDim.x)
            smem_v[inner16 + i] = __ldg(reinterpret_cast<const uint4*>(leaves) + i);
    }
    __syncthreads();
    const K* sleaves = sk + shared_keys;
    const int rot = threadIdx.x & 31;

    const long long stride = (long long)gridDim.x * blockDim.x * U;
    for (long long b0 = (long long)blockIdx.x * blockDim.x * U + threadIdx.x; b0 < n;
         b0 += stride) {
        K v[U];
        bool in[U];
        int c[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long r = b0 + (long long)u * blockDim.x;
            v[u] = (K)0;
            in[u] = r < n && Row<K, X>::load(x, r, base, range, v[u]);
            c[u] = 0;
        }
        int h = 0;
        for (; h < t.shared_levels; ++h) {
            const int off = t.node_off[h], last = t.count[h + 1] - 1;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int r = count_le<K, L, true>(sk + (size_t)(off + c[u]) * L, v[u], rot);
                c[u] = min(c[u] * (L + 1) + r, last);
            }
        }
        for (; h < t.levels; ++h) {
            const int off = t.node_off[h], last = t.count[h + 1] - 1;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int r = count_le<K, L, false>(inner + (size_t)(off + c[u]) * L, v[u], rot);
                c[u] = min(c[u] * (L + 1) + r, last);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long r = b0 + (long long)u * blockDim.x;
            int hit = -1;
            if (in[u])
                hit = LEAVES_SHARED
                          ? leaf_find<K, L, true>(sleaves + (size_t)c[u] * L, v[u], c[u] * L, M, rot)
                          : leaf_find<K, L, false>(leaves + (size_t)c[u] * L, v[u], c[u] * L, M, rot);
            if (r < n) out[r] = hit;
        }
    }
}

struct Args {
    const void* inner;
    const void* leaves;
    Tree t;
    int M;
    long long base;
    unsigned long long range;
    const void* x;
    long long n;
    int* out;
    int n_ctas, threads;
    cudaStream_t s;
};

// Shared memory of a launch: the staged top levels and, on the b6 route,
// the leaves.
static size_t smem_bytes(const Tree& t, bool leaves_shared) {
    return ((size_t)t.node_off[t.shared_levels] + (leaves_shared ? (size_t)t.count[t.levels] : 0)) *
           LINE;
}

template <typename K, typename X, bool LS>
static int launch(const Args& a) {
    const size_t smem = smem_bytes(a.t, LS);
    if (smem > SMEM_BUDGET) return -1;
    auto kernel = probe_tree<K, X, LS>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<a.n_ctas, a.threads, smem, a.s>>>((const K*)a.inner, (const K*)a.leaves, a.t, a.M,
                                                a.base, a.range, (const X*)a.x, a.n, a.out);
    return (int)cudaGetLastError();
}

template <typename K, typename X>
static int launch_route(const Args& a, bool leaves_shared) {
    return leaves_shared ? launch<K, X, true>(a) : launch<K, X, false>(a);
}

extern "C" {

int probe_smem_budget(void) { return SMEM_BUDGET; }

int probe_max_levels(void) { return MAX_LEVELS; }

int probe_line_bytes(void) { return LINE; }

// Launches the search on `stream`; returns cudaGetLastError() (0 on
// success), or -1 when the arguments do not fit the kernel.
//   key_kind: 0 int64 keys, 1 float64 keys, 2 uint32 offsets from `base`
//             (rows outside [base, base + range] miss);
//   leaves_shared: 1 for the b6 route (every level in shared memory);
//   meta: HOST ints [levels, shared_levels, node_off[0..levels],
//         count[0..levels]];
//   inner, leaves: device arrays, 16-byte aligned, of whole nodes;
//   x_bytes: 8 or 4, the width of a row of x (of the keys' kind).
int probe_run(int key_kind, int leaves_shared, const void* inner,
              const void* leaves, const int* meta, int M, long long base,
              unsigned long long range, const void* x, int x_bytes, long long n, int* out,
              int n_ctas, int threads, void* stream) {
    Args a;
    a.t.levels = meta[0];
    a.t.shared_levels = meta[1];
    if (a.t.levels < 0 || a.t.levels > MAX_LEVELS || a.t.shared_levels < 0 ||
        a.t.shared_levels > a.t.levels || (leaves_shared && a.t.shared_levels != a.t.levels))
        return -1;
    for (int h = 0; h <= a.t.levels; ++h) {
        a.t.node_off[h] = meta[2 + h];
        a.t.count[h] = meta[3 + a.t.levels + h];
    }
    if (M < 1 || n < 0 || n_ctas < 1 || threads < 32 || threads > 1024 || threads % 32 ||
        (x_bytes != 8 && x_bytes != 4) || key_kind < 0 || key_kind > 2 || a.t.count[0] < 1)
        return -1;
    a.inner = inner;
    a.leaves = leaves;
    a.M = M;
    a.base = base;
    a.range = range;
    a.x = x;
    a.n = n;
    a.out = out;
    a.n_ctas = n_ctas;
    a.threads = threads;
    a.s = (cudaStream_t)stream;
    const bool ls = leaves_shared != 0;
    if (key_kind == 0)
        return x_bytes == 8 ? launch_route<long long, long long>(a, ls)
                            : launch_route<long long, int>(a, ls);
    if (key_kind == 1)
        return x_bytes == 8 ? launch_route<double, double>(a, ls)
                            : launch_route<double, float>(a, ls);
    return x_bytes == 8 ? launch_route<unsigned, long long>(a, ls)
                        : launch_route<unsigned, int>(a, ls);
}

const char* probe_error_string(int code) {
    if (code == -1) return "arguments do not fit the probe kernel";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
