// Ordinal of each row's value among M sorted, unique, NaN-free keys, or -1,
// for Hopper (sm_90a).  Built by nvcc into a shared library with a plain C
// interface and loaded with ctypes (vaex_tpu_torch/ops/probe.py).
//
// Replaces the TPU kernel vaex_tpu/ops/pallas_probe.py:_probe_kernel (via
// probe_ordinals).  That kernel compares a block of rows against every key,
// O(N * M), as (lo32, hi32) word pairs after normalising -0.0, because the
// TPU has no 64-bit integers and no cheap gather.  Hopper has both, so this
// kernel keeps only the function: the keys are staged once per CTA into
// shared memory and every thread runs a binary search there with native
// 64-bit compares, O(N log M).  With IEEE compares -0.0 equals 0.0 and NaN
// equals nothing, so a -0.0 row finds the key 0.0 and a NaN row gives -1
// with no normalisation and no word split.
//
// Two kernels serve every set size.  probe_rows takes the sets whose keys fit
// one CTA's shared memory.  probe_rows_wide takes the wider ones: the keys
// stay in global memory (a few MB of them live in the 50 MB L2), and shared
// memory holds every S-th key, the top levels of the search.  A row first
// finds its stretch of S keys among those samples, then finishes with
// log2(S) reads of the keys themselves.
//
// Contract (the plain version is probe_reference in the wrapper):
//   keys [M] int64 or float64, ascending, unique, no NaN, M >= 1; probe_run
//        takes the M that fit SMEM_BUDGET, probe_wide_run any M whose
//        ceil(M / S) samples fit it;
//   x    [N] int64 or int32 against int64 keys, float64 or float32 against
//        float64 keys (narrow types widen exactly in the load);
//   out  [N] int32: the position of the key equal to x[r], else -1.
//
// What bounds it on an H100: the HBM read of x and the write of out, 12
// bytes/row for 8-byte rows, 0.36 ms per 1e8 rows at the datasheet peak of
// 3.35 TB/s; the log2(M) shared-memory reads per row come next, with bank
// conflicts from the third level of the search on (its first levels read one
// word for the whole warp, a broadcast).  The search takes a fixed number of
// steps for all threads (the highest power of two <= M, halved), so a warp
// never diverges; every thread runs UNROLL independent searches at once to
// hide the shared-memory latency, on rows a CTA-width apart so that loads
// and stores stay coalesced.

#include <cuda_runtime.h>

#define SMEM_BUDGET (227 * 1024)
#define UNROLL 4

template <typename K, typename X>
__global__ void probe_rows(const K* __restrict__ keys, int M, int first_step,
                           const X* __restrict__ x, long long n, int* __restrict__ out) {
    extern __shared__ unsigned char smem_raw[];
    K* sk = reinterpret_cast<K*>(smem_raw);
    for (int i = threadIdx.x; i < M; i += blockDim.x) sk[i] = keys[i];
    __syncthreads();

    const long long stride = (long long)gridDim.x * blockDim.x * UNROLL;
    for (long long base = (long long)blockIdx.x * blockDim.x * UNROLL + threadIdx.x; base < n;
         base += stride) {
        K v[UNROLL];
        int pos[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long r = base + (long long)u * blockDim.x;
            v[u] = r < n ? (K)__ldg(x + r) : sk[0];
            pos[u] = 0;
        }
        // pos = the number of keys below v: the lower bound
        for (int step = first_step; step; step >>= 1) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int p = pos[u] + step;
                if (p <= M && sk[p - 1] < v[u]) pos[u] = p;
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long r = base + (long long)u * blockDim.x;
            if (r < n) out[r] = (pos[u] < M && sk[pos[u]] == v[u]) ? pos[u] : -1;
        }
    }
}

// The same function with the keys in global memory.  sk[j] = keys[j * S] for
// j < T = ceil(M / S); S is a power of two >= 2.  p1 = the number of samples
// below v.  When p1 = 0 no key is below v.  Otherwise keys[(p1 - 1) * S] < v
// and (p1 = T or keys[p1 * S] >= v), so the lower bound lies in
// [lo, lo + cnt] with lo = (p1 - 1) * S + 1 and cnt = min(p1 * S, M) - lo
// <= S - 1: a search of fixed depth log2(S) over keys[lo .. lo + cnt).
template <typename K, typename X>
__global__ void probe_rows_wide(const K* __restrict__ keys, int M, int S, int T,
                                int first_step, const X* __restrict__ x, long long n,
                                int* __restrict__ out) {
    extern __shared__ unsigned char smem_raw[];
    K* sk = reinterpret_cast<K*>(smem_raw);
    for (int j = threadIdx.x; j < T; j += blockDim.x) sk[j] = keys[(long long)j * S];
    __syncthreads();

    const long long stride = (long long)gridDim.x * blockDim.x * UNROLL;
    for (long long base = (long long)blockIdx.x * blockDim.x * UNROLL + threadIdx.x; base < n;
         base += stride) {
        K v[UNROLL];
        int pos[UNROLL], lo[UNROLL], cnt[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long r = base + (long long)u * blockDim.x;
            v[u] = r < n ? (K)__ldg(x + r) : sk[0];
            pos[u] = 0;
        }
        for (int step = first_step; step; step >>= 1) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int p = pos[u] + step;
                if (p <= T && sk[p - 1] < v[u]) pos[u] = p;
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long end = (long long)pos[u] * S;
            lo[u] = pos[u] ? (int)(end - S + 1) : 0;
            cnt[u] = pos[u] ? (int)(end < M ? end : M) - lo[u] : 0;
            pos[u] = 0;
        }
        for (int step = S >> 1; step; step >>= 1) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int p = pos[u] + step;
                if (p <= cnt[u] && __ldg(keys + lo[u] + p - 1) < v[u]) pos[u] = p;
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long r = base + (long long)u * blockDim.x;
            const int q = lo[u] + pos[u];
            if (r < n) out[r] = (q < M && __ldg(keys + q) == v[u]) ? q : -1;
        }
    }
}

template <typename K, typename X>
static int launch_wide(const void* keys, int M, int S, const void* x, long long n, int* out,
                       int n_ctas, int threads, cudaStream_t s) {
    const int T = (int)(((long long)M + S - 1) / S);
    const size_t smem = (size_t)T * sizeof(K);
    auto kernel = probe_rows_wide<K, X>;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int first_step = 1;
    while (first_step * 2 <= T) first_step *= 2;
    kernel<<<n_ctas, threads, smem, s>>>((const K*)keys, M, S, T, first_step, (const X*)x, n,
                                         out);
    return (int)cudaGetLastError();
}

template <typename K, typename X>
static int launch(const void* keys, int M, const void* x, long long n, int* out, int n_ctas,
                  int threads, cudaStream_t s) {
    const size_t smem = (size_t)M * sizeof(K);
    auto kernel = probe_rows<K, X>;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int first_step = 1;
    while (first_step * 2 <= M) first_step *= 2;
    kernel<<<n_ctas, threads, smem, s>>>((const K*)keys, M, first_step, (const X*)x, n, out);
    return (int)cudaGetLastError();
}

extern "C" {

int probe_smem_budget(void) { return SMEM_BUDGET; }

// Launches the kernel on `stream`; returns cudaGetLastError() (0 on
// success), or -1 when the arguments do not fit the kernel.
//   float_keys: 1 for float64 keys, 0 for int64 keys;
//   x_bytes: 8 or 4, the width of a row of x (of the keys' kind).
int probe_run(const void* keys, int M, int float_keys, const void* x, int x_bytes,
              long long n, int* out, int n_ctas, int threads, void* stream) {
    if (M < 1 || (size_t)M * 8 > SMEM_BUDGET || n < 0 || n_ctas < 1 || threads < 32 ||
        threads > 1024 || threads % 32 || (x_bytes != 8 && x_bytes != 4))
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    if (float_keys)
        return x_bytes == 8 ? launch<double, double>(keys, M, x, n, out, n_ctas, threads, s)
                            : launch<double, float>(keys, M, x, n, out, n_ctas, threads, s);
    return x_bytes == 8 ? launch<long long, long long>(keys, M, x, n, out, n_ctas, threads, s)
                        : launch<long long, int>(keys, M, x, n, out, n_ctas, threads, s);
}

// The same for a set of any size: S, a power of two >= 2, is the distance of
// the samples kept in shared memory, and ceil(M / S) of them must fit it.
int probe_wide_run(const void* keys, int M, int float_keys, const void* x, int x_bytes,
                   long long n, int* out, int S, int n_ctas, int threads, void* stream) {
    if (M < 1 || S < 2 || (S & (S - 1)) || (((size_t)M + S - 1) / S) * 8 > SMEM_BUDGET ||
        n < 0 || n_ctas < 1 || threads < 32 || threads > 1024 || threads % 32 ||
        (x_bytes != 8 && x_bytes != 4))
        return -1;
    cudaStream_t s = (cudaStream_t)stream;
    if (float_keys)
        return x_bytes == 8
                   ? launch_wide<double, double>(keys, M, S, x, n, out, n_ctas, threads, s)
                   : launch_wide<double, float>(keys, M, S, x, n, out, n_ctas, threads, s);
    return x_bytes == 8
               ? launch_wide<long long, long long>(keys, M, S, x, n, out, n_ctas, threads, s)
               : launch_wide<long long, int>(keys, M, S, x, n, out, n_ctas, threads, s);
}

const char* probe_error_string(int code) {
    if (code == -1) return "arguments do not fit the probe kernel";
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
