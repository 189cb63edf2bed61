// Pieces shared by the moment kernels (grid_moments.cu, B4, and
// grid_moments_window.cu, B5): the base and term tables and the term
// evaluation.  The contract is in vaex_tpu_torch/ops/grid_moments.py:
//   bases [N] (at most MAX_BASES), int64, float32 or float64, read as double;
//     NaN marks a missing value;
//   terms (at most MAX_TERMS), count terms first, then float terms; a float
//     term is base[a] * base[b] (base[a] when b < 0); a row adds to a term
//     only where none of the bases in its `need` bitmask is NaN.
// A lane loads its row's bases once into registers and evaluates every term
// from them, so no term column is ever written to device memory.  The
// kernels are templates on the number of bases, so that var (one base)
// holds one double per row in registers and corr (two) two.
#pragma once

#include "grid_common.cuh"

#define MAX_BASES 4
#define MAX_TERMS 16

#define BASE_F64 0
#define BASE_F32 1
#define BASE_I64 2

struct Bases {
    const void* ptr[MAX_BASES];
    int kind[MAX_BASES];
};

struct Terms {
    int a[MAX_TERMS];          // float terms: the first factor's base
    int b[MAX_TERMS];          // float terms: the second factor's base, or -1
    unsigned need[MAX_TERMS];  // bit j: base j must not be NaN on the row
};

// Host side: the tables from HOST arrays, as the wrappers pass them.
static inline bool make_tables(const void* const* base_ptrs, const int* base_kinds, int nb,
                               const int* term_a, const int* term_b, const unsigned* term_need,
                               int n_count, int n_float, Bases* bases, Terms* terms) {
    const int C = n_count + n_float;
    if (nb < 0 || nb > MAX_BASES || C < 1 || C > MAX_TERMS || n_count < 0 || n_float < 0)
        return false;
    for (int j = 0; j < MAX_BASES; ++j) {
        bases->ptr[j] = j < nb ? base_ptrs[j] : nullptr;
        bases->kind[j] = j < nb ? base_kinds[j] : BASE_F64;
        if (j < nb && (base_kinds[j] < BASE_F64 || base_kinds[j] > BASE_I64)) return false;
    }
    for (int k = 0; k < MAX_TERMS; ++k) {
        terms->a[k] = k < C ? term_a[k] : -1;
        terms->b[k] = k < C ? term_b[k] : -1;
        terms->need[k] = k < C ? term_need[k] : 0u;
        if (k >= C) continue;
        if (term_need[k] >> nb) return false;  // names a base that is not there
        if (k >= n_count && (term_a[k] < 0 || term_a[k] >= nb || term_b[k] >= nb)) return false;
    }
    return true;
}

__device__ __forceinline__ double load_base(const void* p, int kind, long long r) {
    if (kind == BASE_F32) return (double)__ldg((const float*)p + r);
    if (kind == BASE_I64) return (double)__ldg((const long long*)p + r);
    return __ldg((const double*)p + r);
}

// The kernels are instantiated for NB = 0 .. MAX_BASES bases, so a row's
// bases take NB register pairs (at least one slot, so the array exists).
#define BASE_SLOTS(NB) ((NB) > 0 ? (NB) : 1)

// v[j] by compare and select (j < 0: the factor 1), so that a term's
// run-time base index never makes the compiler move v to local memory.
template <int NB>
__device__ __forceinline__ double pick(const double (&v)[BASE_SLOTS(NB)], int j) {
    double out = 1.0;
#pragma unroll
    for (int i = 0; i < NB; ++i) out = i == j ? v[i] : out;
    return out;
}

// Float term k on a row with bases v and NaN mask missing: 0 where not valid.
template <int NB>
__device__ __forceinline__ double term_value(const Terms& t, int k,
                                             const double (&v)[BASE_SLOTS(NB)], unsigned missing) {
    if (t.need[k] & missing) return 0.0;
    return pick<NB>(v, t.a[k]) * pick<NB>(v, t.b[k]);
}

// The term sets the passes make, compiled (B5): var(x) (agg.VAR_TERMS: a
// count, then x and x*x) and corr(x, y) (agg.CORR_TERMS: a count, then, in
// the order B5's wrapper gives the float terms, x*y, x, x*x, y and y*y),
// every term valid where no base is NaN; SET_ANY reads the run-time tables
// for any other batch.
#define SET_ANY 0
#define SET_VAR 1
#define SET_CORR 2

// Host side: the compiled set that the tables describe, or SET_ANY.
static inline int term_set(int nb, const int* term_a, const int* term_b,
                           const unsigned* term_need, int n_count, int n_float) {
    static const int var_a[] = {0, 0}, var_b[] = {-1, 0};
    static const int corr_a[] = {0, 0, 0, 1, 1}, corr_b[] = {1, -1, 0, -1, 1};
    const int set = nb == 1 && n_count == 1 && n_float == 2   ? SET_VAR
                    : nb == 2 && n_count == 1 && n_float == 5 ? SET_CORR
                                                              : SET_ANY;
    if (set == SET_ANY) return SET_ANY;
    const int* a = set == SET_VAR ? var_a : corr_a;
    const int* b = set == SET_VAR ? var_b : corr_b;
    const unsigned all = (1u << nb) - 1u;
    if (term_need[0] != all) return SET_ANY;
    for (int k = 0; k < n_float; ++k)
        if (term_a[1 + k] != a[k] || term_b[1 + k] != b[k] || term_need[1 + k] != all)
            return SET_ANY;
    return set;
}

// The float terms of a compiled set (after its one count).
template <int SET>
__host__ __device__ constexpr int set_floats() {
    return SET == SET_VAR ? 2 : 5;
}

// Float term k of a row with bases v and NaN mask missing, 0 where the row
// is not valid for it; for a compiled set k is a constant after unrolling.
template <int NB, int SET>
__device__ __forceinline__ double set_term(const Terms& t, int k,
                                           const double (&v)[BASE_SLOTS(NB)],
                                           unsigned missing) {
    if constexpr (SET == SET_ANY) {
        return term_value<NB>(t, k, v, missing);
    } else {
        if (missing) return 0.0;
        const double x = v[0], y = v[NB > 1 ? 1 : 0];
        if constexpr (SET == SET_VAR) return k == 1 ? x : x * x;
        return k == 1 ? x * y : k == 2 ? x : k == 3 ? x * x : k == 4 ? y : y * y;
    }
}

// The row's count term k: 1 where the row is valid for it.
template <int SET>
__device__ __forceinline__ unsigned set_count(const Terms& t, int k, unsigned missing) {
    if constexpr (SET == SET_ANY) return (t.need[k] & missing) ? 0u : 1u;
    return missing ? 0u : 1u;
}

// The instance of a kernel template for nb bases (nb checked by make_tables).
#define FOR_NB(kernel, nb)                                                               \
    ((nb) == 0 ? kernel<0> : (nb) == 1 ? kernel<1> : (nb) == 2 ? kernel<2>               \
                           : (nb) == 3 ? kernel<3> : kernel<4>)
static_assert(MAX_BASES == 4, "FOR_NB instantiates 0 .. 4 bases");

// The C entry points both moment libraries export next to <name>_run.
#define MOMENT_LIBRARY_INFO(name)                                   \
    int name##_smem_budget(void) { return SMEM_BUDGET; }            \
    int name##_max_cols(void) { return MAX_TERMS; }                 \
    int name##_max_bases(void) { return MAX_BASES; }                \
    const char* name##_error_string(int code) {                     \
        if (code == -1) return "arguments do not fit the " #name " kernel"; \
        return cudaGetErrorString((cudaError_t)code);               \
    }
