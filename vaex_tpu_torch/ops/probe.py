"""The set probe: for each row the ordinal of the equal key among M sorted,
unique, NaN-free keys, else -1.  The hand-written CUDA kernel, its plain
version, the search tree it walks, its wrapper and its launch counter.

The port of ``vaex_tpu/ops/pallas_probe.py:_probe_kernel`` (through
``probe_ordinals``): ``keys`` [M] and ``x`` [N] of any int or float dtype up
to 64 bits give ``out`` [N] int32.  Values compare as numbers: ``-0.0``
finds the key ``0.0`` and a NaN row gives -1.  The kernel source is
``vaex_tpu_torch/csrc/probe.cu``; it is compiled with ``nvcc`` at first use
(:mod:`vaex_tpu_torch.ops.kernel_build`).

The kernel walks a static B+-tree that :func:`build_tree` makes once per set
with torch indexing (:class:`.setops.DeviceSetHandle` keeps it for a pass):
the leaves are the sorted keys in lines of L keys (``LINE_BYTES`` each), an
inner node of L keys has L + 1 children and holds the first key of each
child but the first, level by level from the root.  A row reads one line
per level and counts the keys <= its value, then tests equality in its
leaf.  While the tree of a set of up to ``MAX_KEYS`` 8-byte keys fits one
CTA's shared memory it is searched there (route ``b6``); a wider one keeps
its top levels there and the rest in global memory, one line per level and
row (``b6-wide``).  An integer set of ``NARROW_MIN_KEYS`` keys or more
whose range is below 2^32 is stored as 4-byte offsets from its first key,
twice the keys per line (:func:`narrow_pays`).  So a
CUDA tensor always goes through hand-written code, and the plain version
serves CPU tensors only.

Integer rows against integer keys compare in int64, everything else in
float64 (an int64 beyond 2^53 against a float key rounds, as in numpy).
torch's uint64 keys and rows compare as their order image
``bits ^ (1 << 63)`` in int64 (:func:`as_compared`), both sides or neither.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import kernel_build
from .. import tracing

# mirrors SMEM_BUDGET / MAX_LEVELS in csrc/probe.cu (checked at load)
SMEM_BUDGET = 227 * 1024
MAX_LEVELS = 14
# bytes of a node: a line of 4 8-byte or 8 4-byte keys; on an NVIDIA H100 32
# bytes won over 64 and 128 at every set size a path uses (PERF.md, section
# 6).  Mirrors LINE in csrc/probe.cu
LINE_BYTES = 32
B6, B6_WIDE = "b6", "b6-wide"
# searches in flight per thread, by route: 8 won where the tree is in shared
# memory, 4 where rows wait on global memory (PERF.md, section 6).  Mirrors
# the kernel's U
ROUTE_UNROLL = {B6: 8, B6_WIDE: 4}
# 4-byte offsets won from 16 384 keys on (and lost at 2048 and below)
NARROW_MIN_KEYS = 16_384
# the top levels of a wide tree kept in shared memory: one CTA per SM
WIDE_SMEM = SMEM_BUDGET
# an H100 SM holds 228 KiB of shared memory (1 KiB per CTA is the system's)
# and 64K registers: 1024 threads of the kernel's up to 64 registers
SM_SMEM = 228 << 10
SM_THREADS = 1024
UINT64 = getattr(torch, "uint64", None)
KIND_INT, KIND_FLOAT, KIND_NARROW = 0, 1, 2


def level_counts(M, L):
    """Nodes of each inner level, root first, then the leaves."""
    counts = [-(-M // L)]
    while counts[0] > 1:
        counts.insert(0, -(-counts[0] // (L + 1)))
    return counts


def tree_bytes(M, key_bytes):
    """Bytes of the whole tree of M keys: every node and leaf is a line."""
    return sum(level_counts(M, LINE_BYTES // key_bytes)) * LINE_BYTES


def max_keys(key_bytes):
    """The most keys whose whole tree fits SMEM_BUDGET."""
    lo, hi = 1, SMEM_BUDGET // key_bytes
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if tree_bytes(mid, key_bytes) <= SMEM_BUDGET else (lo, mid - 1)
    return lo


# the widest sets searched wholly in shared memory: of 8-byte keys, and of
# 4-byte keys (about twice as many)
MAX_KEYS = max_keys(8)
NARROW_MAX_KEYS = max_keys(4)


def probe_route(n_keys, key_bytes=8):
    """Which route a set of ``n_keys`` keys of ``key_bytes`` takes on the
    card: ``b6`` (the whole tree in shared memory) or ``b6-wide``."""
    limit = MAX_KEYS if key_bytes == 8 else NARROW_MAX_KEYS
    return B6 if n_keys <= limit else B6_WIDE


def narrow_pays(M):
    """4-byte offsets pay from ``NARROW_MIN_KEYS`` keys on: there they halve
    the bytes of every line read and take a set of up to about 2 * MAX_KEYS
    keys to ``b6``; below it they lost (the range test and the wider lines
    cost more than they saved) on an NVIDIA H100 (PERF.md, section 6)."""
    return M >= NARROW_MIN_KEYS


def compare_dtype(keys, x):
    """The dtype both sides widen to: int64 when both are integral (bool
    included; uint64 on both sides as its order image), else float64."""
    if (keys.dtype == UINT64) != (x.dtype == UINT64):
        raise TypeError(f"a probe of uint64 values takes uint64 on both sides, got "
                        f"{keys.dtype} keys and {x.dtype} rows")
    if keys.is_floating_point() or x.is_floating_point():
        return torch.float64
    return torch.int64


def as_compared(t, dtype):
    """``t`` in the compare dtype: torch's uint64 as its order image (the
    keys stay sorted, ``bits ^ (1 << 63)``), anything else widened."""
    if t.dtype == UINT64:
        return t.view(torch.int64) ^ -(1 << 63)
    return t.to(dtype)


def probe_reference(keys, x):
    """The plain PyTorch version: ``searchsorted``, gather, compare."""
    dtype = compare_dtype(keys, x)
    keys, x = as_compared(keys, dtype), as_compared(x, dtype)
    M = keys.shape[0]
    if M == 0:
        return torch.full(x.shape, -1, dtype=torch.int32, device=x.device)
    # NaN rows sort past the last key: the clamp brings them back in range
    # and the compare rejects them
    idx = torch.searchsorted(keys, x).clamp_(max=M - 1)
    return torch.where(keys[idx] == x, idx, -1).to(torch.int32)


class Tree(NamedTuple):
    """The search layout of one set for one compare dtype (see the module
    docstring).  ``inner`` and ``leaves`` hold whole lines in the stored
    dtype (int32 bits for 4-byte offsets); ``counts`` the nodes of each
    inner level, root first, then the leaves; ``shared_levels`` the top
    levels the kernel stages into shared memory (all of them on ``b6``)."""
    kind: int
    M: int
    counts: tuple
    shared_levels: int
    inner: torch.Tensor
    leaves: torch.Tensor
    base: int
    range: int
    route: str

    @property
    def key_bytes(self):
        return 4 if self.kind == KIND_NARROW else 8

    @property
    def L(self):
        return LINE_BYTES // self.key_bytes

    @property
    def unroll(self):
        return ROUTE_UNROLL[self.route]

    @property
    def levels(self):
        return len(self.counts) - 1

    @property
    def offsets(self):
        """The first node of each inner level, then the inner node count."""
        out = [0]
        for c in self.counts[:-1]:
            out.append(out[-1] + c)
        return out

    @property
    def smem(self):
        """Shared memory of a launch: the staged levels and, on ``b6``, the
        leaves."""
        nodes = self.offsets[self.shared_levels]
        if self.route == B6:
            nodes += self.counts[-1]
        return nodes * LINE_BYTES


def key_bytes(keys, dtype, narrow=None):
    """Bytes of a key in the tree of sorted ``keys`` compared in ``dtype``:
    4 for an int set whose range is below 2^32, where :func:`narrow_pays`
    (``narrow`` None) or always (True); else 8."""
    if dtype == torch.float64:
        return 8
    if narrow is None:
        narrow = narrow_pays(keys.shape[0])
    return 4 if narrow and int(keys[-1]) - int(keys[0]) < 2 ** 32 else 8


def _domain(keys, dtype, narrow):
    """(kind, keys as compared, pad, base, range): the keys in the values the
    tree holds (int64 offsets from the first key for a narrow set), and the
    pad that fills a line, the largest such value."""
    if dtype == torch.float64:
        return KIND_FLOAT, keys, float("inf"), 0, 0
    if key_bytes(keys, dtype, narrow) == 8:
        return KIND_INT, keys, torch.iinfo(torch.int64).max, 0, 0
    lo = int(keys[0])
    return KIND_NARROW, keys - lo, 2 ** 32 - 1, lo, int(keys[-1]) - lo


def build_tree(keys, dtype=None, narrow=None):
    """The search layout of sorted unique NaN-free ``keys`` compared in
    ``dtype`` (int64 or float64; the keys' own kind by default), built with
    torch indexing on the keys' device: the padded leaves, then each inner
    level's separators (the first key of each child but the first) gathered
    from the leaves' first keys.  ``narrow``: 4-byte offsets for an int set
    whose range allows them, where :func:`narrow_pays` (None), always (True)
    or never (False)."""
    if dtype is None:
        dtype = torch.float64 if keys.is_floating_point() else torch.int64
    keys = as_compared(keys, dtype).contiguous()
    M = keys.shape[0]
    if M < 1:
        raise ValueError("a search tree needs at least one key")
    kind, values, pad, base, span_range = _domain(keys, dtype, narrow)
    key_bytes = 4 if kind == KIND_NARROW else 8
    L = LINE_BYTES // key_bytes
    counts = level_counts(M, L)
    NL = counts[-1]
    leaves = torch.full((NL * L,), pad, dtype=values.dtype, device=keys.device)
    leaves[:M] = values
    first = leaves[::L]
    levels = []
    n_below, span = NL, 1
    steps = torch.arange(1, L + 1, device=keys.device)
    while n_below > 1:
        n_nodes = -(-n_below // (L + 1))
        child = torch.arange(n_nodes, device=keys.device)[:, None] * (L + 1) + steps
        sep = first[(child * span).clamp_(max=NL - 1)]
        levels.insert(0, torch.where(child < n_below, sep, pad).reshape(-1))
        n_below, span = n_nodes, span * (L + 1)
    inner = torch.cat(levels) if levels else leaves.new_empty(0)
    if len(counts) - 1 > MAX_LEVELS:
        raise ValueError(f"probe: a set of {M} keys needs {len(counts) - 1} levels, the kernel "
                         f"takes {MAX_LEVELS}")
    route = probe_route(M, key_bytes)
    if route == B6:
        shared = len(counts) - 1
    else:
        shared, nodes = 0, 0
        while shared < len(counts) - 1 and (nodes + counts[shared]) * LINE_BYTES <= WIDE_SMEM:
            nodes += counts[shared]
            shared += 1
    if kind == KIND_NARROW:  # the offsets as uint32 bits
        inner, leaves = inner.to(torch.int32), leaves.to(torch.int32)
    return Tree(kind, M, tuple(counts), shared, inner, leaves, base, span_range, route)


def _stored(t, tree):
    """A stored array as the values the tree compares (int64 for 4-byte
    offsets, which are stored as int32 bits)."""
    return t.to(torch.int64) & 0xFFFFFFFF if tree.kind == KIND_NARROW else t


def tree_search_reference(tree, x):
    """The plain PyTorch walk of ``tree`` for rows ``x`` (of the tree's
    compare kind): level by level the count of separators <= v, the child
    clamped to the level below, then equality in the leaf at a position
    below M.  Returns int32 ordinals, -1 where unmatched."""
    L = tree.L
    v = x.to(torch.float64 if tree.kind == KIND_FLOAT else torch.int64)
    ok = None
    if tree.kind == KIND_NARROW:
        ok = (v >= tree.base) & (v - tree.base <= tree.range)
        v = torch.where(ok, v - tree.base, 0)
    inner = _stored(tree.inner, tree).reshape(-1, L)
    leaves = _stored(tree.leaves, tree).reshape(-1, L)
    c = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    offsets = tree.offsets
    for h in range(tree.levels):
        node = inner[offsets[h] + c]
        r = (node <= v[:, None]).sum(1)
        c = torch.clamp(c * (L + 1) + r, max=tree.counts[h + 1] - 1)
    pos = c[:, None] * L + torch.arange(L, device=v.device)
    hit = (leaves[c] == v[:, None]) & (pos < tree.M)
    out = torch.where(hit, pos, -1).amax(1)
    if ok is not None:
        out = torch.where(ok, out, -1)
    return out.to(torch.int32)


def plan(n, smem, sm_count, unroll):
    """(n_ctas, threads) of one launch: as many CTAs as an SM's shared memory
    and registers hold, each walking at least one step of its ``unroll``
    rows per thread; one CTA of 1024 threads once the staged tree takes more
    than half an SM."""
    fit = max(1, SM_SMEM // (smem + 1024))
    threads = 1024 if fit < 2 else 512
    ctas_per_sm = min(fit, SM_THREADS // threads)
    n_ctas = max(1, min(sm_count * ctas_per_sm, -(-n // (threads * unroll))))
    return n_ctas, threads


def _library():
    lib = kernel_build.library("probe", SMEM_BUDGET)
    for name, value in (("max_levels", MAX_LEVELS), ("line_bytes", LINE_BYTES)):
        fn = getattr(lib, f"probe_{name}")
        fn.restype = ctypes.c_int
        if fn() != value:
            raise RuntimeError(f"probe_{name} disagrees with its wrapper")
    lib.probe_run.restype = ctypes.c_int
    lib.probe_run.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    return lib


def check_inputs(keys, x):
    if keys.dim() != 1 or x.dim() != 1:
        raise ValueError(f"keys and x must be 1-d, got {tuple(keys.shape)} and {tuple(x.shape)}")
    if keys.device != x.device:
        raise ValueError(f"keys on {keys.device}, x on {x.device}")
    for t in (keys, x):
        if t.is_complex():
            raise TypeError(f"a set probe takes int and float values, got {t.dtype}")


def probe(keys, x, tree=None):
    """int32 ordinals of ``x`` among ``keys``; see the module docstring.  CPU
    tensors take the plain version; CUDA tensors launch the kernel on
    ``tree`` (built here when not given: :func:`build_tree`), or raise.
    ``probe.launches`` counts the launches, ``probe.wide_launches`` those of
    the ``b6-wide`` route.  A ``launch:<route>`` span (:mod:`..tracing`)
    holds the call, ``launch:plain`` on the CPU."""
    return _probe(keys, x, tree)[1]


@tracing.launched
def _probe(keys, x, tree):
    """(route, ordinals): :func:`probe`'s."""
    check_inputs(keys, x)
    if x.device.type == "cpu":
        return "plain", probe_reference(keys, x)
    if x.device.type != "cuda":
        raise ValueError(f"probe runs on CPU or CUDA tensors, not {x.device}")
    M, n = keys.shape[0], x.shape[0]
    if not 1 <= M < 2 ** 31:
        raise ValueError(f"probe: a set of {M} keys does not fit the kernel "
                         f"(1 to {2 ** 31 - 1} keys)")
    dtype = compare_dtype(keys, x)
    if tree is None:
        tree = build_tree(keys, dtype)
    if tree.M != M or (tree.kind == KIND_FLOAT) != (dtype == torch.float64):
        raise ValueError("probe: the tree was built for other keys or another compare dtype")
    for t in (tree.inner, tree.leaves):
        if t.numel() and (t.device != x.device or t.data_ptr() % 128):
            raise ValueError("probe: the tree's lines must lie on the rows' device, 128-byte "
                             "aligned")
    # 4-byte rows of the keys' kind widen in the kernel's load, the rest here
    narrow = torch.float32 if dtype == torch.float64 else torch.int32
    if x.dtype != narrow:
        x = as_compared(x, dtype)
    x = x.contiguous()
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_ctas, threads = plan(n, tree.smem, sm_count, tree.unroll)
    meta = (ctypes.c_int * (2 * tree.levels + 4))(
        tree.levels, tree.shared_levels, *tree.offsets, *tree.counts)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.probe_run(tree.kind, int(tree.route == B6),
                            tree.inner.data_ptr(), tree.leaves.data_ptr(),
                            ctypes.addressof(meta), M, tree.base, tree.range,
                            x.data_ptr(), x.element_size(), n, out.data_ptr(), n_ctas, threads,
                            stream)
    kernel_build.raise_on_error(lib, "probe", err)
    probe.launches += 1
    probe.wide_launches += int(tree.route == B6_WIDE)
    return tree.route, out


probe.launches = 0
probe.wide_launches = 0
