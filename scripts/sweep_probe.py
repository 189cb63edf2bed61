#!/usr/bin/env python3
"""Times the set probe kernel (B6, vaex_tpu_torch/csrc/probe.cu) against
``torch.searchsorted`` + gather + compare and ``torch.isin`` across set
sizes, on one GPU: the whole search tree in shared memory (``b6``) up to
its limit, its top levels there past it (``b6-wide``).

    python3 scripts/sweep_probe.py [N] [--baseline DIR]    (default N = 1e8)

Builds the kernel, prints what ptxas says of it (registers, spills, shared
memory) and the loads of its SASS (``cuobjdump -sass``), checks it against
its plain version at N = 1_000_003 for int64 and float64 keys with 4-byte
keys forced on and off (exact; it stops there on a mismatch), then times
with CUDA events, at N rows drawn uniformly over twice the keys' range (half
of the rows hit), for M in {1, 8, 64, 100, 500, 2048, 16 384, MAX_KEYS,
that + 1, 50 000, 2 * MAX_KEYS + 1, 1e6, 1e7}: the kernel as planned on
int64, int32, float64 and float32 rows, the tree build (host clock,
synchronized), 4-byte keys on and off on int64 rows, the plain version and
``torch.isin`` on int64 rows and, with ``--baseline
DIR``, the probe of another checkout unpacked under DIR (its own build
directory), in turns.  A set of 1e6 int64 keys spread over a range past
2^32 (the set grouper's keys) is timed the same way.  Also prints the copy
bandwidth of the same run, the kernel's HBM floor at 12 bytes per 8-byte
row, and the peak device memory of ``torch.unique`` over 2^26 near-unique
int64 rows (one tile of a set build).
"""

import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from scripts.sweep_grid_kernels import load_baseline, print_sass  # noqa: E402

def cuda_ms(fn, reps=5):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(n, M, gen, spread=1):
    """M sorted unique int64 keys spread over [0, 4M) (times ``spread``) and
    n rows over the same range."""
    keys = torch.randperm(4 * M, generator=gen, device="cuda")[:M].sort().values * spread
    x = torch.randint(0, 4 * M, (n,), generator=gen, device="cuda", dtype=torch.int64) * spread
    return keys, x


def main():
    if not torch.cuda.is_available():
        print("sweep_probe: no CUDA device", file=sys.stderr)
        return 1
    from vaex_tpu_torch.ops import kernel_build, probe

    args = sys.argv[1:]
    old = None
    if "--baseline" in args:
        at = args.index("--baseline")
        old = load_baseline(os.path.abspath(args[at + 1])).probe
        del args[at:at + 2]
    n = int(float(args[0])) if args else 100_000_000
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    for name, (path, seconds, log) in kernel_build.build("probe").items():
        print(f"built {name} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")
        print_sass("b6", path, ("LDS", "LDG"))
    if old is not None:
        print_sass("b6 baseline", old.kernel_build.build("probe")["probe"][0], ("LDS", "LDG"))
    gen = torch.Generator(device="cuda").manual_seed(42)
    sizes = (1, 8, 64, 100, 500, 2048, 16_384, probe.MAX_KEYS, probe.MAX_KEYS + 1, 50_000,
             2 * probe.MAX_KEYS + 1, 1_000_000, 10_000_000)
    for M in sizes[:-1]:
        keys, x = inputs(1_000_003, M, gen)
        for k, r in ((keys, x), (keys.to(torch.float64) * 0.5, x.to(torch.float64) * 0.5)):
            want = probe.probe_reference(k, r)
            for narrow in (False, True):
                tree = probe.build_tree(k, narrow=narrow)
                got = probe.probe(k, r, tree)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    print(f"MISMATCH at M={M} {k.dtype} narrow {narrow} ({tree.route})",
                          flush=True)
                    return 1
    print("kernel equals plain at every M and key width", flush=True)

    src = torch.empty(n, dtype=torch.int64, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src), 10)
    bandwidth = 2 * n * 8 / (copy_ms * 1e-3)
    del src, dst
    print(f"[{card}] copy bandwidth {bandwidth / 1e12!r} TB/s; HBM floor of the probe at "
          f"12 B/row, N={n}: {n * 12 / bandwidth * 1e3!r} ms", flush=True)
    shapes = [(M, 1) for M in sizes] + [(1_000_000, 1_000_003)]
    for M, spread in shapes:
        keys, x = inputs(n, M, gen, spread)
        tree = probe.build_tree(keys)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe.build_tree(keys)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        times = {"i64": cuda_ms(lambda: probe.probe(keys, x, tree))}
        if old is not None:
            times["baseline i64"] = cuda_ms(lambda: old.probe(keys, x))
        for narrow in (False, True):
            t = probe.build_tree(keys, narrow=narrow)
            ms = cuda_ms(lambda: probe.probe(keys, x, t))
            times[f"{'narrow' if t.kind == probe.KIND_NARROW else 'wide'} {t.route}"] = ms
        times["i64 again"] = cuda_ms(lambda: probe.probe(keys, x, tree))
        if old is not None:
            times["baseline i64 again"] = cuda_ms(lambda: old.probe(keys, x))
        times["plain_i64"] = cuda_ms(lambda: probe.probe_reference(keys, x), 2)
        times["isin_i64"] = cuda_ms(lambda: torch.isin(x, keys), 2)
        x32 = x.to(torch.int32) if spread == 1 else None
        if x32 is not None:
            times["i32"] = cuda_ms(lambda: probe.probe(keys, x32, tree))
        del x32
        fkeys, fx = keys.to(torch.float64), x.to(torch.float64)
        ftree = probe.build_tree(fkeys)
        times["f64"] = cuda_ms(lambda: probe.probe(fkeys, fx, ftree))
        fx = fx.to(torch.float32)
        times["f32"] = cuda_ms(lambda: probe.probe(fkeys, fx, ftree))
        del fx, fkeys, ftree
        print(f"[{card}] N={n} M={M} key spread {spread} route {tree.route} kind {tree.kind} "
              f"levels {tree.counts} (shared {tree.shared_levels}) plan "
              f"{probe.plan(n, tree.smem, 132, tree.unroll)} build {build_ms:.3f} ms: "
              + ", ".join(f"{name} {ms!r} ms" for name, ms in times.items()), flush=True)
        del keys, x, tree
    tile = torch.randint(0, 2 ** 40, (1 << 26,), generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_ms(lambda: torch.unique(tile, sorted=True), 1)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[{card}] torch.unique of 2^26 near-unique int64 rows (a 512 MiB tile): {ms!r} ms, "
          f"peak {peak / 2 ** 20!r} MiB above the tile", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
