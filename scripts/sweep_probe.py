#!/usr/bin/env python3
"""Times the set probe kernel (B6, vaex_tpu_torch/csrc/probe.cu) against
``torch.searchsorted`` + gather + compare and ``torch.isin`` across set
sizes, on one GPU: its shared-memory kernel up to that kernel's limit, its
two-level kernel past it.

    python3 scripts/sweep_probe.py [N]              (default N = 1e8)

Builds the kernel, prints what ptxas says of it, checks it against its plain
version at N = 1_000_003 for int64 and float64 keys (exact; it stops there on
a mismatch), then times with CUDA events, at N rows drawn uniformly over
twice the keys' range (half of the rows hit), for M in {1, 8, 64, 500, 2048,
16 384, the shared-memory kernel's limit, that + 1, 50 000, 1e6, 1e7}: the
kernel on int64, int32, float64 and float32
rows, the plain version on int64 rows, and ``torch.isin`` on int64 rows.
Also prints the copy bandwidth of the same run, the kernel's HBM floor at
12 bytes per 8-byte row, and the peak device memory of ``torch.unique`` over
2^26 near-unique int64 rows (one tile of a set build).
"""

import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(fn, reps=5):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(n, M, gen):
    """M sorted unique int64 keys spread over [0, 4M) and n rows over the
    same range."""
    keys = torch.randperm(4 * M, generator=gen, device="cuda")[:M].sort().values
    x = torch.randint(0, 4 * M, (n,), generator=gen, device="cuda", dtype=torch.int64)
    return keys, x


def main():
    if not torch.cuda.is_available():
        print("sweep_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from vaex_tpu_torch.ops import kernel_build, probe

    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 100_000_000
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    for name, (path, seconds, log) in kernel_build.build("probe").items():
        print(f"built {name} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(42)
    sizes = (1, 8, 64, 500, 2048, 16_384, probe.MAX_KEYS, probe.MAX_KEYS + 1, 50_000,
             1_000_000, 10_000_000)
    for M in sizes:
        keys, x = inputs(1_000_003, M, gen)
        for k, r in ((keys, x), (keys.to(torch.float64) * 0.5, x.to(torch.float64) * 0.5)):
            got, want = probe.probe(k, r), probe.probe_reference(k, r)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                print(f"MISMATCH at M={M} {k.dtype}", flush=True)
                return 1
    print("kernel equals plain at every M", flush=True)

    src = torch.empty(n, dtype=torch.int64, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src), 10)
    bandwidth = 2 * n * 8 / (copy_ms * 1e-3)
    del src, dst
    print(f"[{card}] copy bandwidth {bandwidth / 1e12!r} TB/s; HBM floor of the probe at "
          f"12 B/row, N={n}: {n * 12 / bandwidth * 1e3!r} ms", flush=True)
    for M in sizes:
        keys, x = inputs(n, M, gen)
        times = {"i64": cuda_ms(lambda: probe.probe(keys, x)),
                 "plain_i64": cuda_ms(lambda: probe.probe_reference(keys, x), 2),
                 "isin_i64": cuda_ms(lambda: torch.isin(x, keys), 2)}
        x32 = x.to(torch.int32)
        times["i32"] = cuda_ms(lambda: probe.probe(keys, x32))
        del x32
        fkeys, fx = keys.to(torch.float64), x.to(torch.float64)
        times["f64"] = cuda_ms(lambda: probe.probe(fkeys, fx))
        fx = fx.to(torch.float32)
        times["f32"] = cuda_ms(lambda: probe.probe(fkeys, fx))
        del fx
        plan = probe.plan_wide if M > probe.MAX_KEYS else probe.plan
        print(f"[{card}] N={n} M={M} plan={plan(n, M, 132)}: "
              + ", ".join(f"{name} {ms!r} ms" for name, ms in times.items()), flush=True)
        del keys, x
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
