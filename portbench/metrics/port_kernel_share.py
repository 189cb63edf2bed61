"""The share of the device's busy time spent in the port's own kernels
(every ``__global__`` function of ``vaex_tpu_torch/csrc``, read at the run's start),
in %; the rest is eager torch: binners, casts, sorts, gathers."""

from portbench import trace


def read(rec):
    if not rec.get("busy_s"):
        return None
    ours = [(s, e) for s, e, name in rec["device_ops"]
            if any(k in name for k in rec["kernels"])]
    return 100.0 * trace.length(ours) * 1e-6 / rec["busy_s"]
