"""The share of the HBM roofline the window's queries reach: the bytes
their work defines (every input a question reads, once, at its stored
width; the traffic mix's ``reads``) at the published peak bandwidth, over
the device's busy time in the trace, in %."""


def read(rec):
    if not rec.get("busy_s"):
        return None
    least_s = sum(q[4] for q in rec["queries"]) / rec["peaks"]["hbm_bytes_per_s"]
    return 100.0 * least_s / rec["busy_s"]
