"""The share of the traced window in which no operation ran on the device:
1 - the union of the device's activity intervals over the window, in %."""


def read(rec):
    if not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["trace_window_s"])
