"""``idle_share``: the share of the profiled sample's wall time in which no
operation ran on the device, 1 - (union of device intervals / traced
window), in %."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
