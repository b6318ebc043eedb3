"""``mfu``: the window's model FLOPs (the benchmark's count over the
reference's modules, ``benchmark/flops.py``, times the samples) over its
seconds and the card's dense bfloat16 peak, in %."""


def read(ctx):
    n = len(ctx["samples"])
    if not n or ctx["window_span_s"] <= 0:
        return None
    return (100.0 * ctx["flops_per_sample"] * n / ctx["window_span_s"]
            / ctx["peak_flops"])
