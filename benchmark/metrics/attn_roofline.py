"""``attn_roofline``: the least time of one sample's self-attention and
capture work on the data sheet's peaks (``flops.attn_bound_seconds``, from
the reference's shapes) over the device time of the kernels launched inside
the ``attn1_core`` spans of the profiled sample, whatever kernels they are,
in %. Nothing to read where no such kernel was traced."""


def read(ctx):
    if ctx["attn_core_s"] <= 0:
        return None
    return 100.0 * ctx["attn_bound_s"] / ctx["attn_core_s"]
