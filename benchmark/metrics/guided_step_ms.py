"""``guided_step_ms``: milliseconds of one colour-guided step (``_guided``:
the VAE decode of x0 and its gradient), the mean over every guided step of
the window's samples, between CUDA events recorded around each call."""


def read(ctx):
    ms = ctx["guided_ms"]
    return sum(ms) / len(ms) if ms else None
