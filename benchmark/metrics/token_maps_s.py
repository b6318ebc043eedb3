"""``token_maps_s``: seconds of ``run_sample``'s ``token_maps`` stage, the mean over
the window's samples (host clock; the stage ends in a synchronisation)."""


def read(ctx):
    vals = [s["seconds"]["token_maps"] for s in ctx["samples"]]
    return sum(vals) / len(vals) if vals else None
