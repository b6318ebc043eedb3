"""``rich_pass_s``: seconds of ``run_sample``'s ``rich_pass`` stage, the mean over
the window's samples (host clock; the stage ends in a synchronisation)."""


def read(ctx):
    vals = [s["seconds"]["rich_pass"] for s in ctx["samples"]]
    return sum(vals) / len(vals) if vals else None
