"""A model family for the tests: each step is the ``unet`` family's, and
each call is counted in ``CALLS`` under the step's name, so that a run
through this family shows which steps went through it."""

from __future__ import annotations

from collections import Counter

from benchmark import harness

UNET = harness.load_module(harness.HERE / "families" / "unet.py")
LIMITS = UNET.LIMITS
CALLS: Counter = Counter()


def _counted(name):
    def step(*a, **k):
        CALLS[name] += 1
        return getattr(UNET, name)(*a, **k)
    return step


draw_state = _counted("draw_state")
build_model = _counted("build_model")
recorder = _counted("recorder")
spans = _counted("spans")
work = _counted("work")
checked = _counted("checked")
reference = _counted("reference")
control = _counted("control")
evaluate = _counted("evaluate")
subject_of = _counted("subject_of")
compare = _counted("compare")
