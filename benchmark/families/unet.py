"""The model family ``unet``: SD-1.5 and SDXL, a UNet denoiser with a VAE
and CLIP text towers, driven by ``RegionDiffusion`` / ``RegionDiffusionXL``.

A family module gives the harness (``harness.run_cell``,
``trace_metrics``, ``check``) and ``control.py`` every step of a run that
depends on the model family; this one calls the benchmark's code for these
networks where it stands:

  draw_state(cfg, seed, device, log=None)  the weights, from the run's seed
  build_model(cfg, state, device)  the program's pipeline object, which
                                   ``cli/sample.run_sample`` drives
  recorder(model)                  ``start()``; ``stop()`` -> the record of
                                   one sample of the timed path
  spans(model)                     the benchmark's spans
                                   (``trace.SPAN_NAMES``) on the pipeline;
                                   ``remove()``
  work(cfg, traffic)               (FLOPs of one sample, the least seconds
                                   of its self-attention on the data
                                   sheet's peaks, the self-attention calls
                                   as (count, B, H, S, d, capture))
  checked(rec, traffic, limits, seed)  what the comparison checks, drawn
                                   from the run's seed
  reference(cfg, state, device)    the plain reference on the weights
  control(cfg, state, device)      the reference one precision lower
  evaluate(ref, rec, traffic, seed, which)  a reference's outputs over a
                                   record, at what ``checked`` chose
  subject_of(rec)                  the program's outputs, in the same layout
  compare(sub, outs, rec)          {number: value} held against the limits
  LIMITS                           the names ``compare`` may return
"""

from __future__ import annotations

from benchmark import control as _control
from benchmark import flops as F
from benchmark import harness, trace, weights
from benchmark.recorder import Recorder
from benchmark.reference import check as C

# guided_rel only where the traffic has colour
LIMITS = ("text_rel", "plain_step_rel", "maps_rel", "rich_step_rel",
          "guided_rel", "decode_rel", "inputs_max_abs")

draw_state = weights.draw_state
build_model = harness.build_model
recorder = Recorder
spans = trace.Spans
checked = harness.checked
reference = C.Reference
control = _control.control
subject_of = C.subject_of
compare = C.compare


def work(cfg, traffic):
    inp = C.sample_inputs(traffic)
    return (F.sample_flops(cfg, traffic, inp),
            F.attn_bound_seconds(cfg, traffic, inp),
            F.attn_calls(cfg, traffic, inp))


def evaluate(ref, rec, traffic, seed, which):
    steps, guided = which
    return C.evaluate(ref, rec, traffic, seed, guided, steps)
