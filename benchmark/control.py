"""The readings the limits of ``correct`` are set from, for one cell.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... \
        [--control 3]

For each seed: the weights drawn from it, the program built, one sample of
the cell recorded on its timed path (``run_sample`` at the cell's sizes),
the program freed, and then the plain reference run over the record. The
program's numbers are the lower readings. On the first ``--control``
seeds the control is read as well: the reference put in the program's
place one precision lower than the configuration states, on the same
states: the UNet's matrix products in fp8 (e4m3, one scale a tensor, for
the configuration's bfloat16) and TF32 for the float32 text towers, VAE
and colour gradient (``control`` below, for the ``unet`` family). Its
numbers are the upper readings. One JSON line a seed on standard output.
Every step that depends on the model family goes through the
configuration's family module (``harness.family``).

Not run by the benchmark's runs; ``benchmark/tests`` holds it at a size a
test can hold.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402
from benchmark.reference.check import Reference  # noqa: E402

FP8_MAX = 448.0  # the largest e4m3 number


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale for the tensor."""
    s = t.detach().abs().amax().float().clamp_min(1e-12) / FP8_MAX
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


def to_fp8(unet: nn.Module) -> nn.Module:
    """Weights and inputs of every Linear and Conv2d through fp8."""
    for m in unet.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.data = fp8(m.weight.data)
            m.register_forward_pre_hook(
                lambda mod, args: (fp8(args[0]),) + tuple(args[1:]))
    return unet


def control(cfg, state, device) -> Reference:
    ref = Reference(cfg, state, device, unet_dtype=torch.bfloat16, tf32=True)
    to_fp8(ref.unet)
    return ref


def record_one(cfg, traffic, seed: int, device):
    """(record of one sample of the timed path, its sample seed)."""
    from rich_text_to_image_tpu_torch.cli.sample import run_sample

    fam = harness.family(cfg)
    state = fam.draw_state(cfg, seed, device)
    model = fam.build_model(cfg, state, device)
    del state
    args = harness.cli_args(cfg, traffic)
    rec = fam.recorder(model)
    s = harness.sample_seed(seed, 0)
    rec.start()
    run_sample(model, args, harness.sample_param(
        cfg, traffic, s, cfg["pipeline"]["steps"]), save=False)
    harness.sync(device)
    out = rec.stop()
    del model, rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out, s


def readings(cell: dict, seed: int, device, with_control: bool) -> dict:
    cfg, traffic, limits = cell["cfg"], cell["traffic"], cell["limits"]
    fam = harness.family(cfg)
    t0 = time.perf_counter()
    rec, s = record_one(cfg, traffic, seed, device)
    which = fam.checked(rec, traffic, limits, seed)
    state = fam.draw_state(cfg, seed, device)
    ref = fam.reference(cfg, state, device)
    outs = fam.evaluate(ref, rec, traffic, s, which)
    line = {"seed": seed, "program": fam.compare(fam.subject_of(rec), outs,
                                                 rec)}
    del ref
    if with_control:
        ctl = fam.control(cfg, state, device)
        line["control"] = fam.compare(fam.evaluate(ctl, rec, traffic, s,
                                                   which), outs, rec)
        del ctl
    del state, outs, rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t0
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3,
                   help="read the control on the first N seeds")
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload)
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print("hardware: " + json.dumps(harness.hardware()), file=sys.stderr)
    for j, seed in enumerate(a.seeds):
        line = readings(cell, seed, dev, j < a.control)
        print(json.dumps(dict(line, workload=a.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
