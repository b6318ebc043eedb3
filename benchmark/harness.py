"""One run of one cell: set-up, the measured window, the traced sample and
the comparison with the reference.

The cell, its configuration, its traffic and its limits are found by name:
``BENCHMARK.json`` names the configuration's file and the traffic mix;
``traffic/<traffic>.json`` holds the rich text and the CLI flags;
``workloads/<cell>.json`` the limits of ``correct``; ``metrics/<name>.py``
the reader of each per-layer metric; ``families/<family>.py`` the steps of
a run that depend on the configuration's model family (its ``"family"``,
``unet`` where the file names none): the weights, the pipeline, the
recording of a sample, the spans, the work of a sample and the comparison.

The window is a closed loop with one client: samples run back to back
through the CLI's own flow (``cli/sample.run_sample``), sample i with the
latent seed drawn from the run's seed and i. The first starts the window;
none starts after ``--seconds``; every one started is finished and counted.
``images_per_min`` is 60 x the samples over the seconds from the start of
the first to the end of the last.
"""

from __future__ import annotations

import functools
import gc
import importlib.util
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import flops as F
from .weights import derive

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FAMILIES = HERE / "families"
FORBIDDEN = ("jax", "jaxlib", "flax", "rich_text_to_image_tpu")
WARMUP_STEPS_PAST_CAPTURE = 2
GIB = 1 << 30


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ------------------------------------------------------------------ the cell
def load_cell(name: str) -> dict:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    family(cfg)  # a family with no file fails here, before any work
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "workloads" / f"{name}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if mine(m) and m["moves"] in e2e_names]
    return dict(name=name, cell=cell, cfg=cfg, traffic=traffic,
                limits=limits, e2e=e2e, per_layer=per_layer)


@functools.cache
def load_module(path: Path):
    """The Python file ``path``, loaded once a process (and put in
    ``sys.modules``, which a dataclass of the file looks itself up in)."""
    spec = importlib.util.spec_from_file_location(
        f"_bench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def family(cfg: dict):
    """The module of the configuration's model family,
    ``families/<family>.py``: ``unet`` where ``cfg`` names none."""
    path = FAMILIES / f"{cfg.get('family', 'unet')}.py"
    if not path.is_file():
        raise SystemExit(f"configuration {cfg.get('name')!r} names a model "
                         f"family with no file: {path}")
    return load_module(path)


def port_configs(cfg: dict):
    """The program's config objects for a diffusers-style config."""
    from rich_text_to_image_tpu_torch.models import config as C

    u = cfg["unet"]
    L = len(u["block_out_channels"])

    def per(v):
        return tuple(v) if isinstance(v, (list, tuple)) else (v,) * L

    unet = C.UNetConfig(
        sample_size=u["sample_size"], in_channels=u["in_channels"],
        out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]),
        down_block_types=tuple(u["down_block_types"]),
        up_block_types=tuple(u["up_block_types"]),
        layers_per_block=u["layers_per_block"],
        transformer_layers_per_block=per(
            u.get("transformer_layers_per_block", 1)),
        attention_head_dim=per(u.get("num_attention_heads")
                               or u["attention_head_dim"]),
        cross_attention_dim=u["cross_attention_dim"],
        use_linear_projection=u["use_linear_projection"],
        norm_num_groups=u["norm_num_groups"], freq_shift=u["freq_shift"],
        flip_sin_to_cos=u["flip_sin_to_cos"],
        addition_embed_type=u.get("addition_embed_type"),
        addition_time_embed_dim=u.get("addition_time_embed_dim", 256),
        projection_class_embeddings_input_dim=u.get(
            "projection_class_embeddings_input_dim", 2816))
    v = cfg["vae"]
    vae = C.VAEConfig(
        in_channels=v["in_channels"], out_channels=v["out_channels"],
        latent_channels=v["latent_channels"],
        block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"],
        norm_num_groups=v["norm_num_groups"],
        scaling_factor=v["scaling_factor"])
    texts = {}
    for key in ("text_encoder", "text_encoder_2"):
        if key in cfg:
            t = cfg[key]
            proj = "CLIPTextModelWithProjection" in t.get("architectures", ())
            texts[key] = C.CLIPTextConfig(
                vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                intermediate_size=t["intermediate_size"],
                num_hidden_layers=t["num_hidden_layers"],
                num_attention_heads=t["num_attention_heads"],
                max_position_embeddings=t["max_position_embeddings"],
                hidden_act=t["hidden_act"],
                layer_norm_eps=t["layer_norm_eps"],
                projection_dim=t["projection_dim"] if proj else None)
    return unet, vae, texts


def build_model(cfg: dict, state: dict, device):
    """The program's pipeline on modules built by its constructors on the
    device and given the drawn tensors by ``load_state_dict``. (Built on
    the meta device instead, the text towers' embedding init would import
    torch's compiler stack: seconds of set-up for nothing.)"""
    from rich_text_to_image_tpu_torch.cli.sample import make_scheduler
    from rich_text_to_image_tpu_torch.models.clip import CLIPTextModel
    from rich_text_to_image_tpu_torch.models.tokenizer import CLIPTokenizer
    from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
    from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL

    ucfg, vcfg, tcfgs = port_configs(cfg)

    def on(make, sd):
        with torch.device(device):
            mod = make()
        mod.load_state_dict(sd, strict=True, assign=True)
        return mod

    unet = on(lambda: UNet2DCondition(ucfg), state["unet"])
    vae = on(lambda: AutoencoderKL(vcfg), state["vae"])
    texts = [on(lambda c=c: CLIPTextModel(c), state[k])
             for k, c in tcfgs.items()]
    tok = CLIPTokenizer.byte_level()
    p = cfg["pipeline"]
    kw = dict(agg_start_step=p["agg_start_step"],
              scheduler=make_scheduler(p["sampler"]), device=device)
    if p["model"] == "SDXL":
        from rich_text_to_image_tpu_torch.pipelines.region_sdxl import (
            RegionDiffusionXL)
        return RegionDiffusionXL(unet, vae, *texts, tok, tok, ucfg, vcfg, **kw)
    from rich_text_to_image_tpu_torch.pipelines.region_sd import (
        RegionDiffusion)
    return RegionDiffusion(unet, vae, texts[0], tok, ucfg, vcfg, **kw)


def cli_args(cfg: dict, traffic: dict):
    """The CLI's own arguments for the cell (``cli/sample.make_parser``)."""
    from rich_text_to_image_tpu_torch.cli.sample import check_args, make_parser

    p = cfg["pipeline"]
    argv = ["--model", p["model"], "--sample_steps", str(p["steps"]),
            "--guidance_weight", repr(float(p["guidance_scale"])),
            "--height", str(p["height"]), "--width", str(p["width"]),
            "--scheduler", p["sampler"],
            "--rich_text_json", json.dumps(traffic["rich_text"]),
            "--negative_prompt", traffic.get("negative_prompt", "")]
    for k, v in traffic["flags"].items():
        argv += [f"--{k}", str(v)]
    args = make_parser().parse_args(argv)
    check_args(args)
    return args


def sample_param(cfg, traffic, seed: int, steps: int) -> dict:
    p = cfg["pipeline"]
    return {"text_input": traffic["rich_text"], "height": p["height"],
            "width": p["width"], "guidance_weight": float(p["guidance_scale"]),
            "steps": steps, "noise_index": seed,
            "negative_prompt": traffic.get("negative_prompt", "")}


def sample_seed(seed: int, i: int) -> int:
    return derive(seed, f"sample:{i}")


# ------------------------------------------------------------------ hardware
def hardware() -> dict:
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu,power.draw"
    out = {}
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        vals = [v.strip() for v in r.stdout.splitlines()[0].split(",")]
        out = dict(zip(q.split(","), vals))
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        out["nvidia-smi"] = f"unavailable: {e}"
    cpu = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            keys = ("model name", "Model", "CPU part", "Hardware")
            found = [ln.split(":", 1)[1].strip() for ln in f
                     if ln.split(":")[0].strip() in keys]
        if found:
            cpu += ", " + found[0]
    except OSError:
        pass
    out["cpu"] = f"{cpu}, {os.cpu_count()} cores visible"
    return out


def _watts(s: str):
    try:
        return float(s.split()[0])
    except (ValueError, IndexError, AttributeError):
        return None


# -------------------------------------------------------------------- window
class GuidedTimer:
    """CUDA events around each ``_guided`` call (no synchronisation in the
    window); read after it."""

    def __init__(self, model):
        self.pairs = []
        orig = model._guided

        def timed(*a, **k):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = orig(*a, **k)
            e.record()
            self.pairs.append((s, e))
            return out

        model._guided = timed

    def ms(self):
        return [s.elapsed_time(e) for s, e in self.pairs]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_window(model, args, cfg, traffic, seed, seconds, recorder):
    """The measured window: (samples, the checked sample's record, its
    index, peak device bytes). The checked sample is drawn from the seed,
    uniformly among the samples the window finishes (a reservoir of one:
    sample i is recorded, in place of the one kept, with probability
    1/(i+1)), so that one record at most is kept on the card."""
    from rich_text_to_image_tpu_torch.cli.sample import run_sample

    dev = model.device
    rng = np.random.default_rng(derive(seed, "check"))
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    samples, rec, check_i = [], None, None
    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        s_i = sample_seed(seed, i)
        record = rng.random() * (i + 1) < 1.0
        if record:
            rec = None
            recorder.start()
        a = time.perf_counter()
        _, _, secs = run_sample(model, args, sample_param(
            cfg, traffic, s_i, cfg["pipeline"]["steps"]), save=False)
        sync(dev)
        b = time.perf_counter()
        if record:
            rec, check_i = recorder.stop(), i
        samples.append(dict(index=i, seed=s_i, start=a - t0, end=b - t0,
                            seconds=dict(secs)))
        i += 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return samples, rec, check_i, peak


def forbidden_modules() -> list:
    """The top-level names in ``sys.modules`` that a run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def read_metric(name: str, ctx: dict):
    """The per-layer metric ``name`` from its reader,
    ``metrics/<name>.py``."""
    return load_module(HERE / "metrics" / f"{name}.py").read(ctx)


# ---------------------------------------------------------------- correctness
def guided_sample(rec: dict, seed: int, n: int) -> list:
    steps = sorted(rec["rich"]["guided"])
    if len(steps) <= n:
        return steps
    rng = np.random.default_rng(derive(seed, "guided"))
    return sorted(int(s) for s in rng.choice(steps, n, replace=False))


def checked(rec, traffic, limits, run_seed):
    """(steps, colour-guided steps) a comparison checks, drawn from the
    run's seed."""
    from .reference.check import check_steps

    S = len(rec["plain"]["lat"]) - 1
    return (check_steps(traffic, S, derive(run_seed, "steps"),
                        limits["steps_checked"]),
            guided_sample(rec, run_seed, limits["guided_steps"]))


def check(cfg, traffic, limits, rec, run_seed, sample_seed_, device):
    """The numbers of the checked sample against the reference."""
    fam = family(cfg)
    state = fam.draw_state(cfg, run_seed, device)
    ref = fam.reference(cfg, state, device)
    del state
    which = fam.checked(rec, traffic, limits, run_seed)
    outs = fam.evaluate(ref, rec, traffic, sample_seed_, which)
    return fam.compare(fam.subject_of(rec), outs, rec)


def verdict(nums: dict, limits: dict):
    lim = limits["limits"]
    lines, ok = {}, set(nums) == set(lim)
    for k in sorted(set(nums) | set(lim)):
        v, l = nums.get(k), lim.get(k)
        good = v is not None and l is not None and v <= l
        ok &= good
        lines[k] = {"value": v, "limit": l}
    return ok, lines


# ----------------------------------------------------------------------- run
def run(args, t_start: float) -> int:
    cell = load_cell(args.workload)
    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no card: cuda available {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} device(s), the cell needs {chips}")
        return 2
    return run_cell(cell, args, t_start, torch.device("cuda", 0))


def run_cell(cell: dict, args, t_start: float, dev) -> int:
    """Everything of a run after the look for the card."""
    cfg, traffic, limits = cell["cfg"], cell["traffic"], cell["limits"]
    fam = family(cfg)

    # ---- set-up: weights from the seed, the program's pipeline, warm-up
    t_c = time.perf_counter()
    torch.empty(1, device=dev)  # the card's context
    sync(dev)
    t_d = time.perf_counter()
    state = fam.draw_state(cfg, args.seed, dev, log)
    sync(dev)
    t_b = time.perf_counter()
    model = fam.build_model(cfg, state, dev)
    del state
    sync(dev)
    log(f"set-up: {t_c - t_start:.3f} s of imports, {t_d - t_c:.3f} s for "
        f"the card's context, {t_b - t_d:.3f} s drawing the weights, "
        f"{time.perf_counter() - t_b:.3f} s building the pipeline")
    cargs = cli_args(cfg, traffic)
    from rich_text_to_image_tpu_torch.cli.sample import run_sample
    from rich_text_to_image_tpu_torch.ops import attention as A

    warm = cfg["pipeline"]["agg_start_step"] + WARMUP_STEPS_PAST_CAPTURE
    t_w = time.perf_counter()
    run_sample(model, cargs, sample_param(cfg, traffic, derive(
        args.seed, "warmup"), warm), save=False)
    sync(dev)
    log(f"warm-up: one sample of {warm} steps in "
        f"{time.perf_counter() - t_w:.3f} s")
    recorder = fam.recorder(model)
    timer = (GuidedTimer(model) if args.trace and hasattr(model, "_guided")
             else None)
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.4f}")

    # ---- the window
    A.reset_launches()
    samples, rec, check_i, peak = run_window(
        model, cargs, cfg, traffic, args.seed, args.seconds, recorder)
    n = len(samples)
    span = samples[-1]["end"] - samples[0]["start"]
    log(f"window: {n} sample(s) in {span:.4f} s (asked {args.seconds} s); "
        "each: " + json.dumps([[round(s['start'], 4), round(s['end'], 4)]
                               for s in samples]))
    log("stage seconds: " + json.dumps([s["seconds"] for s in samples]))
    log("launches by (bucket, B, H, Sq, Skv, head dim), whole window: "
        + json.dumps({",".join(map(str, k)): v for k, v
                      in sorted(A.LAUNCHES_BY_SHAPE.items())}))
    hw = hardware() if dev.type == "cuda" else {}
    log("hardware, after the window: " + json.dumps(hw))
    metrics = {}
    values = {"images_per_min": 60.0 * n / span,
              "peak_mem_gib": peak / GIB, "setup_s": setup_s}
    result = {"correct": False, "attempted": n, "failed": 0}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak),
              "power_limit_w": _watts(hw.get("power.limit"))}

    if args.trace:
        ctx = trace_metrics(model, cargs, cfg, traffic, args.seed, samples,
                            span, timer)
        device["busy_s"], device["window_s"] = ctx["busy_s"], ctx["window_s"]
        for m in cell["per_layer"]:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = ctx["breakdown"]
    else:
        for m in cell["e2e"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the port may not load JAX or the JAX "
            "package")
        return 3

    # ---- the comparison, with the program's state freed
    del recorder, timer, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rec is None:
        log("no sample was recorded")
        ok, lines = False, {}
    else:
        t_c = time.perf_counter()
        nums = check(cfg, traffic, limits, rec, args.seed,
                     samples[check_i]["seed"], dev)
        ok, lines = verdict(nums, limits)
        log(f"comparison of sample {check_i} in "
            f"{time.perf_counter() - t_c:.1f} s")
    result.update(correct=bool(ok), metrics=metrics, device=device)
    result["checks"] = lines
    for k, v in lines.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


def trace_metrics(model, cargs, cfg, traffic, seed, samples, span, timer):
    """The per-layer readings: stage seconds, mfu and the guided step from
    the window's samples; the device's time from one more sample, profiled
    with the spans on."""
    from rich_text_to_image_tpu_torch.cli.sample import run_sample
    from torch.autograd.profiler import record_function

    from . import trace as T

    fam = family(cfg)
    guided_ms = timer.ms() if timer is not None else []
    mean_s = span / len(samples)
    steps = cfg["pipeline"]["steps"]
    clock = {}

    def one(tag):
        def run():
            clock[tag] = [time.time_ns()]
            with record_function("sample"):
                run_sample(model, cargs, sample_param(
                    cfg, traffic, derive(seed, tag), steps), save=False)
                torch.cuda.synchronize()
            clock[tag].append(time.time_ns())
        return run

    # the device's busy time: a sample with the device's side traced only
    _, ev = T.profiled(one("profiled-device"), cpu=False)
    d = T.busy(ev, *clock["profiled-device"])
    del ev
    log(f"profiled sample, device only: {d['window_s']:.4f} s traced against "
        f"{mean_s:.4f} s a sample in the window (overhead "
        f"{d['window_s'] / mean_s - 1:.4f}); {d['n_device_ops']} device "
        f"ops of kinds {json.dumps(d['kinds'])}, busy {d['busy_s']:.4f} s")
    # the spans: a sample with the host's operators and the spans as well
    spans = fam.spans(model)
    a = time.perf_counter()
    _, events = T.profiled(one("profiled-spans"))
    b = time.perf_counter()
    spans.remove()
    t0 = t1 = None
    for ev in events:
        if ev.name() == "sample" and ev.device_type() != (
                torch.autograd.DeviceType.CUDA):
            t0, t1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    r = T.read(events, t0, t1)
    del events
    log(f"profiled sample, host and device: {b - a:.3f} s with the profiler "
        f"and its reading, {r['window_s']:.4f} s traced (overhead "
        f"{r['window_s'] / mean_s - 1:.4f}); {r['n_device_ops']} device ops, "
        f"{r['n_unlaunched']} without a launch found, {r['n_attn_spans']} "
        f"attn1_core spans; the host clock's start against the span's: "
        f"{(t0 - clock['profiled-spans'][0]) / 1e6:.3f} ms")
    fl, bound, calls = fam.work(cfg, traffic)
    log(f"work of one sample: {fl:.6e} FLOPs; attention bound {bound:.6f} s; "
        f"attention calls (count, B, H, S, d, capture): " + json.dumps(calls))
    return dict(samples=samples, window_span_s=span, flops_per_sample=fl,
                peak_flops=F.PEAK_FLOPS, attn_bound_s=bound,
                attn_core_s=r["attn_core_s"], busy_s=d["busy_s"],
                window_s=d["window_s"], guided_ms=guided_ms,
                n_unlaunched=r["n_unlaunched"],
                breakdown={"device_ops": r["device_ops"],
                           "idle_gaps": r["idle_gaps"]})
