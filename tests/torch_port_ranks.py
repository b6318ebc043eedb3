"""What the port's mesh tests run in spawned ranks.

A test starts a group of ranks once (:func:`start`), each a fresh process
that imports only torch, numpy and the port (never JAX: this module imports
nothing else), joined in a ``gloo`` process group through a ``file://``
store under the test's temporary directory, so that parallel pytest workers
never share a port. Each rank runs one function of this module on a spec
of picklable inputs (state dicts, the port's config dataclasses, numpy
arrays) and saves what it returns; :meth:`Ranks.results` joins the group,
with a deadline, and loads every rank's result.
"""

import contextlib
import dataclasses
import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rich_text_to_image_tpu_torch.models import config as C
from rich_text_to_image_tpu_torch.models.clip import CLIPTextModel
from rich_text_to_image_tpu_torch.models.tokenizer import CLIPTokenizer
from rich_text_to_image_tpu_torch.models.unet import (INJECT_RESNET_NAME,
                                                      CaptureSpec,
                                                      UNet2DCondition,
                                                      UNetControls)
from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL
from rich_text_to_image_tpu_torch.parallel.mesh import mesh_from_spec
from rich_text_to_image_tpu_torch.pipelines import region_sd as TP
from rich_text_to_image_tpu_torch.utils.registries import (
    attn_layer_resolutions)

PX, H = 16, 8  # the tiny VAE halves the size: an 8^2 latent
XL_PX, XL_H = 32, 16
XL_TEXT2 = C.CLIPTextConfig(vocab_size=1000, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=2, hidden_act="gelu",
                            projection_dim=32)


# ---------------------------------------------------------------- the group
class Ranks:
    """A started group; :meth:`results` waits for it (once)."""

    def __init__(self, ctx, out: str, world: int, timeout: float):
        self.ctx, self.out, self.world = ctx, out, world
        self.deadline = time.monotonic() + timeout
        self._results = None

    def results(self) -> list:
        if self._results is None:
            try:
                while not self.ctx.join(timeout=2):
                    if time.monotonic() > self.deadline:
                        raise TimeoutError(f"{self.world} ranks still "
                                           "running")
            finally:
                for p in self.ctx.processes:
                    if p.is_alive():
                        p.kill()
            self._results = [
                torch.load(os.path.join(self.out, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]
        return self._results


def start(fn, world: int, tmp_dir, spec, timeout: float = 300) -> Ranks:
    """``fn(rank, spec)`` in ``world`` spawned ranks of a ``gloo`` group."""
    tmp_dir = str(tmp_dir)
    store = os.path.join(tmp_dir, f"store_{fn.__name__}_{world}")
    out = os.path.join(tmp_dir, f"out_{fn.__name__}_{world}")
    os.makedirs(out, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(fn, world, store, out, spec),
                             nprocs=world, join=False, start_method="spawn")
    return Ranks(ctx, out, world, timeout)


def _entry(rank, fn, world, store, out, spec):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, spec)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture()
def world_of_one():
    """A test that starts the world in the pytest process itself (a
    ``--mesh`` flag outside ``torchrun``: one process) ends it after."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------- the models
def port_cfg(cfg):
    """A config dataclass of the JAX package as the port's own (the two
    modules declare the same fields)."""
    return getattr(C, type(cfg).__name__)(**dataclasses.asdict(cfg))


def sd_spec(tp, agg_start_step: int, masks) -> dict:
    """What a rank needs to rebuild the tiny SD pipeline ``tp``."""
    return {"unet": tp.unet.state_dict(), "vae": tp.vae.state_dict(),
            "text": tp.text_encoder.state_dict(),
            "unet_cfg": port_cfg(tp.unet_cfg), "vae_cfg": port_cfg(tp.vae_cfg),
            "text_cfg": port_cfg(tp.text_encoder.cfg),
            "agg": agg_start_step, "masks": [np.asarray(m) for m in masks]}


def sd_pipe(spec, mesh=None, **kw):
    """The tiny SD pipeline of ``spec``, float32 on the CPU, placed on the
    mesh that the ``--mesh`` string ``mesh`` names."""
    mods = []
    for cls, key in ((UNet2DCondition, "unet"), (AutoencoderKL, "vae"),
                     (CLIPTextModel, "text")):
        m = cls(spec[f"{key}_cfg"])
        m.load_state_dict(spec[key])
        mods.append(m)
    pipe = TP.RegionDiffusion(*mods, CLIPTokenizer.byte_level(),
                              spec["unet_cfg"], spec["vae_cfg"], device="cpu",
                              agg_start_step=spec["agg"], **kw)
    pipe.masks = [m.copy() for m in spec["masks"]]
    if mesh is not None:
        pipe.use_mesh(mesh_from_spec(mesh))
    return pipe


def xl_pipe(mesh=None):
    """The tiny SDXL pipeline, random weights drawn from seed 0 (the same
    in every process)."""
    from rich_text_to_image_tpu_torch.pipelines.region_sdxl import (
        RegionDiffusionXL)

    pipe = RegionDiffusionXL.random_init(
        seed=0, unet_cfg=C.TINY_XL_UNET, vae_cfg=C.TINY_VAE,
        text_cfg=C.TINY_TEXT, text2_cfg=XL_TEXT2, dtype=torch.float32,
        device="cpu", agg_start_step=2)
    if mesh is not None:
        pipe.use_mesh(mesh_from_spec(mesh))
    return pipe


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().float().numpy().copy()
    return tree


def rank_view(tree, tp_rank: int, tp: int):
    """A one-rank result as tp rank ``tp_rank`` of ``tp`` holds it where the
    attention runs on each rank's own heads: every captured (Q, K) under
    ``self_qk`` [B,H,S,hd] narrowed to the rank's block of heads, every
    refer-cache (Q, K) under ``qk`` [n,S,C] to its block of channels; the
    rest, gathered whole on every rank, as it is."""
    def block(a, dim):
        n = a.shape[dim] // tp
        return np.take(a, range(tp_rank * n, (tp_rank + 1) * n), axis=dim)

    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("self_qk", "qk") and tp > 1:
            dim = 1 if k == "self_qk" else -1
            out[k] = {n: tuple(block(a, dim) for a in pair)
                      for n, pair in v.items()}
        else:
            out[k] = rank_view(v, tp_rank, tp)
    return out


# -------------------------------------------------------------- the checks
def forward_inputs(cfg, rows: int = 3, seed: int = 3) -> dict:
    """A UNet call of ``rows`` rows with every capture and the in-batch
    injection (row 1 into row 2) and per-row font-size weights."""
    rng = np.random.default_rng(seed)
    tw = np.ones((rows, 77), np.float32)
    tw[-1, 2:4] = (2.0, 0.5)
    return {"x": rng.standard_normal((rows, H, H, 4)).astype(np.float32),
            "ctx": rng.standard_normal(
                (rows, 77, cfg.cross_attention_dim)).astype(np.float32),
            "tw": tw, "ts": np.ones((rows, 77), np.float32), "t": 500}


def forward_capture(cfg) -> CaptureSpec:
    names = attn_layer_resolutions(cfg, (H, H))
    return CaptureSpec(
        self_probs=frozenset(n for n in names if n.endswith(".attn1")),
        cross_probs=frozenset(n for n in names if n.endswith(".attn2")),
        qk=True, resnet=frozenset({INJECT_RESNET_NAME}), cross_full=True)


def forward_controls(inp) -> UNetControls:
    return UNetControls(token_weights=torch.from_numpy(inp["tw"]),
                        token_signs=torch.from_numpy(inp["ts"]),
                        inject_gate=True, inject_src=1, inject_dst=(2, 3))


@torch.no_grad()
def unet_forward(pipe, inp) -> dict:
    """The pipeline's UNet call (rows split over the mesh): eps and aux."""
    eps, aux = pipe._unet_call(
        torch.from_numpy(inp["x"]), inp["t"], torch.from_numpy(inp["ctx"]),
        forward_controls(inp), forward_capture(pipe.unet_cfg))
    return {"eps": _np(eps), "aux": _np(aux)}


STEPS, G = 4, 7.5
PROMPTS = ["a red rose", "a garden with a rose bush"]  # R = 1: 5 in-batch rows
FLOWS = {"plain": (0.0, 0.0), "in_batch": (0.4, 0.3), "refpre": (0.4, 0.3)}


def rich_flows(pipe, lat0) -> dict:
    """The rich pass in its three flows from ``lat0``, the refpre one after
    the plain pass that keeps its cache; with the capture's aggregates and
    the cache."""
    out = {}
    for flow, (selfattn, background) in FLOWS.items():
        cache = None
        if flow == "refpre":
            plan = pipe.scheduler.plan(STEPS)
            steps = tuple(np.nonzero(plan.timesteps.astype(np.float64) > (
                1 - selfattn) * 1000)[0].tolist())
            _, agg = pipe.produce_attn_maps(
                [PROMPTS[-1]], [""], height=PX, width=PX,
                num_inference_steps=STEPS, guidance_scale=G, latents=lat0,
                ref_capture_steps=steps)
            cache = pipe.ref_cache
            out["agg"] = {"self_sum": _np(agg.self_sum),
                          "cross_sums": dict(agg.cross_sums)}
            out["cache"] = _np({k: cache[k] for k in ("traj", "qk",
                                                        "resnet")})
        spec = TP.RichControlSpec(guidance_scale=G, inject_selfattn=selfattn,
                                  inject_background=background)
        out[flow] = _np(pipe.produce_latents(
            pipe.get_text_embeds(PROMPTS, [""]), height=PX, width=PX,
            num_inference_steps=STEPS, latents=lat0, spec=spec,
            ref_cache=cache))
    return out


def batched_paths(pipe, lat0) -> dict:
    """``text_to_images`` (3 prompts, 6 rows), ``color_bench_batch`` (K = 2:
    8 rows, then 6) and ``style_bench_batch`` (K = 2, R = 1: 6 rows)."""
    kw = dict(height=PX, width=PX, num_inference_steps=STEPS,
              guidance_scale=G, seed=1)
    mask_px = np.kron(pipe.masks[0].reshape(H, H),
                      np.ones((2, 2), np.float32))
    return {
        "t2i": pipe.text_to_images(["a", "b c", "d"], **kw),
        "color": pipe.color_bench_batch(
            ["red rose", "blue rose"], "a rose in a garden",
            np.array([[0.9, 0.1, 0.1], [0.1, 0.1, 0.9]], np.float32),
            mask_px, latents=lat0, **kw),
        "style": pipe.style_bench_batch(
            [["a rose, oil painting", "a garden"],
             ["a rose, pixel art", "a garden"]], latents=lat0, **kw),
    }


def xl_rich(pipe, lat0) -> np.ndarray:
    """The SDXL rich pass under Euler, two region masks."""
    rng = np.random.default_rng(7)
    soft = rng.random((2, 1, XL_H, XL_H)).astype(np.float32) + 0.1
    pipe.masks = list(soft / soft.sum(axis=0, keepdims=True))
    return pipe.prompt_to_img(PROMPTS, [""], height=XL_PX, width=XL_PX,
                              num_inference_steps=STEPS, guidance_scale=5.0,
                              latents=lat0, seed=0)


CLI_ARGV = ["--random_weights", "--device", "cpu", "--height", str(PX),
            "--width", str(PX), "--sample_steps", str(STEPS),
            "--num_segments", "3", "--inject_selfattn", "0.3",
            "--inject_background", "0.3", "--seed", "2"]
BENCH_ARGV = ["--steps", str(STEPS), "--limit", "2", "--num_seeds", "1",
              "--batch_colors", "2", "--save_img", "--device", "cpu"]


def run_cli(spec, run_dir, mesh=None):
    """``cli.sample.main`` with its pipeline built by the tiny spec (the
    CLI's own ``build_model`` and ``--mesh``); returns the files written."""
    from rich_text_to_image_tpu_torch.cli import sample

    orig = TP.RegionDiffusion.random_init
    TP.RegionDiffusion.random_init = classmethod(
        lambda cls, seed=0, device="cpu", scheduler=None, mesh=None:
        sd_pipe(spec).use_mesh(mesh))
    try:
        sample.main(CLI_ARGV + ["--run_dir", run_dir]
                    + (["--mesh", mesh] if mesh else []))
    finally:
        TP.RegionDiffusion.random_init = orig
    return _files(run_dir)


def run_bench(spec, save_path, mesh=None):
    """``evaluation.benchmark_color.run`` on the tiny pipeline with its own
    ``--mesh``; returns (summary, files written)."""
    from rich_text_to_image_tpu_torch.evaluation import benchmark_color

    args = benchmark_color.make_parser().parse_args(
        BENCH_ARGV + ["--save_path", save_path]
        + (["--mesh", mesh] if mesh else []))
    summary = benchmark_color.run(args, model=sd_pipe(spec))
    return summary, _files(save_path)


def _files(d) -> dict:
    """{name: uint8 image or parsed JSON} of the files under ``d``."""
    from rich_text_to_image_tpu_torch.utils.png import read_png

    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            rel = os.path.relpath(p, d)
            if n.endswith(".png"):
                out[rel] = read_png(p)
            elif n.endswith(".json"):
                with open(p, encoding="utf-8") as f:
                    out[rel] = json.load(f)
    return out


DEMO_JSON = json.dumps({"ops": [
    {"insert": "a "},
    {"attributes": {"color": "#ff0000"}, "insert": "red"},
    {"insert": " rose in a "},
    {"attributes": {"link": "a lush green summer garden"}, "insert": "garden"},
    {"insert": "\n"},
]})
# the click's arguments: text, negative, seed, steps, guidance, colour
# weight, inject self-attention, inject background, threshold, segments
DEMO_REQUEST = (DEMO_JSON, "", 3, STEPS, 7.5, 0.5, 0.3, 0.3, 0.3, 4)


def gradio_stub():
    """The least of gradio that ``build_app`` touches, recording the
    components it makes."""
    gr = types.ModuleType("gradio")
    gr.created = []

    class Component:
        def __init__(self, kind, *a, **kw):
            self.kind, self.args, self.kw, self.clicks = kind, a, kw, []

        def click(self, fn=None, *a, **kw):
            self.clicks.append(fn)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def factory(kind):
        def make(*a, **kw):
            c = Component(kind, *a, **kw)
            gr.created.append(c)
            return c
        return make

    for kind in ("Blocks", "HTML", "Textbox", "Slider", "Button", "Image",
                 "Row", "Examples", "Checkbox"):
        setattr(gr, kind, factory(kind))
    gr.Error = type("Error", (Exception,), {})
    gr.utils = types.SimpleNamespace()
    return gr


# ---------------------------------------------------------- rank functions
def two_rank_checks(rank, spec):
    """Every 2-rank check, in one group: the UNet call at dp = 2 and
    tp = 2, the batched paths and the SDXL rich pass at dp = 2, the CLI and
    the colour bench through their ``--mesh`` flags, and the demo's request
    loop."""
    from rich_text_to_image_tpu_torch.cli import gradio_app

    out = {}
    inp = spec["forward"]
    for name, mesh in (("dp2", "2,1"), ("tp2", "1,2")):
        out[f"fwd_{name}"] = unet_forward(sd_pipe(spec, mesh), inp)
    pipe = sd_pipe(spec, "2,1")
    out["batched"] = batched_paths(pipe, spec["lat0"])
    out["xl"] = xl_rich(xl_pipe("2,1"), spec["xl_lat0"])
    tmp = spec["tmp"]
    out["cli"] = run_cli(spec, os.path.join(tmp, f"cli_rank{rank}"), "2,1")
    out["bench"] = run_bench(spec, os.path.join(tmp, f"bench_rank{rank}"),
                             "2,1")
    # the demo: rank 0 serves the click, rank 1 follows
    pipe = sd_pipe(spec)
    vis = os.path.join(tmp, f"demo_rank{rank}")
    if rank == 0:
        sys.modules["gradio"] = gr = gradio_stub()
        gradio_app.build_app("SD", model=pipe, resolution=PX, mesh="2,1")
        gen = next(c for c in gr.created
                   if c.kind == "Button" and c.args == ("Generate",))
        out["demo"] = gen.clicks[0](*DEMO_REQUEST)
        gradio_app.send_request(None)
    else:
        from rich_text_to_image_tpu_torch.parallel.mesh import apply_mesh_arg

        apply_mesh_arg(pipe, "2,1")
        out["demo_served"] = gradio_app.follow_requests(pipe, PX, vis)
    return out


def four_rank_checks(rank, spec):
    """The UNet call at (dp, tp) = (2, 2) and (dcn, dp, tp) = (2, 1, 2),
    and the rich pass's three flows at (2, 2)."""
    out = {}
    for name, mesh in (("2x2", "2,2"), ("2x1x2", "2,1,2")):
        out[f"fwd_{name}"] = unet_forward(sd_pipe(spec, mesh),
                                          spec["forward"])
    out["rich"] = rich_flows(sd_pipe(spec, "2,2"), spec["lat0"])
    return out


def train_checks(rank, spec):
    """Three train steps at dp = 2 and at tp = 2 (or at the spec's
    ``train_meshes``, {name: ``--mesh``}) on the spec's parameters and
    draws: the losses, the first step's gradients (this rank's shard where
    tp shards a weight) and the parameters after the last step."""
    from rich_text_to_image_tpu_torch.training import train_step as TS

    out = {}
    meshes = spec.get("train_meshes", {"dp2": "2,1", "tp2": "1,2"})
    for name, mesh in meshes.items():
        draws = list(spec["draws"])
        TS.draw_t_noise = lambda gen, shape, device: tuple(
            torch.from_numpy(a) for a in draws.pop(0))
        init_fn, step = TS.make_train_step(
            spec["unet_cfg"], learning_rate=spec["lr"], dtype=torch.float32,
            mesh=mesh_from_spec(mesh), device="cpu")
        unet = UNet2DCondition(spec["unet_cfg"])
        unet.load_state_dict(spec["unet"])
        state = init_fn(unet=unet)
        losses, grads = [], None
        for _ in range(len(spec["draws"])):
            state, loss = step(state, spec["latents"], spec["ehs"], None)
            losses.append(float(loss))
            if grads is None:
                grads = {n: _np(p.grad)
                         for n, p in state.module.named_parameters()}
        sharded = {n for n, m in state.module.named_modules()
                   if getattr(m, "tp_shard", None) is not None}
        out[name] = {"losses": losses, "grads": grads,
                     "params": _np(dict(state.module.state_dict())),
                     "sharded": sharded}
    return out


# ------------------------------------------------- attention on own heads
ATTN_OPS = ("flash_attention", "flash_attention_avg_probs",
            "attention_with_probs", "cross_attention")


@contextlib.contextmanager
def recorded_attention():
    """Every call that ``Attention.forward`` makes of the attention ops, as
    (op, q shape), in order (not the calls the ops make of each other: the
    plain versions on the CPU reach ``attention_with_probs``)."""
    from rich_text_to_image_tpu_torch.ops import attention as A

    seen, orig, depth = [], {k: getattr(A, k) for k in ATTN_OPS}, [0]

    def wrap(k):
        def op(q, *a, **kw):
            if not depth[0]:
                seen.append((k, tuple(q.shape)))
            depth[0] += 1
            try:
                return orig[k](q, *a, **kw)
            finally:
                depth[0] -= 1
        return op

    for k in ATTN_OPS:
        setattr(A, k, wrap(k))
    try:
        yield seen
    finally:
        for k, f in orig.items():
            setattr(A, k, f)


BIG_H = 32  # a 32^2 latent: 1024 tokens at the first level, the flash path


def big_forward_inputs(cfg, rows: int = 2, seed: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((rows, BIG_H, BIG_H, 4)).astype(
                np.float32),
            "ctx": rng.standard_normal(
                (rows, 77, cfg.cross_attention_dim)).astype(np.float32),
            "t": 300}


def big_capture(cfg) -> CaptureSpec:
    """The first level's attn1 layers captured (the capture kernel's
    path); the others take the flash path."""
    names = attn_layer_resolutions(cfg, (BIG_H, BIG_H))
    return CaptureSpec(self_probs=frozenset(
        n for n, r in names.items() if n.endswith(".attn1") and r == BIG_H
        and n.startswith("down_blocks")))


@torch.no_grad()
def big_forward(pipe, inp) -> tuple:
    """The UNet alone on the 32^2 inputs (every rank the whole batch):
    (eps and the captured head means, the attention ops' q shapes)."""
    with recorded_attention() as seen:
        eps, aux = pipe.unet(torch.from_numpy(inp["x"]), inp["t"],
                             torch.from_numpy(inp["ctx"]),
                             capture=big_capture(pipe.unet_cfg))
    return {"eps": _np(eps), "aux": _np(aux)}, list(seen)


@torch.no_grad()
def gather_counts(pipe, inp) -> dict:
    """What one forward of the UNet alone (no capture, no controls) moved
    through ``all_gather_cat``, beside the layers that gather: sharded
    layers that keep the hook, and attention blocks on their own heads."""
    from rich_text_to_image_tpu_torch.models.unet import Attention
    from rich_text_to_image_tpu_torch.parallel import mesh as M

    M.reset_gathers()
    pipe.unet(torch.from_numpy(inp["x"]), inp["t"],
              torch.from_numpy(inp["ctx"]))
    mods = list(pipe.unet.modules())
    return {**M.GATHERS,
            "layers": sum(getattr(m, "tp_shard", None) is not None
                          and getattr(m, "tp_local", None) is None
                          for m in mods),
            "local_attention": sum(isinstance(m, Attention)
                                   and m.tp_local() is not None
                                   for m in mods),
            "attention": sum(isinstance(m, Attention) for m in mods)}


def p2p_runs(pipe, lat0) -> dict:
    """Prompt-to-prompt's ``generate`` (the decode the identity: final
    latents) under LocalBlend, and under Replace with an equalizer."""
    from rich_text_to_image_tpu_torch.pipelines import prompt_to_prompt as PP

    pipe.decode_latents = lambda lat: lat.numpy()
    gen = PP.PromptToPromptPipeline(pipe).generate
    eq = np.ones(77, np.float32)
    eq[[3, 4]] = (2.0, -1.0)
    kw = dict(num_inference_steps=STEPS, height=PX, width=PX, latents=lat0)
    return {"blend": gen("a cat on a mat", "a red cat on a mat",
                         blend_words=("cat", "cat"), blend_threshold=0.3,
                         **kw),
            "replace": gen("a cat runs", "a tiger runs", controller="replace",
                           equalizer=eq, **kw)}


def sharded_attention_checks(rank, spec):
    """At each of the spec's meshes ({name: ``--mesh``}): the UNet call of
    :func:`unet_forward` and the 32^2 forward with the ops' q shapes, the
    gathers of one forward with attention on its own heads and with every
    layer gathered (``heads_local`` off), and where the spec names them
    the rich flows, prompt-to-prompt and the train steps."""
    from rich_text_to_image_tpu_torch.parallel import mesh as M

    out = {}
    for name, mesh in spec["meshes"].items():
        pipe = sd_pipe(spec, mesh)
        with recorded_attention() as seen:
            fwd = unet_forward(pipe, spec["forward"])
        big, big_seen = big_forward(pipe, spec["big"])
        res = {"fwd": fwd, "fwd_seen": list(seen), "big": big,
               "big_seen": big_seen,
               "gathers": gather_counts(pipe, spec["big"])}
        orig = M.heads_local
        M.heads_local = lambda *a, **k: False
        try:
            res["gathers_all_layers"] = gather_counts(sd_pipe(spec, mesh),
                                                      spec["big"])
        finally:
            M.heads_local = orig
        if name in spec.get("rich", ()):
            res["rich"] = rich_flows(sd_pipe(spec, mesh), spec["lat0"])
        if name in spec.get("p2p", ()):
            res["p2p"] = p2p_runs(sd_pipe(spec, mesh), spec["lat0"])
        out[name] = res
    if spec.get("train_meshes"):
        out["train"] = train_checks(rank, spec)
    return out
