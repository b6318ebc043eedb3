"""CLI sampler of the port — the flags and flow of the JAX package's
``cli/sample.py`` (the reference's sample.py), for SD-1.5 and SDXL:

    python -m rich_text_to_image_tpu_torch.cli.sample --random_weights
    python -m rich_text_to_image_tpu_torch.cli.sample --model SDXL \
        --random_weights

Plain pass with attention capture, token maps, then the rich pass with
region compositing, font-size reweighting, colour guidance and, with
``--inject_selfattn`` / ``--inject_background``, self-attention and
background injection: by default through the refer-precompute flow (the
plain pass keeps the reference trajectory and the injection steps' (Q, K)
and resnet feature, and the rich pass reads them), with
``--no_ref_precompute`` through the in-batch flow. ``--model SDXL`` (and
``AnimeXL``, the same architecture) samples at 1024x1024 under Euler by
default, SD at 512x512 under PNDM; ``--scheduler`` takes pndm, ddim, dpm or
euler; the turbo knobs ``--encoder_reuse``, ``--encoder_schedule``,
``--guidance_downsample`` and ``--bf16_guidance`` are the JAX CLI's.
``--height`` / ``--width`` take any multiple of 64 (768x768, 512x768, ...).
``--model FLUX`` runs FLUX.1-dev (``pipelines/region_flux.py``) at 1024x1024
under flow-matching Euler (``--scheduler flow_euler``), ``--guidance_weight``
being its distilled guidance (3.5 where not given); it refuses colour spans,
font sizes, injection, encoder reuse, a negative prompt and ``--mesh``.
Images are written as PNG, and every run writes the segmentation and
token-map figures beside them; ``--save_attn`` also writes the aggregated
attention maps under ``maps/``. ``--bf16_vae`` decodes SDXL's images in
bfloat16 (the SD branch does not read it, as in the JAX CLI). The CLI
refuses ``--model SD --scheduler euler``, whose rich pass fails in the JAX
package.

``--mesh`` (``auto``, ``N``, ``dp,tp``, ``dcn,dp,tp``; ``parallel/mesh.py``)
runs one process per device, as ``torchrun`` starts them:

    torchrun --nproc_per_node 2 -m rich_text_to_image_tpu_torch.cli.sample \
        --random_weights --mesh 2,1

Every rank runs the request; the UNet's rows split over dp and its weights
over tp, and rank 0 writes the files. As in the JAX grammar, ``N`` alone
picks tp as 4 or 2 where it divides: ``--mesh 2`` is (dp, tp) = (1, 2),
``2,1`` is dp = 2.

``--trace_dir DIR`` runs the sample with the port's tracer on
(``utils/tracing``) under ``torch.profiler``: it writes a Chrome trace
(``<host>_<pid>.pt.trace.json``, the program's spans beside the host's
operators and the card's kernels) and the tracer's report
(``<host>_<pid>.spans.json``: every span with its parent, sample, attrs and
host times on the trace's clock, the UNet calls, decodes and guided steps
with their device milliseconds, and the counters) into DIR.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..utils import tracing

DEFAULT_RICH_TEXT = (
    '{"ops":[{"insert":"A close-up 4k dslr photo of a "},{"attributes":'
    '{"link":"A cat wearing sunglasses and a bandana around its neck."},'
    '"insert":"cat"},{"insert":" riding a scooter. There are palm trees in '
    'the background."}]}')


def make_scheduler(name):
    """The scheduler that ``--scheduler`` names (None: the pipeline's
    default, PNDM for SD and Euler for SDXL)."""
    if name is None:
        return None
    from ..schedulers import (DDIMScheduler, DPMSolverMultistepScheduler,
                              EulerDiscreteScheduler, FlowMatchEulerScheduler,
                              PNDMScheduler)

    return {"pndm": PNDMScheduler, "ddim": DDIMScheduler,
            "dpm": DPMSolverMultistepScheduler,
            "euler": EulerDiscreteScheduler,
            "flow_euler": FlowMatchEulerScheduler}[name]()


def build_model(args):
    """The pipeline of ``--model``: RegionDiffusion for SD,
    RegionDiffusionXL for SDXL and AnimeXL (its VAE decode in bfloat16 with
    ``--bf16_vae``), on ``--device``, placed on the ``--mesh``."""
    import torch

    from ..parallel.mesh import mesh_from_spec

    # the world, and this rank's card, before the weights are placed
    mesh = mesh_from_spec(getattr(args, "mesh", None))
    kw = dict(device=args.device, scheduler=make_scheduler(args.scheduler),
              mesh=mesh)
    if args.model == "SD":
        from ..pipelines.region_sd import RegionDiffusion as cls
        what = "SD-1.5"
    elif args.model == "FLUX":
        from ..pipelines.region_flux import RegionFlux as cls
        what = "FLUX.1-dev"
        if args.checkpoint_dir:
            raise SystemExit("--model FLUX: no checkpoint loader yet; use "
                             "--random_weights")
    else:
        from ..pipelines.region_sdxl import RegionDiffusionXL as cls
        what = "SDXL"
        if args.bf16_vae:
            kw["vae_dtype"] = torch.bfloat16
    if args.checkpoint_dir:
        return cls.from_pretrained(args.checkpoint_dir, **kw)
    if args.random_weights:
        return cls.random_init(seed=0, **kw)
    raise SystemExit(f"no weights: pass --checkpoint_dir <local {what} "
                     "diffusers directory> or --random_weights")


def run_sample(model, args, param, save=True):
    """The reference main() flow (sample.py:17-114). Returns (plain image,
    rich image, {stage: seconds}). The sample is the tracer's root span
    ``sample``; its stages are the spans ``plain_pass``, ``token_maps``
    and ``rich_pass``, whose host seconds (each ending in a
    synchronisation) are the stage seconds, those of ``figures`` kept
    apart from ``token_maps``."""
    with tracing.span("sample"):
        return _run_sample(model, args, param, save)


def _run_sample(model, args, param, save):
    import torch

    from ..ops.resize import resize_bicubic
    from ..utils import richtext
    from ..utils.png import write_png
    from ..utils.token_maps import get_token_maps

    run_dir = args.run_dir
    if save:
        os.makedirs(run_dir, exist_ok=True)
    parsed = richtext.parse_json(param["text_input"])
    tok = model.tokenizer._tokenize
    region_text_prompts, region_target_token_ids, base_tokens = (
        richtext.get_region_diffusion_input(tok, parsed))
    text_format_dict = richtext.get_attention_control_input(
        tok, base_tokens, parsed)
    text_format_dict, color_target_token_ids = (
        richtext.get_gradient_guidance_input(
            tok, base_tokens, parsed, text_format_dict,
            color_guidance_weight=args.color_guidance_weight))
    height, width = param["height"], param["width"]
    seed = param["noise_index"]
    negative_text = param["negative_prompt"]
    f = model.vae_scale_factor
    lat_hw = (height // f, width // f)

    def _sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    # refer-trajectory precompute: with injection the plain pass (same
    # seed, prompt and scheduler: it is the reference trajectory) also keeps
    # the injection steps' (Q, K)/resnet features and the latents, and the
    # rich pass drops its reference rows
    use_refpre = ((args.inject_selfattn > 0 or args.inject_background > 0)
                  and not args.no_ref_precompute)
    ref_kw = {}
    if use_refpre:
        plan = model.scheduler.plan(param["steps"])
        gates = np.asarray(plan.timesteps, np.float64) > (
            (1 - args.inject_selfattn) * 1000)
        ref_kw = {"ref_capture_steps": tuple(np.nonzero(gates)[0].tolist())}

    seconds = {}
    # ---- plain pass + attention aggregation
    with tracing.span("plain_pass", timed=True) as stage:
        plain_img, agg = model.produce_attn_maps(
            [parsed.base_text_prompt], [negative_text], height=height,
            width=width, num_inference_steps=param["steps"],
            guidance_scale=param["guidance_weight"], seed=seed, **ref_kw)
        _sync()
    seconds["plain_pass"] = stage.seconds
    if save:
        write_png(os.path.join(run_dir, f"seed{seed}_plain.png"), plain_img[0])
    print("time lapses to get attention maps: %.4f" % seconds["plain_pass"])

    # ---- token maps (colour spans, then region spans — sample.py:77-92);
    # like the reference, every call writes its segmentation and token-map
    # figures into run_dir (attention_utils.py:266-270, 334-335); the time
    # they take is kept apart from the stage's, as "figures"
    with tracing.span("token_maps", timed=True) as stage:
        seconds["figures"] = 0.0
        seg_kw = dict(segment_threshold=args.segment_threshold,
                      num_segments=args.num_segments,
                      save_dir=run_dir if save else None,
                      tokens_vis=base_tokens, save_attn=args.save_attn,
                      timings=seconds)
        color_obj_masks = get_token_maps(agg, color_target_token_ids[:-1],
                                         lat_hw, seed, **seg_kw)
        color_obj_atten_all = np.zeros_like(color_obj_masks[-1])
        for m in color_obj_masks[:-1]:
            color_obj_atten_all += m
        text_format_dict["color_obj_atten"] = [
            resize_bicubic(torch.from_numpy(m), (height, width)).numpy()
            for m in color_obj_masks[:-1]]
        text_format_dict["color_obj_atten_all"] = color_obj_atten_all
        model.masks = get_token_maps(agg, region_target_token_ids[:-1],
                                     lat_hw, seed, **seg_kw)
    seconds["token_maps"] = stage.seconds - seconds["figures"]

    # ---- rich pass
    with tracing.span("rich_pass", timed=True) as stage:
        rich_img = model.prompt_to_img(
            region_text_prompts, [negative_text], height=height, width=width,
            num_inference_steps=param["steps"],
            guidance_scale=param["guidance_weight"],
            use_guidance=parsed.use_grad_guidance,
            inject_selfattn=args.inject_selfattn,
            inject_background=args.inject_background,
            text_format_dict=text_format_dict, seed=seed,
            encoder_reuse=args.encoder_reuse,
            encoder_schedule=args.encoder_schedule,
            bf16_guidance=args.bf16_guidance,
            guidance_downsample=args.guidance_downsample,
            **({"ref_cache": model.ref_cache}
               if use_refpre and model.ref_cache is not None else {}))
        _sync()
    seconds["rich_pass"] = stage.seconds
    if save:
        write_png(os.path.join(run_dir, f"seed{seed}_rich.png"), rich_img[0])
    print("time lapses to generate image from rich text: %.4f"
          % seconds["rich_pass"])
    return plain_img, rich_img, seconds


def trace_sample(model, args, param, save=True):
    """:func:`run_sample` with the tracer on, under
    ``utils.tracing.device_trace`` into ``args.trace_dir``; the tracer's
    report is written as JSON beside the Chrome trace. Returns (the trace's
    path, the report's path)."""
    tracing.report()  # what an earlier run left
    with tracing.collect(), tracing.device_trace(args.trace_dir) as path:
        run_sample(model, args, param, save=save)
    spans = path[:-len(".pt.trace.json")] + ".spans.json"
    with open(spans, "w", encoding="utf-8") as f:
        json.dump(tracing.report(), f)
    print(f"trace: {path}; spans and counters: {spans}")
    return path, spans


# What the FLUX.1 path does not run yet, each a later item of ROADMAP.md's
# Queue D: (what, whether the flags ask for it)
_FLUX_REFUSED = (
    ("colour spans (colour guidance)",
     lambda a, p: bool(p is not None and p.color_text_prompts)),
    ("font-size spans (token weights)",
     lambda a, p: bool(p is not None and p.size_text_prompts_and_sizes)),
    ("--inject_selfattn > 0", lambda a, p: a.inject_selfattn > 0),
    ("--inject_background > 0", lambda a, p: a.inject_background > 0),
    ("--encoder_reuse (a UNet's down path)", lambda a, p: a.encoder_reuse != 1),
    ("a negative prompt (the guidance is distilled: no CFG)",
     lambda a, p: bool(a.negative_prompt)),
    ("--mesh", lambda a, p: a.mesh is not None),
)


def check_args(args) -> None:
    """Exit with a message on flags this port does not cover yet."""
    if args.model == "FLUX":
        from ..utils import richtext

        if args.scheduler not in (None, "flow_euler"):
            raise SystemExit(f"--model FLUX: --scheduler {args.scheduler}: "
                             "FLUX.1 samples by flow matching "
                             "(--scheduler flow_euler)")
        try:
            parsed = richtext.parse_json(json.loads(args.rich_text_json))
        except (ValueError, TypeError, KeyError):
            parsed = None
        for what, asks in _FLUX_REFUSED:
            if asks(args, parsed):
                raise SystemExit(
                    f"--model FLUX: {what} is not on the FLUX.1 path yet "
                    "(ROADMAP.md, Queue D #5: FLUX.1's colour guidance, font "
                    "size and injection)")
    elif args.scheduler == "flow_euler":
        raise SystemExit("--scheduler flow_euler is FLUX.1's (--model FLUX)")
    if args.model == "SD" and args.scheduler == "euler":
        # Euler's timesteps are floats; the JAX package's rich pass indexes
        # alphas_cumprod with them and raises
        raise SystemExit(
            "--scheduler euler: the SD rich pass fails under Euler in the "
            "JAX package (pipelines/region_sd.py:772 indexes alphas_cumprod "
            "with its float timesteps: IndexError), and the port refuses it "
            "likewise (ROADMAP.md, Queue 3); use pndm, ddim or dpm (SDXL's "
            "rich pass runs under Euler)")


class _Parser(argparse.ArgumentParser):
    """Fills ``--guidance_weight`` left unset with the model's default:
    3.5 for FLUX.1-dev (its distilled guidance, its model card's), else
    CFG's 8.5."""

    def parse_args(self, *a, **k):
        args = super().parse_args(*a, **k)
        if args.guidance_weight is None:
            args.guidance_weight = 3.5 if args.model == "FLUX" else 8.5
        return args


def make_parser():
    p = _Parser()
    p.add_argument("--run_dir", type=str, default="results/")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--seed", type=int, default=6)
    p.add_argument("--sample_steps", type=int, default=41)
    p.add_argument("--rich_text_json", type=str, default=DEFAULT_RICH_TEXT)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--model", type=str, default="SD",
                   choices=["SD", "SDXL", "AnimeXL", "FLUX"])
    # CFG's weight; FLUX.1's distilled guidance under --model FLUX (None:
    # 8.5, or 3.5 for FLUX)
    p.add_argument("--guidance_weight", type=float, default=None)
    p.add_argument("--color_guidance_weight", type=float, default=0.5)
    p.add_argument("--inject_selfattn", type=float, default=0.0)
    p.add_argument("--segment_threshold", type=float, default=0.3)
    p.add_argument("--num_segments", type=int, default=9)
    p.add_argument("--inject_background", type=float, default=0.0)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--random_weights", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda)")
    # SDXL: the final decode in bfloat16; the SD branch does not read it
    p.add_argument("--bf16_vae", action="store_true")
    p.add_argument("--save_attn", action="store_true")
    p.add_argument("--scheduler", type=str, default=None,
                   choices=["pndm", "ddim", "dpm", "euler", "flow_euler"])
    p.add_argument("--bf16_guidance", action="store_true")
    p.add_argument("--no_ref_precompute", action="store_true")
    p.add_argument("--guidance_downsample", type=int, default=1)
    p.add_argument("--encoder_reuse", type=int, default=1)
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh, one process per device (torchrun): "
                        "'auto', N, dp,tp or dcn,dp,tp")
    p.add_argument("--encoder_schedule", choices=["early", "uniform"],
                   default="early")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="run the sample with the tracer on under "
                        "torch.profiler and write its Chrome trace and the "
                        "tracer's report (spans, counters) into this "
                        "directory")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    check_args(args)
    default_resolution = 512 if args.model == "SD" else 1024
    param = {
        "text_input": json.loads(args.rich_text_json),
        "height": args.height or default_resolution,
        "width": args.width or default_resolution,
        "guidance_weight": args.guidance_weight,
        "steps": args.sample_steps,
        "noise_index": args.seed,
        "negative_prompt": args.negative_prompt,
    }
    from ..parallel.mesh import is_main_rank, world_scope

    with world_scope():
        model = build_model(args)
        if args.trace_dir is None:
            run_sample(model, args, param, save=is_main_rank())
        else:
            trace_sample(model, args, param, save=is_main_rank())


if __name__ == "__main__":
    main()
