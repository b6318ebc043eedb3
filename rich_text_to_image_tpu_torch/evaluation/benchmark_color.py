"""Colour-accuracy benchmark (protocol of the reference's
evaluation/benchmark_color.py).

Counterpart of ``rich_text_to_image_tpu/evaluation/benchmark_color.py``.
Suites common/html/rgb × 12 object prompts × 3 seeds; per item the rich
pass runs "<nearest-colour> <object>" + base prompt with gradient colour
guidance (weight 1, inject_selfattn 0.2, inject_background 0.3 — :251-255),
scored by min / region-averaged L2 RGB distance against the plain image
(and the prompt-to-prompt baseline with ``--with_p2p``). One latent per
seed, shared by all colours (reference :194), drawn by
``pipelines.region_sd.draw_latents``.

    python -m rich_text_to_image_tpu_torch.evaluation.benchmark_color \\
        --random_weights --steps 4 --limit 4 --num_seeds 1 --batch_colors 4

With ``--mesh`` under ``torchrun`` (one process per device) the pipeline is
placed on the mesh and each batched item's UNet rows split over dp inside
``color_bench_batch``; rank 0 writes the images and the summary.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..ops.resize import resize_bicubic
from ..parallel.mesh import is_main_rank
from ..pipelines import region_sd
from ..utils.colors import find_nearest_color
from ..utils.png import read_png, write_png
from ..utils.token_maps import get_token_maps
from .metrics import RunningStats, color_distances
from .suites import (BASE_PROMPTS, COLOR_SUITES, GUIDANCE_SCALE,
                     NUM_DIFFUSION_STEPS, OBJECTS)


def make_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--category", default="common",
                   choices=list(COLOR_SUITES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_seeds", type=int, default=3)
    p.add_argument("--save_path", default="results/benchmark_color")
    p.add_argument("--save_img", action="store_true")
    p.add_argument("--limit", type=int, default=0,
                   help="cap on (prompt,color) items per seed; 0 = all")
    p.add_argument("--steps", type=int, default=NUM_DIFFUSION_STEPS)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--random_weights", action="store_true")
    p.add_argument("--with_p2p", action="store_true",
                   help="also run the prompt-to-prompt baseline")
    p.add_argument("--load_previous", action="store_true",
                   help="re-score previously saved images instead of "
                        "regenerating (reference benchmark_color.py:280-282)")
    p.add_argument("--batch_colors", type=int, default=1,
                   help="run N colours per (seed,prompt) in one loop, "
                        "sharing the reference-trajectory rows "
                        "(RegionDiffusion.color_bench_batch). 1 = the "
                        "reference's sequential loop")
    p.add_argument("--guidance_downsample", type=int, default=1,
                   help="opt-in: compute the colour-guidance gradient at "
                        "1/d resolution (pool the x0 latent before the VAE "
                        "decode). 1 = exact reference math")
    p.add_argument("--bf16_guidance", action="store_true",
                   help="bfloat16 colour-guidance VAE gradient. Default "
                        "keeps the reference's fp32")
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh, one process per device (torchrun): "
                        "'auto', N, dp,tp or dcn,dp,tp")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda)")
    return p


def load_model(args):
    """The pipeline a run uses when none is passed: a local checkpoint, or
    random weights."""
    from ..pipelines.region_sd import RegionDiffusion

    if args.checkpoint_dir:
        return RegionDiffusion.from_pretrained(args.checkpoint_dir,
                                               device=args.device)
    return RegionDiffusion.random_init(seed=0, device=args.device)


def place_model(args, model=None):
    """The run's pipeline — ``model``, or :func:`load_model`'s — on the
    ``--mesh`` (the world, and this rank's card, are set up before the
    weights are loaded)."""
    from ..parallel.mesh import mesh_from_spec

    mesh = mesh_from_spec(getattr(args, "mesh", None))
    if model is None:
        model = load_model(args)
    if mesh is not None:
        model.use_mesh(mesh)
    return model


def region_mask_px(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """A latent-size soft mask [1, h, w] at pixel size [H, W], bicubic with
    antialiasing, clipped to [0, 1]."""
    px = resize_bicubic(torch.from_numpy(np.asarray(mask, np.float32)),
                        (height, width))
    return px.clamp(0, 1)[0].numpy()


def run(args, model=None):
    model = place_model(args, model)
    main_rank = is_main_rank()
    p2p = None
    if args.with_p2p:
        from ..pipelines.prompt_to_prompt import PromptToPromptPipeline

        p2p = PromptToPromptPipeline(model)

    colors = COLOR_SUITES[args.category]
    os.makedirs(args.save_path, exist_ok=True)
    height = width = 512 if model.unet_cfg.sample_size >= 64 else (
        model.unet_cfg.sample_size * model.vae_scale_factor)
    lat_hw = (height // model.vae_scale_factor,
              width // model.vae_scale_factor)

    stats = {k: RunningStats() for k in
             ("plain_min", "plain_avg", "ours_min", "ours_avg",
              "p2p_min", "p2p_avg")}
    fmt_base = {"guidance_start_step": 999, "color_guidance_weight": 1}

    for seed in range(args.seed, args.seed + args.num_seeds):
        latent = region_sd.draw_latents((1, *lat_hw, 4), seed, model.device)
        n_done = 0
        for text_prompt, object_name in zip(BASE_PROMPTS, OBJECTS):
            img_base, agg = model.produce_attn_maps(
                [text_prompt], [""], height=height, width=width,
                num_inference_steps=args.steps,
                guidance_scale=GUIDANCE_SCALE, latents=latent, seed=seed)
            obj_ids = _token_ids(model.tokenizer, text_prompt, object_name)
            masks = get_token_maps(agg, [obj_ids], lat_hw, seed,
                                   segment_threshold=0.25, num_segments=9)
            model.masks = [masks[0], masks[-1]]
            mask_px = region_mask_px(masks[0], height, width)

            # batched path: all colours of this (seed, prompt) in chunks,
            # the reference rows shared within a chunk
            pre_imgs = {}
            if args.batch_colors > 1 and not args.load_previous:
                todo = list(colors.items())
                if args.limit:
                    todo = todo[: max(args.limit - n_done, 0)]
                for c0 in range(0, len(todo), args.batch_colors):
                    chunk = todo[c0:c0 + args.batch_colors]
                    rgbs = np.stack([np.asarray(v, np.float64) / 255.0
                                     for _, v in chunk])
                    imgs = model.color_bench_batch(
                        [f"{find_nearest_color(r)} {object_name}"
                         for r in rgbs], text_prompt,
                        rgbs.astype(np.float32), mask_px, height, width,
                        args.steps, GUIDANCE_SCALE, seed=seed,
                        latents=latent,
                        color_guidance_weight=fmt_base[
                            "color_guidance_weight"],
                        guidance_start_step=fmt_base["guidance_start_step"],
                        bf16_guidance=args.bf16_guidance,
                        guidance_downsample=args.guidance_downsample)
                    for (cname, _), img in zip(chunk, imgs):
                        pre_imgs[cname] = img[None]

            for color_name, rgb255 in colors.items():
                if args.limit and n_done >= args.limit:
                    break
                n_done += 1
                rgb = np.asarray(rgb255, np.float64) / 255.0
                prompts = [f"{find_nearest_color(rgb)} {object_name}",
                           text_prompt]
                ours_name = os.path.join(
                    args.save_path,
                    f"ours_{object_name}_{color_name}_{seed}.png")
                if args.load_previous:
                    img_ours = read_png(ours_name)[None]
                elif color_name in pre_imgs:
                    img_ours = pre_imgs[color_name]
                else:
                    fmt = dict(fmt_base)
                    fmt["target_RGB"] = [rgb.astype(np.float32)]
                    fmt["color_obj_atten"] = [mask_px[None]]
                    fmt["color_obj_atten_all"] = np.asarray(masks[0])
                    img_ours = model.prompt_to_img(
                        prompts, [""], height=height, width=width,
                        num_inference_steps=args.steps,
                        guidance_scale=GUIDANCE_SCALE, latents=latent,
                        text_format_dict=fmt, use_guidance=True,
                        inject_selfattn=0.2, inject_background=0.3,
                        seed=seed, bf16_guidance=args.bf16_guidance,
                        guidance_downsample=args.guidance_downsample)
                for key, img in (("plain", img_base), ("ours", img_ours)):
                    mn, av = color_distances(img[0], mask_px, rgb,
                                             color_name)
                    stats[f"{key}_min"].add(mn)
                    stats[f"{key}_avg"].add(av)
                if p2p is not None:
                    edited = text_prompt.replace(
                        object_name, color_name + " " + object_name)
                    img_p2p = p2p.generate(
                        text_prompt, edited, latents=latent,
                        num_inference_steps=args.steps,
                        guidance_scale=GUIDANCE_SCALE, seed=seed,
                        height=height, width=width)
                    mn, av = color_distances(img_p2p[-1], mask_px, rgb,
                                             color_name)
                    stats["p2p_min"].add(mn)
                    stats["p2p_avg"].add(av)
                if args.save_img and not args.load_previous and main_rank:
                    write_png(ours_name, img_ours[0])
            print(f"Min dis. N: {len(stats['ours_min'])}, "
                  f"plain: {stats['plain_min'].fmt()}, "
                  f"ours: {stats['ours_min'].fmt()}, "
                  f"p2p: {stats['p2p_min'].fmt()}")
            print(f"Avg dis. N: {len(stats['ours_avg'])}, "
                  f"plain: {stats['plain_avg'].fmt()}, "
                  f"ours: {stats['ours_avg'].fmt()}, "
                  f"p2p: {stats['p2p_avg'].fmt()}")
            if args.limit and n_done >= args.limit:
                break

    summary = {k: {"mean": s.mean, "std": s.std, "n": len(s)}
               for k, s in stats.items()}
    summary["config"] = config_of(args)
    if main_rank:
        with open(os.path.join(args.save_path, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def config_of(args) -> dict:
    """The run's flags, so that a summary stays attributable to them."""
    return {k: v for k, v in sorted(vars(args).items())
            if isinstance(v, (bool, int, float, str, type(None)))}


def _token_ids(tokenizer, base_prompt: str, span: str) -> np.ndarray:
    base_tokens = tokenizer._tokenize(base_prompt)
    return np.asarray(
        [base_tokens.index(t) + 1 for t in tokenizer._tokenize(span)],
        dtype=np.int32)


def main(argv=None):
    from ..parallel.mesh import world_scope

    with world_scope():
        run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
