"""Local-style benchmark (protocol of the reference's
evaluation/benchmark_style.py).

Counterpart of ``rich_text_to_image_tpu/evaluation/benchmark_style.py``.
10 scenes × 2 regions × 7×6 ordered style pairs × 3 seeds; rich pass with
"<region> in the style of <style>" prompts (no guidance or injection —
:124-127); metric: CLIP similarity of the black-composited region crop
against its styled region prompt (:146-167), overall and per region.

    python -m rich_text_to_image_tpu_torch.evaluation.benchmark_style \\
        --random_weights --steps 4 --limit 6 --num_seeds 1 --batch_pairs 6
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..pipelines import region_sd
from ..parallel.mesh import is_main_rank
from ..utils.png import read_png, write_png
from ..utils.token_maps import get_token_maps
from .benchmark_color import config_of, place_model, region_mask_px
from .metrics import RunningStats, compose_region
from .suites import (GUIDANCE_SCALE, NUM_DIFFUSION_STEPS, STYLE_REGIONS,
                     STYLE_SCENES, STYLES)


def make_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_seeds", type=int, default=3)
    p.add_argument("--save_path", default="results/benchmark_style")
    p.add_argument("--save_img", action="store_true")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--steps", type=int, default=NUM_DIFFUSION_STEPS)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--random_weights", action="store_true")
    p.add_argument("--clip_dir", type=str, default=None,
                   help="local CLIP ViT-B/32 checkpoint for the scorer")
    p.add_argument("--with_p2p", action="store_true")
    p.add_argument("--load_previous", action="store_true",
                   help="re-score previously saved images instead of "
                        "regenerating (reference benchmark_style.py)")
    p.add_argument("--batch_pairs", type=int, default=1,
                   help="run N style pairs per (seed,scene) in one loop "
                        "(RegionDiffusion.style_bench_batch). 1 = the "
                        "reference's sequential loop")
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh, one process per device (torchrun): "
                        "'auto', N, dp,tp or dcn,dp,tp")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda)")
    return p


def _resolve_scorer(args, model, scorer):
    """Returns (scorer, is_random). Without ``--clip_dir`` the scorer has
    random weights, and an unmissable banner says so, so that smoke scores
    are never taken for style-fidelity results."""
    if scorer is not None:
        return scorer, False
    from ..utils.clip_score import CLIPScorer

    device = getattr(args, "device", "cuda")
    if args.clip_dir:
        return CLIPScorer.from_pretrained(args.clip_dir, device=device), False
    print(
        "=" * 70 + "\n"
        "WARNING: no --clip_dir given — CLIP scorer is RANDOM-WEIGHT.\n"
        "The benchmark protocol runs, but every CLIP similarity below\n"
        "is protocol-only smoke output, NOT a style-fidelity result.\n"
        "Pass --clip_dir <local ViT-B/32 checkpoint> for real scores.\n"
        + "=" * 70,
        flush=True,
    )
    return CLIPScorer.random_init(seed=0, tokenizer=model.tokenizer,
                                  device=device), True


def run(args, model=None, scorer=None):
    model = place_model(args, model)
    main_rank = is_main_rank()
    scorer, scorer_is_random = _resolve_scorer(args, model, scorer)
    p2p = None
    if args.with_p2p:
        from ..pipelines.prompt_to_prompt import PromptToPromptPipeline

        p2p = PromptToPromptPipeline(model)

    os.makedirs(args.save_path, exist_ok=True)
    height = width = 512 if model.unet_cfg.sample_size >= 64 else (
        model.unet_cfg.sample_size * model.vae_scale_factor)
    lat_hw = (height // model.vae_scale_factor,
              width // model.vae_scale_factor)

    overall = {"ours": RunningStats(), "p2p": RunningStats()}
    per_region = {"ours": [RunningStats(), RunningStats()],
                  "p2p": [RunningStats(), RunningStats()]}
    pairs = [(s1, s2) for s1 in STYLES for s2 in STYLES if s1 != s2]

    for seed in range(args.seed, args.seed + args.num_seeds):
        latent = region_sd.draw_latents((1, *lat_hw, 4), seed, model.device)
        n_done = 0
        for scene, regions in zip(STYLE_SCENES, STYLE_REGIONS):
            _, agg = model.produce_attn_maps(
                [scene], [""], height=height, width=width,
                num_inference_steps=args.steps,
                guidance_scale=GUIDANCE_SCALE, latents=latent, seed=seed)
            base_tokens = model.tokenizer._tokenize(scene)
            ids = [np.asarray([base_tokens.index(t) + 1
                               for t in model.tokenizer._tokenize(span)],
                              dtype=np.int32) for span in regions]
            masks = get_token_maps(agg, ids, lat_hw, seed,
                                   segment_threshold=0.3, num_segments=15)
            model.masks = masks
            masks_px = [region_mask_px(m, height, width) for m in masks]

            def prompts_of(s1, s2):
                return [f"{regions[0]} in the style of {s1}",
                        f"{regions[1]} in the style of {s2}", scene]

            # batched path: style pairs of this (seed, scene) in chunks
            pre_imgs = {}
            if args.batch_pairs > 1 and not args.load_previous:
                todo = pairs
                if args.limit:
                    todo = todo[: max(args.limit - n_done, 0)]
                for c0 in range(0, len(todo), args.batch_pairs):
                    chunk = todo[c0:c0 + args.batch_pairs]
                    imgs = model.style_bench_batch(
                        [prompts_of(s1, s2) for s1, s2 in chunk], height,
                        width, args.steps, GUIDANCE_SCALE, seed=seed,
                        latents=latent)
                    for pair, im in zip(chunk, imgs):
                        pre_imgs[pair] = im[None]

            for s1, s2 in pairs:
                if args.limit and n_done >= args.limit:
                    break
                n_done += 1
                rich = prompts_of(s1, s2)
                ours_name = os.path.join(
                    args.save_path,
                    f"ours_{'_'.join(regions)}_{s1}_{s2}_{seed}.png")
                if args.load_previous:
                    img = read_png(ours_name)[None]
                else:
                    img = pre_imgs.get((s1, s2))
                    if img is None:
                        img = model.prompt_to_img(
                            rich, [""], height=height, width=width,
                            num_inference_steps=args.steps,
                            guidance_scale=GUIDANCE_SCALE, latents=latent,
                            use_guidance=False, seed=seed)
                    if args.save_img and main_rank:
                        write_png(ours_name, img[0])
                img_p2p = None
                if p2p is not None:
                    edited = scene.replace(regions[0], rich[0]).replace(
                        regions[1], rich[1])
                    img_p2p = p2p.generate(
                        scene, edited, latents=latent,
                        num_inference_steps=args.steps,
                        guidance_scale=GUIDANCE_SCALE, seed=seed,
                        height=height, width=width)
                for rid in range(2):
                    for key, im in (("ours", img), ("p2p", img_p2p)):
                        if im is None:
                            continue
                        sc = scorer.get_clip_score(
                            compose_region(im[-1], masks_px[rid]), rich[rid])
                        overall[key].add(sc)
                        per_region[key][rid].add(sc)
                print(f"N: {len(overall['ours'])}, "
                      f"ours: {overall['ours'].fmt()}, "
                      f"p2p: {overall['p2p'].fmt()}")
            if args.limit and n_done >= args.limit:
                break

    summary = {
        "ours": {"mean": overall["ours"].mean, "std": overall["ours"].std,
                 "region1": per_region["ours"][0].mean,
                 "region2": per_region["ours"][1].mean,
                 "n": len(overall["ours"])},
        "p2p": {"mean": overall["p2p"].mean, "std": overall["p2p"].std,
                "n": len(overall["p2p"])},
        # stamped so that a saved smoke run is never taken for results
        "clip_scores_random_weights": scorer_is_random,
        "config": config_of(args),
    }
    if main_rank:
        with open(os.path.join(args.save_path, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    from ..parallel.mesh import world_scope

    with world_scope():
        run(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
