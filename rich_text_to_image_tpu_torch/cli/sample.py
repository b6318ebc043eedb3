"""CLI sampler of the port — the flags and flow of the JAX package's
``cli/sample.py`` (the reference's sample.py), for the SD-1.5 model:

    python -m rich_text_to_image_tpu_torch.cli.sample --random_weights

Plain pass with attention capture, token maps, then the rich pass with
region compositing, font-size reweighting, colour guidance and, with
``--inject_selfattn`` / ``--inject_background`` together with
``--no_ref_precompute``, self-attention and background injection through
the in-batch flow. ``--height`` / ``--width`` take any multiple of 64
(768x768, 512x768, ...). Images are written as PNG. Flags of the JAX CLI
that this port does not cover yet exit with a message naming them.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

DEFAULT_RICH_TEXT = (
    '{"ops":[{"insert":"A close-up 4k dslr photo of a "},{"attributes":'
    '{"link":"A cat wearing sunglasses and a bandana around its neck."},'
    '"insert":"cat"},{"insert":" riding a scooter. There are palm trees in '
    'the background."}]}')


def build_model(args):
    from ..pipelines.region_sd import RegionDiffusion

    if args.checkpoint_dir:
        return RegionDiffusion.from_pretrained(args.checkpoint_dir,
                                               device=args.device)
    if args.random_weights:
        return RegionDiffusion.random_init(seed=0, device=args.device)
    raise SystemExit("no weights: pass --checkpoint_dir <local SD-1.5 "
                     "diffusers directory> or --random_weights")


def run_sample(model, args, param, save=True):
    """The reference main() flow (sample.py:17-114). Returns (plain image,
    rich image, {stage: seconds})."""
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

    seconds = {}
    # ---- plain pass + attention aggregation
    begin = time.time()
    plain_img, agg = model.produce_attn_maps(
        [parsed.base_text_prompt], [negative_text], height=height,
        width=width, num_inference_steps=param["steps"],
        guidance_scale=param["guidance_weight"], seed=seed)
    _sync()
    seconds["plain_pass"] = time.time() - begin
    if save:
        write_png(os.path.join(run_dir, f"seed{seed}_plain.png"), plain_img[0])
    print("time lapses to get attention maps: %.4f" % seconds["plain_pass"])

    # ---- token maps (colour spans, then region spans — sample.py:77-92)
    begin = time.time()
    seg_kw = dict(segment_threshold=args.segment_threshold,
                  num_segments=args.num_segments)
    color_obj_masks = get_token_maps(agg, color_target_token_ids[:-1],
                                     lat_hw, seed, **seg_kw)
    color_obj_atten_all = np.zeros_like(color_obj_masks[-1])
    for m in color_obj_masks[:-1]:
        color_obj_atten_all += m
    text_format_dict["color_obj_atten"] = [
        resize_bicubic(torch.from_numpy(m), (height, width)).numpy()
        for m in color_obj_masks[:-1]]
    text_format_dict["color_obj_atten_all"] = color_obj_atten_all
    model.masks = get_token_maps(agg, region_target_token_ids[:-1], lat_hw,
                                 seed, **seg_kw)
    seconds["token_maps"] = time.time() - begin

    # ---- rich pass
    begin = time.time()
    rich_img = model.prompt_to_img(
        region_text_prompts, [negative_text], height=height, width=width,
        num_inference_steps=param["steps"],
        guidance_scale=param["guidance_weight"],
        use_guidance=parsed.use_grad_guidance,
        inject_selfattn=args.inject_selfattn,
        inject_background=args.inject_background,
        text_format_dict=text_format_dict, seed=seed)
    _sync()
    seconds["rich_pass"] = time.time() - begin
    if save:
        write_png(os.path.join(run_dir, f"seed{seed}_rich.png"), rich_img[0])
    print("time lapses to generate image from rich text: %.4f"
          % seconds["rich_pass"])
    return plain_img, rich_img, seconds


# flags of the JAX CLI outside this port's slice, with the value that
# means "off"
_NOT_PORTED = {
    "encoder_reuse": 1, "bf16_guidance": False, "guidance_downsample": 1,
    "mesh": None, "bf16_vae": False, "save_attn": False,
    "encoder_schedule": "early",
}


def check_args(args) -> None:
    """Exit with a message on flags this port does not cover yet."""
    if args.model != "SD":
        raise SystemExit(f"--model {args.model}: only SD (SD-1.5) is ported "
                         "to PyTorch yet (ROADMAP.md, Queue 1)")
    if args.scheduler not in (None, "pndm"):
        raise SystemExit(f"--scheduler {args.scheduler}: only pndm is ported "
                         "yet (ROADMAP.md, Queue 1)")
    if ((args.inject_selfattn > 0 or args.inject_background > 0)
            and not args.no_ref_precompute):
        # without the flag the JAX CLI runs the refer-precompute flow, a
        # different computation from the in-batch one that is ported
        raise SystemExit(
            "--inject_selfattn / --inject_background: the refer-precompute "
            "flow is not ported to PyTorch yet (ROADMAP.md, Queue 1); add "
            "--no_ref_precompute to run the in-batch flow")
    on = [f"--{k}" for k, off in _NOT_PORTED.items()
          if getattr(args, k) != off]
    if on:
        raise SystemExit(
            f"{' '.join(on)}: not ported to PyTorch yet (turbo knobs, meshes "
            "and the segmentation/attention figures are later slices; "
            "ROADMAP.md, Queue 1)")


def make_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", type=str, default="results/")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--seed", type=int, default=6)
    p.add_argument("--sample_steps", type=int, default=41)
    p.add_argument("--rich_text_json", type=str, default=DEFAULT_RICH_TEXT)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--model", type=str, default="SD",
                   choices=["SD", "SDXL", "AnimeXL"])
    p.add_argument("--guidance_weight", type=float, default=8.5)
    p.add_argument("--color_guidance_weight", type=float, default=0.5)
    p.add_argument("--inject_selfattn", type=float, default=0.0)
    p.add_argument("--segment_threshold", type=float, default=0.3)
    p.add_argument("--num_segments", type=int, default=9)
    p.add_argument("--inject_background", type=float, default=0.0)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--random_weights", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda)")
    # accepted for the JAX CLI's flag set; exit unless left off
    p.add_argument("--bf16_vae", action="store_true")
    p.add_argument("--save_attn", action="store_true")
    p.add_argument("--scheduler", type=str, default=None,
                   choices=["pndm", "ddim", "dpm", "euler"])
    p.add_argument("--bf16_guidance", action="store_true")
    p.add_argument("--no_ref_precompute", action="store_true")
    p.add_argument("--guidance_downsample", type=int, default=1)
    p.add_argument("--encoder_reuse", type=int, default=1)
    p.add_argument("--mesh", type=str, default=None)
    p.add_argument("--encoder_schedule", choices=["early", "uniform"],
                   default="early")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    check_args(args)
    param = {
        "text_input": json.loads(args.rich_text_json),
        "height": args.height or 512,
        "width": args.width or 512,
        "guidance_weight": args.guidance_weight,
        "steps": args.sample_steps,
        "noise_index": args.seed,
        "negative_prompt": args.negative_prompt,
    }
    run_sample(build_model(args), args, param)


if __name__ == "__main__":
    main()
