"""Token-map debugging CLI of the port (the JAX package's
``cli/visualize_token_maps.py``; the reference's visualize_token_maps.py):

    python -m rich_text_to_image_tpu_torch.cli.visualize_token_maps \\
        --random_weights --words cat scooter

Runs the plain pass on ``--prompt``, segments its attention maps, and
writes the segmentation figure and the token maps of the chosen words as
PNG into ``--run_dir``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.token_maps import get_token_maps
from ..utils.viz import plot_attention_maps, save_segmentation
from .sample import build_model


def make_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", type=str, default="results/token_maps")
    p.add_argument("--prompt", type=str,
                   default="A cat riding a scooter by the beach.")
    p.add_argument("--words", type=str, nargs="+", default=["cat", "scooter"])
    p.add_argument("--seed", type=int, default=6)
    p.add_argument("--sample_steps", type=int, default=41)
    p.add_argument("--model", type=str, default="SD",
                   choices=["SD", "SDXL", "AnimeXL"])
    p.add_argument("--guidance_weight", type=float, default=8.5)
    p.add_argument("--segment_threshold", type=float, default=0.3)
    p.add_argument("--num_segments", type=int, default=9)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--random_weights", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda)")
    # what cli.sample.build_model reads besides: the pipeline's defaults
    p.set_defaults(scheduler=None, bf16_vae=False)
    return p


def token_ids_of(tokenizer, prompt: str, words):
    """1-based positions in ``prompt``'s tokens of each word's tokens."""
    base = tokenizer._tokenize(prompt)
    return base, [np.asarray([base.index(t) + 1
                              for t in tokenizer._tokenize(word)], np.int32)
                  for word in words]


def run(model, args):
    """The plain pass, the segmentation and the figures; returns (masks,
    clusters)."""
    res = 512 if args.model == "SD" else 1024
    height, width = args.height or res, args.width or res
    base_tokens, token_ids = token_ids_of(model.tokenizer, args.prompt,
                                          args.words)
    _, agg = model.produce_attn_maps(
        [args.prompt], [""], height=height, width=width,
        num_inference_steps=args.sample_steps,
        guidance_scale=args.guidance_weight, seed=args.seed)
    f = model.vae_scale_factor
    masks, clusters = get_token_maps(
        agg, token_ids, (height // f, width // f), args.seed,
        segment_threshold=args.segment_threshold,
        num_segments=args.num_segments, return_segments=True)
    save_segmentation(clusters, args.run_dir, args.num_segments, args.seed)
    plot_attention_maps([masks], token_ids, args.run_dir, args.seed,
                        tokens_vis=base_tokens)
    return masks, clusters


def main(argv=None):
    args = make_parser().parse_args(argv)
    run(build_model(args), args)
    print(f"saved token maps for {args.words} under {args.run_dir}")


if __name__ == "__main__":
    main()
