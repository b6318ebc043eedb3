"""The gradio web demo of the port:

    python -m rich_text_to_image_tpu_torch.cli.gradio_app --random_weights
    python -m rich_text_to_image_tpu_torch.cli.gradio_app --model SDXL \
        --checkpoint_dir <local diffusers directory>

Counterpart of ``rich_text_to_image_tpu/cli/gradio_app.py``. It embeds the
Quill rich-text editor (``cli/editor.html``) through the same JS bridge
(``document.body._data`` into a hidden textbox), exposes the knobs as
sliders and returns four outputs: the plain image, the rich image, the
segmentation figure and the token-map figure.

``run_generate`` is the whole request as a function, testable without
gradio or a browser; ``build_app``'s click callback wraps it and maps
``error_cls`` to ``gr.Error``. gradio is imported only inside
``build_app``: the module imports without it.

``--mesh`` places the serving pipeline on a device mesh, one process per
device under ``torchrun``: rank 0 serves the app and hands each request to
the other ranks (:func:`send_request`), which run it beside it in
:func:`follow_requests` until a ``None`` request ends them.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..utils import tracing

GET_JS_DATA = """
async (text_input) => {
  const frame = document.querySelector('iframe');
  return frame.contentDocument.body._data || text_input;
}
"""


def run_generate(model, resolution, text_input, negative_prompt, seed, steps,
                 guidance_weight, color_guidance_weight, inject_selfattn,
                 inject_background, segment_threshold, num_segments,
                 encoder_reuse=1, guidance_downsample=1, ref_precompute=True,
                 error_cls=ValueError, vis_dir="results/gradio_vis"):
    """Rich-text JSON string -> [plain image, rich image, segmentation
    figure, token-map figure] (uint8 [H, W, 3] arrays; the figures are also
    written as PNG into ``vis_dir``).

    The JAX package's ``run_generate``, step for step: the plain pass (with
    the refer cache where injection asks for it and ``ref_precompute`` is
    on), the colour spans' token maps, then the region spans' maps, the
    figures, and the rich pass. Raises ``error_cls`` on an empty or invalid
    JSON input. The stages are timed under ``utils.tracing.phase``
    (``plain_pass``, ``token_maps``, ``figures``, ``rich_pass``), so
    ``tracing.phase_report()`` reads their seconds and a device trace shows
    their spans."""
    from ..ops.resize import resize_bicubic
    from ..utils import richtext
    from ..utils.token_maps import get_token_maps
    from ..utils.viz import plot_attention_maps, save_segmentation

    if not text_input:
        raise error_cls("empty rich-text input")
    try:
        doc = json.loads(text_input)
    except json.JSONDecodeError as e:
        raise error_cls(f"invalid rich-text JSON: {e}") from e
    parsed = richtext.parse_json(doc)
    tok = model.tokenizer._tokenize
    region_prompts, region_ids, base_tokens = (
        richtext.get_region_diffusion_input(tok, parsed))
    fmt = richtext.get_attention_control_input(tok, base_tokens, parsed)
    fmt, color_ids = richtext.get_gradient_guidance_input(
        tok, base_tokens, parsed, fmt,
        color_guidance_weight=color_guidance_weight)
    h = w = resolution
    f = model.vae_scale_factor
    seed, steps = int(seed), int(steps)
    # the refer-precompute flow: the plain pass doubles as the reference
    # trajectory that the injected rich pass needs
    ref_kw = {}
    if ref_precompute and (inject_selfattn > 0 or inject_background > 0):
        plan = model.scheduler.plan(steps)
        gates = np.asarray(plan.timesteps, np.float64) > (
            (1 - inject_selfattn) * 1000)
        ref_kw = {"ref_capture_steps": tuple(np.nonzero(gates)[0].tolist())}
    with tracing.phase("plain_pass"):
        plain, agg = model.produce_attn_maps(
            [parsed.base_text_prompt], [negative_prompt], height=h, width=w,
            num_inference_steps=steps, guidance_scale=guidance_weight,
            seed=seed, **ref_kw)
    seg = dict(segment_threshold=segment_threshold,
               num_segments=int(num_segments))
    with tracing.phase("token_maps"):
        color_masks = get_token_maps(agg, color_ids[:-1], (h // f, w // f),
                                     seed, **seg)
        fmt["color_obj_atten"] = [
            resize_bicubic(torch.from_numpy(m), (h, w)).numpy()
            for m in color_masks[:-1]]
        fmt["color_obj_atten_all"] = (
            sum(np.asarray(m) for m in color_masks[:-1])
            if len(color_masks) > 1 else np.zeros_like(color_masks[0]))
        masks, clusters = get_token_maps(
            agg, region_ids[:-1], (h // f, w // f), seed,
            return_segments=True, **seg)
        model.masks = masks
    with tracing.phase("figures"):
        seg_vis = save_segmentation(clusters, vis_dir, int(num_segments),
                                    seed)
        tok_vis = plot_attention_maps([masks], region_ids[:-1], vis_dir,
                                      seed, tokens_vis=base_tokens)
    with tracing.phase("rich_pass"):
        rich = model.prompt_to_img(
            region_prompts, [negative_prompt], height=h, width=w,
            num_inference_steps=steps, guidance_scale=guidance_weight,
            use_guidance=parsed.use_grad_guidance,
            inject_selfattn=inject_selfattn,
            inject_background=inject_background, text_format_dict=fmt,
            seed=seed, encoder_reuse=int(encoder_reuse),
            guidance_downsample=int(guidance_downsample),
            **({"ref_cache": model.ref_cache}
               if ref_kw and model.ref_cache is not None else {}))
    return [plain[0], rich[0], seg_vis, tok_vis]


def send_request(request) -> None:
    """Rank 0 hands a request's ``run_generate`` arguments (after the
    model and the resolution) to the other ranks; ``None`` ends their
    loops."""
    import torch.distributed as dist

    dist.broadcast_object_list([request], src=0)


def follow_requests(model, resolution, vis_dir: str) -> int:
    """On every rank but 0 of a mesh: run each request rank 0 sends
    through the same ``run_generate`` (the collectives of its UNet calls
    pair with rank 0's), until a ``None`` request; returns how many ran. A
    request that rank 0 turns away as invalid is turned away here too,
    before any collective."""
    import torch.distributed as dist

    served = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        if box[0] is None:
            return served
        try:
            run_generate(model, resolution, *box[0], vis_dir=vis_dir)
        except ValueError:
            continue
        served += 1


def build_app(model_kind: str = "SD", checkpoint_dir: str | None = None,
              random_weights: bool = False, model=None,
              resolution: int | None = None, mesh: str | None = None,
              device: str = "cuda"):
    """The demo's ``gr.Blocks``: the editor, the sliders at ``APP_DEFAULTS``
    of ``model_kind``, the example banks, the share button and the
    generate button's click binding. ``model`` and ``resolution`` take a
    pipeline built elsewhere and another output size (the tests' tiny
    pipeline); otherwise the pipeline is built as the CLI builds it.
    ``mesh`` takes the CLI's ``--mesh`` grammar and places the serving
    pipeline on that mesh; each click then sends its request to the other
    ranks before it runs."""
    from .sample import build_model

    if model is None:
        model = build_model(argparse.Namespace(
            model=model_kind, checkpoint_dir=checkpoint_dir,
            random_weights=random_weights, device=device, scheduler=None,
            bf16_vae=False, mesh=mesh))
    elif mesh:
        from ..parallel.mesh import apply_mesh_arg

        apply_mesh_arg(model, mesh)
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; the demo needs it (pip install "
            "gradio). run_generate is the same request without it.") from e

    from .examples import APP_DEFAULTS, example_rows
    from .share_button import COMMUNITY_JS, SHARE_BUTTON_CSS

    d = APP_DEFAULTS[model_kind]
    default_res = resolution or d["resolution"]

    def generate(text_input, negative_prompt, seed, steps, guidance_weight,
                 color_guidance_weight, inject_selfattn, inject_background,
                 segment_threshold, num_segments, encoder_reuse=1,
                 guidance_downsample=1, ref_precompute=True):
        request = (text_input, negative_prompt, seed, steps,
                   guidance_weight, color_guidance_weight, inject_selfattn,
                   inject_background, segment_threshold, num_segments,
                   encoder_reuse, guidance_downsample, ref_precompute)
        if model.mesh is not None:
            send_request(request)
        return run_generate(model, default_res, *request,
                            error_cls=gr.Error)

    with open(os.path.join(os.path.dirname(__file__), "editor.html"),
              encoding="utf-8") as fp:
        editor_html = fp.read()
    if hasattr(gr.utils, "sanitize_html"):
        editor_html = gr.utils.sanitize_html(editor_html)

    with gr.Blocks(css=SHARE_BUTTON_CSS) as demo:
        gr.HTML(f'<iframe srcdoc="{editor_html}" '
                'style="width:100%;height:260px;border:none;"></iframe>')
        text_input = gr.Textbox(visible=False)
        negative = gr.Textbox(label="negative prompt", value="")
        with gr.Row():
            seed = gr.Slider(0, 100000, value=d["seed"], step=1, label="seed")
            steps = gr.Slider(10, 100, value=d["steps"], step=1, label="steps")
            guidance = gr.Slider(1, 20, value=d["guidance_weight"],
                                 label="guidance weight")
        with gr.Row():
            colorw = gr.Slider(0, 2, value=d["color_guidance_weight"],
                               label="color guidance weight")
            inj_s = gr.Slider(0, 1, value=d["inject_selfattn"],
                              label="inject self-attention")
            inj_b = gr.Slider(0, 1, value=d["inject_background"],
                              label="inject background")
        with gr.Row():
            # SDXL's default threshold is 0.55, SD's and AnimeXL's 0.25
            seg_t = gr.Slider(0, 1, value=d["segment_threshold"],
                              label="segment threshold")
            num_seg = gr.Slider(2, 20, value=d["num_segments"], step=1,
                                label="num segments")
            turbo = gr.Slider(
                1, 4, value=1, step=1, label="turbo (encoder reuse)",
                info="1 = exact; N>1 recomputes the UNet encoder every Nth "
                     "step (Faster Diffusion) — faster, approximate")
            guid_ds = gr.Slider(
                1, 4, value=1, step=1, label="guidance downsample",
                info="1 = exact; d>1 computes the color-guidance gradient "
                     "at 1/d resolution — faster, approximate")
            refpre = gr.Checkbox(
                value=True, label="refer precompute",
                info="capture the refer trajectory in the plain pass "
                     "(output-exact, faster); untick to run the in-batch "
                     "flow (--no_ref_precompute)")
        btn = gr.Button("Generate")
        with gr.Row(elem_id="outputs"):
            outs = [gr.Image(label=n) for n in
                    ("plain", "rich", "segmentation", "token maps")]
        share = gr.Button("Share to community", elem_id="share-btn")
        share.click(None, [], [], js=COMMUNITY_JS)
        inputs = [text_input, negative, seed, steps, guidance, colorw,
                  inj_s, inj_b, seg_t, num_seg]
        # the turbo knobs and the refer-precompute switch ride only the
        # live button; the example rows keep the ten reference knobs
        btn.click(generate, inputs=inputs + [turbo, guid_ds, refpre],
                  outputs=outs, js=GET_JS_DATA)
        for suite, rows in example_rows(model_kind).items():
            gr.Examples(
                examples=rows, label=suite, inputs=inputs, outputs=outs,
                fn=generate,
                # cached on first view where real weights exist
                cache_examples="lazy" if checkpoint_dir is not None
                else False)
    return demo


def make_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="SD", choices=["SD", "SDXL", "AnimeXL"])
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--random_weights", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--mesh", default=None,
                   help="device mesh, one process per device (torchrun): "
                        "'auto', N, dp,tp or dcn,dp,tp")
    return p


def main(argv=None):
    import torch.distributed as dist

    from ..parallel.mesh import world_scope
    from .examples import APP_DEFAULTS
    from .sample import build_model

    a = make_parser().parse_args(argv)
    with world_scope():
        model = build_model(argparse.Namespace(
            model=a.model, checkpoint_dir=a.checkpoint_dir,
            random_weights=a.random_weights, device=a.device, scheduler=None,
            bf16_vae=False, mesh=a.mesh))
        if model.mesh is not None and dist.get_rank() != 0:
            follow_requests(model, APP_DEFAULTS[a.model]["resolution"],
                            os.path.join("results", "gradio_vis",
                                         f"rank{dist.get_rank()}"))
            return
        try:
            app = build_app(a.model, a.checkpoint_dir, a.random_weights,
                            model=model)
            app.queue(max_size=4).launch(server_port=a.port)
        finally:
            if model.mesh is not None:
                send_request(None)


if __name__ == "__main__":
    main()
