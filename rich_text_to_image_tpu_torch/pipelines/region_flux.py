"""RegionFlux — the rich-text pipeline on FLUX.1-dev.

The paper's two passes, with FLUX.1's transformer in the place of the UNet
(``cli/sample.run_sample`` drives it as it drives the SD pipelines):

  * text: T5-XXL's 512 rows (the maps' text positions) and CLIP-L's pooled
    row, each prompt encoded alone. No negative prompt and no CFG: the
    guidance is distilled into the transformer's guidance embedding.
  * plain pass, one row: from ``agg_start_step`` on, the 19 double blocks'
    joint attention runs through the capture kernels; the image queries'
    head-averaged probabilities are kept, image->image pooled 2x2 on both
    axes (the packed 64^2 grid to the 32^2 one the token maps segment at
    1024^2) into ``self_sum``, image->text (the joint softmax as it stands,
    not renormalised over the text) pooled on the query axis into the
    cross sums, both over every step and double block;
  * token maps as for SD, over the T5 positions (``first_token`` 0);
  * rich pass, R + 1 rows on one latent, in the order of the region
    prompts (the spans', then the base prompt's): each step the velocities
    are unpacked and blended under the token maps at the latent's size,
    then one flow step;
  * decode z / 0.3611 + 0.1159 with the float32 VAE.

Precision as FLUX.1-dev's model card runs it: the transformer and T5 in
bfloat16, CLIP-L and the VAE in float32, TF32 off. Colour guidance,
font-size weights, injection, encoder reuse, negative prompts and a mesh
are not on this path (the CLI refuses them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import weights
from ..models import config as cfgs
from ..models.clip import CLIPTextModel
from ..models.flux import FluxTransformer2DModel, JointCapture, pack, unpack
from ..models.t5 import T5ByteTokenizer, T5EncoderModel
from ..models.tokenizer import CLIPTokenizer
from ..models.vae import AutoencoderKL
from ..schedulers.flow_match import FlowMatchEulerScheduler
from ..utils import tracing
from ..utils.token_maps import AttnAggregates
from .region_sd import draw_latents, set_precision_policy


def _on_device(make, device, dtype, seed: int):
    """A module built on the meta device, allocated on ``device`` in
    ``dtype``, filled by ``weights.random_init_device``, and every RMS
    norm's weight set to one."""
    with torch.device("meta"):
        mod = make()
    mod = weights.random_init_device(mod.to(dtype=dtype).to_empty(
        device=device), seed)
    with torch.no_grad():
        for m in mod.modules():
            if type(m).__name__ in ("RMSNorm", "T5LayerNorm"):
                m.weight.fill_(1.0)
    return mod


class RegionFlux:
    """FLUX.1 rich-text-to-image pipeline. ``tokenizer`` is T5's (its
    positions are the maps' text positions), ``clip_tokenizer`` CLIP-L's."""

    def __init__(self, transformer: FluxTransformer2DModel,
                 vae: AutoencoderKL, text_encoder: CLIPTextModel,
                 text_encoder_2: T5EncoderModel,
                 tokenizer: Optional[T5ByteTokenizer] = None,
                 clip_tokenizer: Optional[CLIPTokenizer] = None,
                 vae_cfg: cfgs.VAEConfig = cfgs.FLUX_VAE,
                 agg_start_step: int = 10, scheduler=None, device="cuda",
                 mesh=None):
        if mesh is not None:
            raise ValueError("RegionFlux runs on one device (no --mesh)")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            set_precision_policy()
        self.transformer = transformer.to(self.device).eval().requires_grad_(
            False)
        self.vae = vae.to(self.device).eval().requires_grad_(False)
        self.text_encoder = text_encoder.to(self.device).eval(
        ).requires_grad_(False)
        self.text_encoder_2 = text_encoder_2.to(self.device).eval(
        ).requires_grad_(False)
        self.tokenizer = tokenizer or T5ByteTokenizer()
        self.clip_tokenizer = clip_tokenizer or CLIPTokenizer.byte_level()
        self.vae_cfg = vae_cfg
        self.vae_scale_factor = 2 ** (len(vae_cfg.block_out_channels) - 1)
        self.agg_start_step = agg_start_step
        self.scheduler = scheduler or FlowMatchEulerScheduler()
        self.masks = None
        self.attn_aggregates = None

    @classmethod
    def random_init(cls, seed: int = 0,
                    flux_cfg: cfgs.FluxConfig = cfgs.FLUX_DEV,
                    vae_cfg: cfgs.VAEConfig = cfgs.FLUX_VAE,
                    text_cfg: cfgs.CLIPTextConfig = cfgs.FLUX_CLIP,
                    t5_cfg: cfgs.T5EncoderConfig = cfgs.T5_XXL,
                    dtype=torch.bfloat16, device="cuda", **kw):
        """Random-weight pipeline drawn on ``device`` from seeded torch
        generators: the transformer and T5 in ``dtype``, CLIP-L and the VAE
        in float32."""
        dev, f32 = torch.device(device), torch.float32
        clip_tok = CLIPTokenizer.byte_level()
        if len(clip_tok.encoder) > text_cfg.vocab_size:
            text_cfg = dataclasses.replace(text_cfg,
                                           vocab_size=len(clip_tok.encoder))
        tr = _on_device(lambda: FluxTransformer2DModel(flux_cfg), dev, dtype,
                        seed)
        vae = _on_device(lambda: AutoencoderKL(vae_cfg), dev, f32, seed + 1)
        clip = _on_device(lambda: CLIPTextModel(text_cfg), dev, f32, seed + 2)
        t5 = _on_device(lambda: T5EncoderModel(t5_cfg), dev, dtype, seed + 3)
        with torch.no_grad():
            # T5's own initial scale for the queries, (d_model d_kv)^-1/2:
            # its scores are not divided by sqrt(d_kv)
            for blk in t5.encoder.block:
                blk.layer[0].SelfAttention.q.weight.mul_(t5_cfg.d_kv ** -0.5)
        return cls(tr, vae, clip, t5, T5ByteTokenizer(t5_cfg.max_length),
                   clip_tok, vae_cfg, device=device, **kw)

    # --------------------------------------------------------------- text
    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str]):
        """(T5 rows [N, T, 4096] in T5's dtype, CLIP-L pooled rows [N, 768]
        float32), each prompt encoded alone."""
        if isinstance(prompts, str):
            prompts = [prompts]
        dev = self.device
        rows, pooled = [], []
        with tracing.span("text_encode"):
            for p in prompts:
                ids = torch.from_numpy(self.clip_tokenizer([p]).astype(
                    np.int64)).to(dev)
                pooled.append(self.text_encoder(
                    ids, self.clip_tokenizer.eos_token_id)["pooled"])
                ids = torch.from_numpy(self.tokenizer([p])).to(dev)
                rows.append(self.text_encoder_2(ids))
        return torch.cat(rows), torch.cat(pooled)

    # ------------------------------------------------------------ latents
    def _init_latents(self, latents, h: int, w: int, seed: int):
        if latents is None:
            latents = draw_latents((1, h, w, self.vae_cfg.latent_channels),
                                   seed, self.device)
        return torch.as_tensor(latents, dtype=torch.float32,
                               device=self.device)

    def _sizes(self, height: int, width: int):
        f = self.vae_scale_factor
        if height % (4 * f) or width % (4 * f):
            raise ValueError(f"FLUX.1 takes sides in multiples of {4 * f} "
                             f"(2x2 patches pooled 2x2), got {height}x"
                             f"{width}")
        return height // f, width // f

    def _dit_call(self, lat, sigma, emb, pooled, guidance,
                  capture: Optional[JointCapture] = None):
        """The transformer on rows ``emb`` over one latent [1, h, w, 16]
        (broadcast to the rows) -> velocities [rows, h, w, 16] float32. The
        call is the span ``dit`` and counts in ``dit_calls`` by rows."""
        n, (h, w) = emb.shape[0], lat.shape[1:3]
        tracing.count("dit_calls", rows=n)
        if capture is not None:
            tracing.count("joint_capture",
                          layers=len(self.transformer.transformer_blocks))
        with tracing.span("dit", device=True, inherit=("pass",), rows=n):
            x = pack(lat).expand(n, -1, -1)
            v = self.transformer(x, sigma, emb, pooled, guidance,
                                 (h // 2, w // 2), capture)
            return unpack(v.float(), h, w)

    # ------------------------------------------------------------- decode
    def _decode_imgs(self, latents: torch.Tensor) -> torch.Tensor:
        """Images in [0, 1], NHWC float32, of latents [B, h, w, 16]."""
        imgs = self.vae.decode(self.vae.unscale(latents.float()))
        return (imgs / 2 + 0.5).clamp(0.0, 1.0)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        with tracing.span("decode", device=True):
            imgs = self._decode_imgs(latents)
            return (imgs * 255).round().to(torch.uint8).cpu().numpy()

    # --------------------------------------------------------- plain pass
    @staticmethod
    def _no_negative(negative_prompts):
        neg = ([negative_prompts] if isinstance(negative_prompts, str)
               else list(negative_prompts))
        if any(n for n in neg):
            raise ValueError("FLUX.1-dev has no negative prompt (its "
                             "guidance is distilled): pass ''")

    @torch.no_grad()
    def produce_attn_maps(self, prompts, negative_prompts="",
                          height: int = 1024, width: int = 1024,
                          num_inference_steps: int = 50,
                          guidance_scale: float = 3.5, latents=None,
                          seed: int = 0, ref_capture_steps=None):
        """The plain pass on one row; returns (images uint8,
        AttnAggregates)."""
        self._no_negative(negative_prompts)
        if ref_capture_steps:
            raise ValueError("RegionFlux keeps no refer cache")
        emb, pooled = self.encode_prompt(list(prompts)[:1])
        h, w = self._sizes(height, width)
        sched = self.scheduler
        plan = sched.plan(num_inference_steps, image_seq_len=(h // 2) * (w // 2))
        lat = self._init_latents(latents, h, w, seed)
        cap = JointCapture(emb.shape[1], (h // 2, w // 2), self.device)
        st = sched.init_state(lat.shape, self.device)
        g = float(guidance_scale)
        with tracing.span("plain_loop", flow="plain", **{"pass": "plain"}):
            for i in range(plan.num_steps):
                v = self._dit_call(lat, plan.sigmas[i], emb, pooled, g,
                                   cap if i >= self.agg_start_step else None)
                lat, st = sched.step(plan, i, st, v, lat)
        n_layers = len(self.transformer.transformer_blocks)
        with tracing.span("capture_sums"):
            cross = {cap.seg[0]: cap.cross_sum.cpu().numpy()}
        self.attn_aggregates = AttnAggregates(
            self_sum=cap.self_sum, self_count=n_layers, cross_sums=cross,
            cross_layer_count=n_layers, first_token=self.tokenizer.first_token)
        return self.decode_latents(lat), self.attn_aggregates

    # ---------------------------------------------------------- rich pass
    @torch.no_grad()
    def prompt_to_img(self, prompts: Sequence[str], negative_prompts="",
                      height: int = 1024, width: int = 1024,
                      num_inference_steps: int = 50,
                      guidance_scale: float = 3.5, latents=None,
                      text_format_dict: Optional[dict] = None,
                      use_guidance: bool = False,
                      inject_selfattn: float = 0.0,
                      inject_background: float = 0.0, seed: int = 0,
                      encoder_reuse: int = 1, encoder_schedule: str = "early",
                      bf16_guidance: bool = False,
                      guidance_downsample: int = 1,
                      ref_cache: Optional[dict] = None) -> np.ndarray:
        """The rich pass: ``prompts`` are the region prompts (base prompt
        last) with one mask each in ``self.masks``; one row each, on one
        latent, the velocities blended under the masks."""
        self._no_negative(negative_prompts)
        fmt = text_format_dict or {}
        if (use_guidance or inject_selfattn > 0 or inject_background > 0
                or encoder_reuse != 1 or ref_cache is not None
                or fmt.get("word_pos") is not None):
            raise ValueError("RegionFlux's rich pass takes no colour "
                             "guidance, font-size weights, injection or "
                             "encoder reuse")
        if self.masks is None or len(self.masks) != len(prompts):
            raise ValueError("one mask a region prompt is needed")
        emb, pooled = self.encode_prompt(list(prompts))
        h, w = self._sizes(height, width)
        sched = self.scheduler
        plan = sched.plan(num_inference_steps, image_seq_len=(h // 2) * (w // 2))
        lat = self._init_latents(latents, h, w, seed)
        masks = torch.from_numpy(np.stack([np.asarray(m, np.float32).reshape(
            h, w) for m in self.masks])).to(self.device)[..., None]
        st = sched.init_state(lat.shape, self.device)
        g = float(guidance_scale)
        with tracing.span("rich_loop", flow="rich", **{"pass": "rich"}):
            for i in range(plan.num_steps):
                v = self._dit_call(lat, plan.sigmas[i], emb, pooled, g)
                v = (v * masks).sum(0, keepdim=True)
                lat, st = sched.step(plan, i, st, v, lat)
        return self.decode_latents(lat)
