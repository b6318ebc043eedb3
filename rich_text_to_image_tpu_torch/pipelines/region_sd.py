"""RegionDiffusion — the SD-1.5 rich-text pipeline in PyTorch.

Counterpart of ``rich_text_to_image_tpu/pipelines/region_sd.py``. Each JAX
``lax.scan`` is a Python loop here:

  * ``produce_attn_maps`` — the plain CFG pass with attention capture: the
    cond row's head-averaged self-attention at the 32^2 registry layers (at
    the last step only: the reference keeps only the last step's self maps)
    and cross-attention sums from ``agg_start_step`` on;
  * ``prompt_to_img`` / ``produce_latents`` — the rich pass: one batched
    [uncond, spans..., base] UNet forward per step, noise composited under
    the token masks, font-size reweighting on the base row, and colour
    guidance through the gradient of the VAE decode
    (``torch.autograd.grad``).

Self-attention injection (``inject_selfattn``), background injection and the
turbo knobs of the JAX package are not ported yet and raise.

Precision policy (the JAX package's, docs/ARCHITECTURE.md): a bfloat16 UNet
with float32 softmax statistics, a float32 VAE and CLIP text encoder, and
float32 scheduler state.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import config as cfgs
from ..models.clip import CLIPTextModel
from ..models.tokenizer import CLIPTokenizer
from ..models.unet import CaptureSpec, UNet2DCondition, UNetControls
from ..models.vae import AutoencoderKL
from ..ops.attention import make_token_weight_vectors
from ..schedulers.pndm import PNDMScheduler
from ..utils.registries import (CrossAttentionLayers, SelfAttentionLayers,
                                attn_layer_resolutions)
from ..utils.token_maps import SEG_RESOLUTION, AttnAggregates
from .. import weights


def set_precision_policy() -> None:
    """Full float32 matrix products and convolutions on the card: TF32 off.

    The JAX package runs its float32 VAE decode at its "tensorfloat32"
    precision, which on a TPU is three bf16 passes and so close to float32
    (pipelines/base.py); the card's TF32 keeps a 10-bit mantissa, far
    coarser. The float32 parts (VAE, CLIP, colour-guidance gradient) are a
    small share of the run, so full float32 buys parity cheaply. The UNet
    runs in bfloat16 and is not affected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class RichControlSpec:
    """Host-side rich-pass knobs."""

    guidance_scale: float = 7.5
    inject_selfattn: float = 0.0
    inject_background: float = 0.0
    use_guidance: bool = False
    guidance_start_step: int = 999
    color_guidance_weight: float = 1.0

    def check_supported(self) -> None:
        if self.inject_selfattn > 0 or self.inject_background > 0:
            raise NotImplementedError(
                "inject_selfattn / inject_background > 0: the rich pass with "
                "a reference trajectory is not ported yet (ROADMAP.md, "
                "Queue 1)")


class RegionDiffusion:
    """SD-1.5 rich-text-to-image pipeline."""

    def __init__(self, unet: UNet2DCondition, vae: AutoencoderKL,
                 text_encoder: CLIPTextModel, tokenizer: CLIPTokenizer,
                 unet_cfg: cfgs.UNetConfig = cfgs.SD15_UNET,
                 vae_cfg: cfgs.VAEConfig = cfgs.SD15_VAE,
                 agg_start_step: int = 10,  # reference: n_maps > 10
                 scheduler: PNDMScheduler | None = None,
                 device="cuda"):
        set_precision_policy()
        self.device = torch.device(device)
        self.unet = unet.to(self.device).eval().requires_grad_(False)
        self.vae = vae.to(self.device).eval().requires_grad_(False)
        self.text_encoder = (text_encoder.to(self.device).eval()
                             .requires_grad_(False))
        self.tokenizer = tokenizer
        self.unet_cfg = unet_cfg
        self.vae_cfg = vae_cfg
        self.scheduler = scheduler if scheduler is not None else PNDMScheduler()
        self.agg_start_step = agg_start_step
        self.vae_scale_factor = 2 ** (len(vae_cfg.block_out_channels) - 1)
        self.masks: list[np.ndarray] = []  # [R+1] of [1, h, w]

    # ------------------------------------------------------------ factories
    @classmethod
    def random_init(cls, seed: int = 0,
                    unet_cfg: cfgs.UNetConfig = cfgs.SD15_UNET,
                    vae_cfg: cfgs.VAEConfig = cfgs.SD15_VAE,
                    text_cfg: cfgs.CLIPTextConfig = cfgs.SD15_TEXT,
                    tokenizer: CLIPTokenizer | None = None,
                    dtype=torch.bfloat16, device="cuda", **kw):
        """Random-weight pipeline (seeded numpy fan-in normals)."""
        tokenizer = tokenizer or CLIPTokenizer.byte_level()
        if tokenizer.encoder and len(tokenizer.encoder) > text_cfg.vocab_size:
            text_cfg = dataclasses.replace(
                text_cfg, vocab_size=len(tokenizer.encoder))
        unet = weights.random_init(UNet2DCondition(unet_cfg), seed).to(dtype)
        vae = weights.random_init(AutoencoderKL(vae_cfg), seed + 1)
        text = weights.random_init(CLIPTextModel(text_cfg), seed + 2)
        return cls(unet, vae, text, tokenizer, unet_cfg, vae_cfg,
                   device=device, **kw)

    @classmethod
    def from_pretrained(cls, checkpoint_dir: str, dtype=torch.bfloat16,
                        device="cuda", **kw):
        """Load a local diffusers-layout SD-1.5 directory (``unet/``,
        ``vae/``, ``text_encoder/`` safetensors and ``tokenizer/``)."""
        tokenizer = CLIPTokenizer.from_pretrained(
            os.path.join(checkpoint_dir, "tokenizer"))
        unet = UNet2DCondition(cfgs.SD15_UNET)
        vae = AutoencoderKL(cfgs.SD15_VAE)
        text = CLIPTextModel(cfgs.SD15_TEXT)
        for mod, sub in ((unet, "unet"), (vae, "vae"), (text, "text_encoder")):
            sd = weights.load_safetensors_dir(os.path.join(checkpoint_dir, sub))
            sd.pop("text_model.embeddings.position_ids", None)
            mod.load_state_dict(sd, strict=True)
        return cls(unet.to(dtype), vae, text, tokenizer, device=device, **kw)

    # ----------------------------------------------------------------- text
    @torch.no_grad()
    def get_text_embeds(self, prompts, negative_prompts="") -> torch.Tensor:
        """[uncond, prompt_1..N] embeddings [N+1, 77, D] float32."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if isinstance(negative_prompts, str):
            negative_prompts = [negative_prompts]
        ids = self.tokenizer(list(negative_prompts) + list(prompts))
        ids = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        return self.text_encoder(ids)["last_hidden_state"]

    # ------------------------------------------------------------ VAE utils
    def _decode_imgs(self, latents: torch.Tensor) -> torch.Tensor:
        imgs = self.vae.decode(latents.float() / self.vae_cfg.scaling_factor)
        return (imgs / 2 + 0.5).clamp(0.0, 1.0)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """latents [B,h,w,4] -> uint8 images [B,H,W,3]."""
        imgs = self._decode_imgs(latents)
        return (imgs * 255).round().to(torch.uint8).cpu().numpy()

    def _init_latents(self, latents, h: int, w: int, seed: int):
        if latents is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return torch.randn((1, h, w, self.unet_cfg.in_channels),
                               generator=gen, device=self.device)
        return torch.as_tensor(latents, dtype=torch.float32,
                               device=self.device)

    # ------------------------------------------------------- capture layout
    def _capture_layout(self, latent_hw):
        res_map = attn_layer_resolutions(self.unet_cfg, latent_hw)
        seg_res = min(SEG_RESOLUTION, latent_hw[0] // 2)
        self_layers = tuple(
            n for n in SelfAttentionLayers if res_map.get(n) == seg_res)
        cross_by_res: dict[int, tuple[str, ...]] = {}
        for n in CrossAttentionLayers:
            r = res_map.get(n)
            if r is not None:
                cross_by_res.setdefault(r, ())
                cross_by_res[r] += (n,)
        return seg_res, self_layers, cross_by_res

    # ------------------------------------------------------------ plain pass
    def produce_attn_maps(self, prompts, negative_prompts="",
                          height: int = 512, width: int = 512,
                          num_inference_steps: int = 50,
                          guidance_scale: float = 7.5, latents=None,
                          seed: int = 0):
        """Plain CFG pass; returns (images uint8, AttnAggregates)."""
        if not isinstance(prompts, str):
            prompts = list(prompts)
            if len(prompts) != 1:
                raise ValueError("produce_attn_maps takes exactly one prompt "
                                 f"(the aggregates are per prompt); got "
                                 f"{len(prompts)}")
        embeds = self.get_text_embeds(prompts, negative_prompts)
        h, w = height // self.vae_scale_factor, width // self.vae_scale_factor
        lat = self._init_latents(latents, h, w, seed)
        lat, self_sum, cross_sums, self_layers, cross_by_res = self._plain_loop(
            lat, embeds, num_inference_steps, float(guidance_scale))
        agg = AttnAggregates(
            self_sum=self_sum,
            self_count=len(self_layers),
            cross_sums={r: c.cpu().numpy() for r, c in cross_sums.items()},
            cross_layer_count=sum(len(v) for v in cross_by_res.values()),
        )
        self.attn_aggregates = agg
        return self.decode_latents(lat), agg

    @torch.no_grad()
    def _plain_loop(self, lat, embeds, num_inference_steps: int, g: float):
        h, w = lat.shape[1], lat.shape[2]
        sched = self.scheduler
        plan = sched.plan(num_inference_steps)
        S = plan.num_steps
        seg_res, self_layers, cross_by_res = self._capture_layout((h, w))
        cross_names = frozenset(n for ns in cross_by_res.values() for n in ns)
        capture_last = CaptureSpec(self_probs=frozenset(self_layers),
                                   cross_probs=cross_names)
        capture_cross = CaptureSpec(cross_probs=cross_names)
        self_sum = torch.zeros((seg_res ** 2, seg_res ** 2),
                               dtype=torch.float32, device=self.device)
        cross = {r: torch.zeros((r * r, 77), dtype=torch.float32,
                                device=self.device)
                 for r in sorted(cross_by_res)}
        st = sched.init_state(lat.shape, self.device)
        for i in range(S):
            t = int(plan.timesteps[i])
            x = torch.cat([lat, lat], dim=0)
            last, agg = i == S - 1, i >= self.agg_start_step
            # the reference keeps only the last step's self maps; cross
            # maps accumulate from agg_start_step on
            spec = capture_last if last else (
                capture_cross if agg else CaptureSpec())
            eps, aux = self.unet(x, t, embeds, capture=spec)
            if last and self_layers:
                self_sum = sum(aux["self_probs"][n][1].float()
                               for n in self_layers)
            if agg:
                for r, ns in cross_by_res.items():
                    cross[r] += sum(aux["cross_probs"][n][1].float()
                                    for n in ns)
            eps = eps.float()
            e = eps[0:1] + g * (eps[1:2] - eps[0:1])
            lat, st = sched.step(plan, i, st, e, lat)
        return lat, self_sum, cross, self_layers, cross_by_res

    # ------------------------------------------------------------- rich pass
    def prompt_to_img(self, prompts: Sequence[str], negative_prompts="",
                      height: int = 512, width: int = 512,
                      num_inference_steps: int = 50,
                      guidance_scale: float = 7.5, latents=None,
                      text_format_dict: Optional[dict] = None,
                      use_guidance: bool = False,
                      inject_selfattn: float = 0.0,
                      inject_background: float = 0.0,
                      seed: int = 0) -> np.ndarray:
        """Rich region-based sampling. ``prompts``: region prompts, base
        prompt last; ``self.masks`` holds len(prompts) masks from
        ``get_token_maps``."""
        text_format_dict = dict(text_format_dict or {})
        spec = RichControlSpec(
            guidance_scale=guidance_scale,
            inject_selfattn=inject_selfattn,
            inject_background=inject_background,
            use_guidance=use_guidance,
            guidance_start_step=text_format_dict.get("guidance_start_step",
                                                     999),
            color_guidance_weight=text_format_dict.get(
                "color_guidance_weight", 1.0),
        )
        spec.check_supported()
        embeds = self.get_text_embeds(list(prompts), negative_prompts)
        lat = self.produce_latents(
            embeds, height=height, width=width,
            num_inference_steps=num_inference_steps, latents=latents,
            spec=spec, text_format_dict=text_format_dict, seed=seed)
        return self.decode_latents(lat)

    def produce_latents(self, text_embeddings: torch.Tensor,
                        height: int = 512, width: int = 512,
                        num_inference_steps: int = 50, latents=None,
                        spec: RichControlSpec = RichControlSpec(),
                        text_format_dict: Optional[dict] = None,
                        seed: int = 0) -> torch.Tensor:
        """The rich loop on [uncond, spans..., base] embeddings; returns the
        final latent [1, h, w, 4] float32."""
        spec.check_supported()
        fmt = dict(text_format_dict or {})
        dev = self.device
        h, w = height // self.vae_scale_factor, width // self.vae_scale_factor
        n_styles = text_embeddings.shape[0] - 1
        if n_styles != len(self.masks):
            raise ValueError(f"{n_styles} region prompts but "
                             f"{len(self.masks)} masks")
        R = n_styles - 1  # span regions (masks[:-1])
        lat = self._init_latents(latents, h, w, seed)
        sched = self.scheduler
        plan = sched.plan(num_inference_steps)
        S = plan.num_steps
        guidance_gates = ((plan.timesteps.astype(np.int64)
                           < spec.guidance_start_step) & spec.use_guidance)
        alpha_raw = sched.alphas_cumprod[plan.timesteps].astype(np.float32)

        # font-size reweighting on the base row only (the reference
        # registers its font-size hooks around the base-prompt forward)
        tw, ts = make_token_weight_vectors(fmt.get("word_pos"),
                                           fmt.get("font_size"))
        controls = None
        if tw is not None:
            B = n_styles + 1
            tw_rows = torch.ones((B, 77), dtype=torch.float32, device=dev)
            ts_rows = torch.ones((B, 77), dtype=torch.float32, device=dev)
            tw_rows[B - 1] = torch.from_numpy(tw).to(dev)
            ts_rows[B - 1] = torch.from_numpy(ts).to(dev)
            controls = UNetControls(token_weights=tw_rows,
                                    token_signs=ts_rows)

        masks = torch.from_numpy(np.stack(
            [np.asarray(m, np.float32).reshape(h, w) for m in self.masks]
        )).to(dev)[..., None]  # [R+1, h, w, 1]
        mask_sum = masks.sum(0)
        color = None
        if spec.use_guidance:
            color = dict(
                masks_px=torch.from_numpy(np.stack(
                    [np.asarray(m, np.float32).reshape(height, width)
                     for m in fmt["color_obj_atten"]])).to(dev),
                target_rgb=torch.from_numpy(np.stack(
                    [np.asarray(c, np.float32).reshape(3)
                     for c in fmt["target_RGB"]])).to(dev),
                all=torch.from_numpy(np.asarray(
                    fmt["color_obj_atten_all"], np.float32).reshape(h, w)
                ).to(dev)[None, :, :, None],
                weight=float(spec.color_guidance_weight),
            )
        g = float(spec.guidance_scale)
        st = sched.init_state(lat.shape, dev)
        for i in range(S):
            t = int(plan.timesteps[i])
            with torch.no_grad():
                x = torch.cat([lat] * (R + 2), dim=0)
                eps_all, _ = self.unet(x, t, text_embeddings, controls)
                eps_all = eps_all.float()
                eps_uncond = eps_all[0:1]
                eps_spans = eps_all[1:1 + R]
                eps_base = eps_all[R + 1:R + 2]
                # composite under the masks (region_diffusion.py:119-128)
                noise_uncond = eps_uncond * mask_sum[None]
                noise_text = eps_base * masks[-1][None]
                if R > 0:
                    noise_text = noise_text + (eps_spans * masks[:-1]).sum(
                        0, keepdim=True)
                noise = noise_uncond + g * (noise_text - noise_uncond)
                lat, st = sched.step(plan, i, st, noise, lat)
            if guidance_gates[i]:
                lat = self._guided(lat, noise, float(alpha_raw[i]), color)
        return lat

    def _color_loss(self, lat, noise, a: float, color: dict) -> torch.Tensor:
        """The reference's colour loss (region_diffusion.py:151-168): the
        squared distance of each colour span's mean RGB in the decoded x0
        prediction from its target, x100, summed."""
        a32 = torch.tensor(a, dtype=torch.float32, device=lat.device)
        x0 = (lat - noise * torch.sqrt(1 - a32)) / torch.sqrt(a32)
        imgs = self._decode_imgs(x0)
        m = color["masks_px"]
        num = torch.einsum("bhwc,nhw->nc", imgs, m)
        den = m.sum(dim=(1, 2))[:, None] + 1e-12
        per = ((num / den - color["target_rgb"]) ** 2).mean(dim=1) * 100.0
        return per.sum()

    def _guided(self, lat, noise, a: float, color: dict) -> torch.Tensor:
        with torch.enable_grad():
            l = lat.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(
                self._color_loss(l, noise, a, color), l)
        return (lat - grad * color["weight"] * color["all"]).detach()
