"""RegionDiffusion — the SD-1.5 rich-text pipeline in PyTorch.

Counterpart of ``rich_text_to_image_tpu/pipelines/region_sd.py``. Each JAX
``lax.scan`` is a Python loop here:

  * ``produce_attn_maps`` — the plain CFG pass with attention capture: the
    cond row's head-averaged self-attention at the 32^2 registry layers (at
    the last step only: the reference keeps only the last step's self maps)
    and cross-attention sums from ``agg_start_step`` on; on request it also
    keeps the refer cache (the latent trajectory and the injection steps'
    (Q, K) and resnet feature);
  * ``prompt_to_img`` / ``produce_latents`` — the rich pass: one batched
    [uncond, spans..., base] UNet forward per step, noise composited under
    the token masks, font-size reweighting on the base row, and colour
    guidance through the gradient of the VAE decode
    (``torch.autograd.grad``);
  * the batched evaluation paths: ``text_to_images`` (N prompts in one
    CFG loop of 2N rows), ``color_bench_batch`` (K colour items sharing the
    reference rows: 2+3K rows a step, 3K once the reference is no longer
    read) and ``style_bench_batch`` (K style items of R+2 rows each).

Self-attention and background injection run the refer-precompute flow when
the plain pass left a cache that fits the request, else the in-batch flow
(the reference trajectory denoised beside the rich one). The turbo knobs of
the JAX package are here: encoder reuse, a pooled and a bfloat16 guidance
decode. Any scheduler of ``schedulers/`` runs the plain pass; the rich pass
refuses Euler's float timesteps, as the JAX package fails on them.

Precision policy (the JAX package's, docs/ARCHITECTURE.md): a bfloat16 UNet
with float32 softmax statistics, a float32 VAE and CLIP text encoder, and
float32 scheduler state.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import config as cfgs
from ..models.clip import CLIPTextModel
from ..models.tokenizer import CLIPTokenizer
from ..models.unet import (INJECT_RESNET_NAME, CaptureSpec,
                           UNet2DCondition, UNetControls)
from ..models.vae import AutoencoderKL
from ..ops.attention import make_token_weight_vectors
from ..schedulers.pndm import PNDMScheduler
from ..utils import tracing
from ..utils.registries import (CrossAttentionLayers, SelfAttentionLayers,
                                attn_layer_resolutions)
from ..utils.token_maps import SEG_RESOLUTION, AttnAggregates
from .. import weights
from .base import (REF_PRECOMPUTE_MAX_BYTES, MeshMixin, encoder_key_gates,
                   ref_cache_matches, ref_fingerprint, ref_qk_bytes_per_slot)

# the reference rows' capture of the in-batch flow with encoder reuse
CAPTURE_REF = CaptureSpec(qk=True, resnet=frozenset({INJECT_RESNET_NAME}))


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


def draw_latents(shape, seed: int, device) -> torch.Tensor:
    """Standard-normal float32 latents of ``shape`` from a
    ``torch.Generator`` of ``device`` seeded with ``seed``: the draw of every
    path that is given no latent. Not the JAX package's numbers for the
    seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, device=device)


def composite_noise(masks, g: float, eps_uncond, eps_base, eps_spans):
    """Classifier-free guidance under the region masks
    (region_diffusion.py:119-128): the unconditional prediction wherever a
    mask reaches, each span's prediction under its mask and the base
    prompt's under the last (the background). ``masks`` [R+1, h, w, 1];
    ``eps_uncond``, ``eps_base`` [K, h, w, 4]; ``eps_spans`` [K, R, h, w,
    4], one row of K per item."""
    noise_uncond = eps_uncond * masks.sum(0)
    noise_text = eps_base * masks[-1]
    if eps_spans.shape[1]:
        noise_text = noise_text + (eps_spans * masks[:-1]).sum(1)
    return noise_uncond + g * (noise_text - noise_uncond)


@dataclasses.dataclass
class RichControlSpec:
    """Host-side rich-pass knobs."""

    guidance_scale: float = 7.5
    inject_selfattn: float = 0.0
    inject_background: float = 0.0
    use_guidance: bool = False
    guidance_start_step: int = 999
    color_guidance_weight: float = 1.0
    # turbo knobs, off by default (the exact reference math): encoder reuse
    # ("Faster Diffusion", arXiv 2312.09608) runs the UNet's down path on
    # key steps only, placed by ``encoder_schedule`` ("early" or
    # "uniform"); the colour guidance's decode in bfloat16, or at 1/d of
    # the size (the x0 latent and the pixel masks pooled by d)
    encoder_reuse: int = 1
    encoder_schedule: str = "early"
    bf16_guidance: bool = False
    guidance_downsample: int = 1


class RegionDiffusion(MeshMixin):
    """SD-1.5 rich-text-to-image pipeline."""

    ref_precompute_max_bytes = REF_PRECOMPUTE_MAX_BYTES

    def __init__(self, unet: UNet2DCondition, vae: AutoencoderKL,
                 text_encoder: CLIPTextModel, tokenizer: CLIPTokenizer,
                 unet_cfg: cfgs.UNetConfig = cfgs.SD15_UNET,
                 vae_cfg: cfgs.VAEConfig = cfgs.SD15_VAE,
                 agg_start_step: int = 10,  # reference: n_maps > 10
                 scheduler=None,
                 device="cuda", mesh=None):
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
        self.ref_cache: Optional[dict] = None  # set by produce_attn_maps
        self._vae_bf16: Optional[AutoencoderKL] = None
        self.use_mesh(mesh)

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
        """[uncond, prompt_1..N] embeddings [N+1, 77, D] float32.

        Each prompt is encoded in a call of its own, so that its row does
        not depend on the other prompts: the card's matrix products pick
        their kernels by the batch, and the refer cache's fingerprint
        compares the uncond and base rows of the plain pass (batch 2) with
        the rich pass's (batch R+2)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if isinstance(negative_prompts, str):
            negative_prompts = [negative_prompts]
        with tracing.span("text_encode"):
            ids = self.tokenizer(list(negative_prompts) + list(prompts))
            ids = torch.from_numpy(ids.astype(np.int64)).to(self.device)
            return torch.cat([self.text_encoder(row[None])["last_hidden_state"]
                              for row in ids], dim=0)

    # ------------------------------------------------------------ VAE utils
    def _decode_imgs(self, latents: torch.Tensor,
                     vae: Optional[AutoencoderKL] = None) -> torch.Tensor:
        """Images in [0, 1], NHWC, at the dtype of ``vae`` (the pipeline's
        float32 VAE by default)."""
        vae = vae if vae is not None else self.vae
        z = latents.float() / self.vae_cfg.scaling_factor
        imgs = vae.decode(z.to(vae.decoder.conv_in.weight.dtype))
        return (imgs / 2 + 0.5).clamp(0.0, 1.0)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """latents [B,h,w,4] -> uint8 images [B,H,W,3]."""
        with tracing.span("decode", device=True):
            imgs = self._decode_imgs(latents)
            return (imgs * 255).round().to(torch.uint8).cpu().numpy()

    @torch.no_grad()
    def encode_imgs(self, imgs, seed: int = 0) -> torch.Tensor:
        """Images in [0, 1], NHWC -> the *scaled* latent sample [B,h,w,4]
        float32 on the pipeline's device, drawn through the VAE encoder
        with a ``torch.Generator`` of the device seeded with ``seed`` (not
        the JAX package's numbers for the seed)."""
        x = torch.as_tensor(imgs, dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return self.vae.encode(x * 2 - 1, gen)

    def _init_latents(self, latents, h: int, w: int, seed: int,
                      batch: int = 1):
        if latents is None:
            latents = draw_latents((batch, h, w, self.unet_cfg.in_channels),
                                   seed, self.device)
        return torch.as_tensor(latents, dtype=torch.float32,
                               device=self.device)

    # ------------------------------------------------------- capture layout
    def _capture_layout(self, latent_hw):
        """(segmentation resolution, the attn1 layers captured at it,
        {resolution: attn2 layers}); resolutions count rows of the latent
        grid, and a level's width follows the latent's aspect.

        The segmentation runs at the reference's 32 rows where the UNet has
        a level there (latents of 64 or 128 rows), as in the JAX package.
        Where it has none (96 rows: levels at 96, 48, 24, 12) the JAX rule
        names no layer and its self-attention sum stays zero; here the next
        finer level is taken (48 rows), so that other sizes segment too."""
        res_map = attn_layer_resolutions(self.unet_cfg, latent_hw)
        want = min(SEG_RESOLUTION, latent_hw[0] // 2)
        levels = sorted(set(res_map.get(n) for n in SelfAttentionLayers)
                        - {None})
        seg_res = next((r for r in levels if r >= want), want)
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
    def _ref_qk_bytes_per_slot(self, latent_hw) -> int:
        """Bytes of one refer-cache slot at this latent size (shapes only)."""
        return ref_qk_bytes_per_slot(self.unet, latent_hw)

    def produce_attn_maps(self, prompts, negative_prompts="",
                          height: int = 512, width: int = 512,
                          num_inference_steps: int = 50,
                          guidance_scale: float = 7.5, latents=None,
                          seed: int = 0, ref_capture_steps=None):
        """Plain CFG pass; returns (images uint8, AttnAggregates).

        ``ref_capture_steps`` (step indices, may be empty): also keep the
        refer cache as ``self.ref_cache``: the latent before every step and
        the final one, and at each listed step the cond row's (Q, K) of
        every self-attention layer and its :data:`INJECT_RESNET_NAME`
        feature. The rich pass of the same seed, base prompt, guidance and
        steps then injects from it instead of denoising the reference
        trajectory beside its own. The capture is skipped (``ref_cache``
        None) where its slots would take more than
        ``ref_precompute_max_bytes``."""
        if not isinstance(prompts, str):
            prompts = list(prompts)
            if len(prompts) != 1:
                raise ValueError("produce_attn_maps takes exactly one prompt "
                                 f"(the aggregates are per prompt); got "
                                 f"{len(prompts)}")
        embeds = self.get_text_embeds(prompts, negative_prompts)
        h, w = height // self.vae_scale_factor, width // self.vae_scale_factor
        plan = self.scheduler.plan(num_inference_steps)
        lat = self._init_latents(latents, h, w, seed) * getattr(
            plan, "init_noise_sigma", 1.0)
        slots = (tuple(int(s) for s in ref_capture_steps)
                 if ref_capture_steps is not None else None)
        if slots and (self._ref_qk_bytes_per_slot((h, w)) * len(slots)
                      > self.ref_precompute_max_bytes):
            slots = None  # the rich pass then runs the in-batch flow
        # drop the last run's cache before this one fills a new one
        self.ref_cache = None
        cache = {} if slots is not None else None
        with tracing.span("plain_loop", flow="refpre" if slots else "plain",
                          **{"pass": "plain"}):
            lat_end, self_sum, cross_sums, self_layers, cross_by_res = (
                self._plain_loop(lat, embeds, num_inference_steps,
                                 float(guidance_scale), ref_slots=slots,
                                 ref_cache=cache))
        if cache is not None:
            cache.update(steps=slots, g=float(guidance_scale), hw=(h, w),
                         fp=ref_fingerprint(lat, embeds[0], embeds[-1]))
            self.ref_cache = cache
        with tracing.span("capture_sums"):
            cross_sums = {r: c.cpu().numpy() for r, c in cross_sums.items()}
        agg = AttnAggregates(
            self_sum=self_sum,
            self_count=len(self_layers),
            cross_sums=cross_sums,
            cross_layer_count=sum(len(v) for v in cross_by_res.values()),
        )
        self.attn_aggregates = agg
        return self.decode_latents(lat_end), agg

    @torch.no_grad()
    def _plain_loop(self, lat, embeds, num_inference_steps: int, g: float,
                    ref_slots: Optional[tuple] = None,
                    ref_cache: Optional[dict] = None):
        """The plain CFG loop from the (already sigma-scaled) latent ``lat``.
        With ``ref_slots`` it fills ``ref_cache`` with ``traj`` [S+1, h, w,
        4] float32, ``qk`` {attn1 layer: (Q, K) [slots, S, C]} and
        ``resnet`` {name: [slots, h', w', C']}, (Q, K) in the merged-head
        layout that ``UNetControls.inject_qk`` takes; every entry is a copy
        of the cond row."""
        h, w = lat.shape[1], lat.shape[2]
        sched = self.scheduler
        plan = sched.plan(num_inference_steps)
        S = plan.num_steps
        seg_res, self_layers, cross_by_res = self._capture_layout((h, w))
        cross_names = frozenset(n for ns in cross_by_res.values() for n in ns)
        capture_last = CaptureSpec(self_probs=frozenset(self_layers),
                                   cross_probs=cross_names)
        capture_cross = CaptureSpec(cross_probs=cross_names)
        slot_of = {s: j for j, s in enumerate(ref_slots or ())}
        if ref_slots is not None:
            traj = torch.empty((S + 1, *lat.shape[1:]), dtype=torch.float32,
                               device=lat.device)
            ref_cache.update(traj=traj, qk={}, resnet={})

        def tokens(r):  # of a level with r rows, at the latent's aspect
            return r * (r * w // h)

        self_sum = torch.zeros((tokens(seg_res), tokens(seg_res)),
                               dtype=torch.float32, device=self.device)
        cross = {r: torch.zeros((tokens(r), 77), dtype=torch.float32,
                                device=self.device)
                 for r in sorted(cross_by_res)}
        st = sched.init_state(lat.shape, self.device)
        for i in range(S):
            if ref_slots is not None:
                traj[i].copy_(lat[0])
            x = sched.scale_model_input(plan, i, torch.cat([lat, lat], dim=0))
            last, agg = i == S - 1, i >= self.agg_start_step
            # the reference keeps only the last step's self maps; cross
            # maps accumulate from agg_start_step on
            spec = capture_last if last else (
                capture_cross if agg else CaptureSpec())
            if i in slot_of:
                spec = dataclasses.replace(
                    spec, qk=True, resnet=frozenset({INJECT_RESNET_NAME}))
            eps, aux = self._unet_call(x, plan.timesteps[i], embeds,
                                       capture=spec)
            if last and self_layers:
                self_sum = sum(aux["self_probs"][n][1].float()
                               for n in self_layers)
            if agg:
                for r, ns in cross_by_res.items():
                    cross[r] += sum(aux["cross_probs"][n][1].float()
                                    for n in ns)
            if i in slot_of:
                self._store_slot(ref_cache, len(slot_of), slot_of[i], aux)
            eps = eps.float()
            e = eps[0:1] + g * (eps[1:2] - eps[0:1])
            lat, st = sched.step(plan, i, st, e, lat)
        if ref_slots is not None:
            traj[S].copy_(lat[0])
        return lat, self_sum, cross, self_layers, cross_by_res

    @staticmethod
    def _store_slot(cache: dict, n_slots: int, j: int, aux: dict) -> None:
        """Copy the cond row's (Q, K) [H,S,hd] -> [S, H*hd] and resnet
        feature into slot ``j``; the buffers are made at the first slot."""
        for n, (q, k) in aux["self_qk"].items():
            pair = [t[1].transpose(0, 1).reshape(t.shape[2], -1)
                    for t in (q, k)]
            if n not in cache["qk"]:
                cache["qk"][n] = tuple(
                    torch.empty((n_slots, *p.shape), dtype=p.dtype,
                                device=p.device) for p in pair)
            for buf, p in zip(cache["qk"][n], pair):
                buf[j].copy_(p)
        for n, f in aux["resnet_hidden"].items():
            if n not in cache["resnet"]:
                cache["resnet"][n] = torch.empty(
                    (n_slots, *f.shape[1:]), dtype=f.dtype, device=f.device)
            cache["resnet"][n][j].copy_(f[1])

    # ------------------------------------------------------------- rich pass
    def prompt_to_img(self, prompts: Sequence[str], negative_prompts="",
                      height: int = 512, width: int = 512,
                      num_inference_steps: int = 50,
                      guidance_scale: float = 7.5, latents=None,
                      text_format_dict: Optional[dict] = None,
                      use_guidance: bool = False,
                      inject_selfattn: float = 0.0,
                      inject_background: float = 0.0,
                      seed: int = 0, encoder_reuse: int = 1,
                      encoder_schedule: str = "early",
                      bf16_guidance: bool = False,
                      guidance_downsample: int = 1,
                      ref_cache: Optional[dict] = None) -> np.ndarray:
        """Rich region-based sampling. ``prompts``: region prompts, base
        prompt last; ``self.masks`` holds len(prompts) masks from
        ``get_token_maps``. ``ref_cache``: the refer cache of a plain pass
        of the same seed, base prompt, guidance and steps
        (``produce_attn_maps(ref_capture_steps=...)``)."""
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
            encoder_reuse=int(encoder_reuse),
            encoder_schedule=encoder_schedule,
            bf16_guidance=bool(bf16_guidance),
            guidance_downsample=int(guidance_downsample),
        )
        embeds = self.get_text_embeds(list(prompts), negative_prompts)
        lat = self.produce_latents(
            embeds, height=height, width=width,
            num_inference_steps=num_inference_steps, latents=latents,
            spec=spec, text_format_dict=text_format_dict, seed=seed,
            ref_cache=ref_cache)
        return self.decode_latents(lat)

    def produce_latents(self, text_embeddings: torch.Tensor,
                        height: int = 512, width: int = 512,
                        num_inference_steps: int = 50, latents=None,
                        spec: RichControlSpec = RichControlSpec(),
                        text_format_dict: Optional[dict] = None,
                        seed: int = 0,
                        ref_cache: Optional[dict] = None) -> torch.Tensor:
        """The rich loop on [uncond, spans..., base] embeddings; returns the
        final latent [1, h, w, 4] float32.

        With ``inject_selfattn`` or ``inject_background`` above 0 the span
        rows take the reference trajectory's (the plain CFG denoising of
        the base prompt from the same latent) (Q, K) at every
        self-attention and its feature at the injected resnet while the
        step's timestep is above ``(1 - inject_selfattn) * 1000``, and at
        step ``int(inject_background * S)`` the background region of the
        latent is replaced by the reference's. Three flows give that:

          * refer-precompute, when ``ref_cache`` matches this run
            (``ref_cache_matches``): one forward of R+2 rows a step, the
            stored (Q, K)/resnet of the step's slot going into rows 1..R;
          * in-batch: the reference trajectory is denoised beside the rich
            one, in one forward of [uncond, base, ref_u, ref_c, spans...]
            (R+4 rows) where the span rows take row 3's (Q, K) and feature;
          * in-batch with encoder reuse: two forwards a step,
            [uncond, base, ref_u, ref_c] with the (Q, K)/resnet capture,
            then the R span rows with row 3's pair injected, each with its
            own encoder cache.

        ``encoder_reuse`` N > 1 runs the UNet's down path only on the key
        steps of ``encoder_key_gates`` and decodes the cached encoder
        output with the current time embedding between them.
        ``guidance_downsample`` d pools the x0 latent and the colour masks
        by d before the guidance decode (d = 1 where it does not divide the
        sizes); ``bf16_guidance`` runs that decode and its gradient through
        a bfloat16 copy of the VAE."""
        fmt = dict(text_format_dict or {})
        dev = self.device
        h, w = height // self.vae_scale_factor, width // self.vae_scale_factor
        n_styles = text_embeddings.shape[0] - 1
        if n_styles != len(self.masks):
            raise ValueError(f"{n_styles} region prompts but "
                             f"{len(self.masks)} masks")
        R = n_styles - 1  # span regions (masks[:-1])
        sched = self.scheduler
        plan = sched.plan(num_inference_steps)
        if not np.issubdtype(plan.timesteps.dtype, np.integer):
            raise ValueError(
                f"{type(sched).__name__}: the rich pass indexes "
                "alphas_cumprod with the plan's timesteps, which are not "
                "integers here; the JAX package's produce_latents raises "
                "IndexError there (rich_text_to_image_tpu/pipelines/"
                "region_sd.py:772), and the port refuses the same request")
        lat = self._init_latents(latents, h, w, seed) * getattr(
            plan, "init_noise_sigma", 1.0)
        S = plan.num_steps
        # per-step host gates (region_diffusion.py:104-105)
        inject_gates = plan.timesteps.astype(np.float64) > (
            (1 - spec.inject_selfattn) * 1000)
        bg_step = int(spec.inject_background * S)
        run_reference = spec.inject_selfattn > 0 or spec.inject_background > 0
        guidance_gates = ((plan.timesteps.astype(np.int64)
                           < spec.guidance_start_step) & spec.use_guidance)
        alpha_raw = sched.alphas_cumprod[plan.timesteps].astype(np.float32)
        stride = max(int(spec.encoder_reuse), 1)
        key_steps = encoder_key_gates(S, stride, spec.encoder_schedule)
        enc_cache = {} if stride > 1 else None

        flow = "plain"
        if run_reference:
            flow = "in_batch_two" if stride > 1 else "in_batch"
            if ref_cache is not None:
                want = tuple(np.nonzero(inject_gates)[0].tolist())
                fp = ref_fingerprint(lat, text_embeddings[0],
                                     text_embeddings[-1])
                if ref_cache_matches(ref_cache, want, S, spec.guidance_scale,
                                     (h, w), fp):
                    flow = "refpre"
                    slot_of = {s: j for j, s in enumerate(want)}

        # font-size reweighting on the base row only (the reference
        # registers its font-size hooks around the base-prompt forward)
        tw, ts = make_token_weight_vectors(fmt.get("word_pos"),
                                           fmt.get("font_size"))

        def weight_rows(n, base):
            if tw is None:
                return None, None
            rows = [torch.ones((n, 77), dtype=torch.float32, device=dev)
                    for _ in range(2)]
            for r, v in zip(rows, (tw, ts)):
                r[base] = torch.from_numpy(v).to(dev)
            return rows

        emb = text_embeddings
        if flow == "in_batch":
            tw_rows, ts_rows = weight_rows(R + 4, 1)
            emb = torch.cat([emb[0:1], emb[-1:], emb[0:1], emb[-1:],
                             emb[1:1 + R]], dim=0)
        elif flow == "in_batch_two":
            tw_rows, ts_rows = weight_rows(4, 1)
            emb_a = torch.cat([emb[0:1], emb[-1:], emb[0:1], emb[-1:]], dim=0)
            emb_b = emb[1:1 + R]
        else:
            tw_rows, ts_rows = weight_rows(R + 2, R + 1)

        masks = self._region_masks(h, w)
        color = None
        if spec.use_guidance:
            color = self._color_inputs(fmt, height, width, h, w,
                                       spec.guidance_downsample,
                                       spec.bf16_guidance,
                                       spec.color_guidance_weight)
        g = float(spec.guidance_scale)
        lat_ref = lat if flow.startswith("in_batch") else None
        st = sched.init_state(
            (2 if lat_ref is not None else 1, *lat.shape[1:]), dev)
        with tracing.span("rich_loop", flow=flow, **{"pass": "rich"}):
            for i in range(S):
                t = plan.timesteps[i]
                gate, key = bool(inject_gates[i]), bool(key_steps[i])
                with torch.no_grad():
                    lat_in = sched.scale_model_input(plan, i, lat)
                    if lat_ref is not None:
                        ref_in = sched.scale_model_input(plan, i, lat_ref)
                    if flow == "in_batch":
                        x = torch.cat([lat_in, lat_in, ref_in, ref_in]
                                      + [lat_in] * R, dim=0)
                        controls = UNetControls(
                            token_weights=tw_rows, token_signs=ts_rows,
                            inject_gate=gate, inject_src=3,
                            inject_dst=(4, 4 + R))
                        eps_all, _ = self._unet_call(x, t, emb, controls)
                        eps_all = eps_all.float()
                        eps_uncond, eps_base = eps_all[0:1], eps_all[1:2]
                        eps_spans = eps_all[4:]
                    elif flow == "in_batch_two":
                        eps_all, aux = self._unet_call(
                            torch.cat([lat_in, lat_in, ref_in, ref_in],
                                      dim=0), t, emb_a,
                            UNetControls(token_weights=tw_rows,
                                         token_signs=ts_rows),
                            CAPTURE_REF, enc_cache=enc_cache, name="ref",
                            key=key)
                        eps_all = eps_all.float()
                        eps_uncond, eps_base = eps_all[0:1], eps_all[1:2]
                        eps_spans = eps_all[4:]
                        if R > 0:
                            controls = UNetControls(
                                inject_gate=gate,
                                inject_qk={n: (q[3:4], k[3:4]) for n, (q, k)
                                           in aux["self_qk"].items()},
                                inject_resnet={
                                    n: f[3:4] for n, f
                                    in aux["resnet_hidden"].items()})
                            eps_spans, _ = self._unet_call(
                                lat_in.repeat(R, 1, 1, 1), t, emb_b, controls,
                                enc_cache=enc_cache, name="spans", key=key)
                            eps_spans = eps_spans.float()
                    else:
                        controls = (UNetControls(token_weights=tw_rows,
                                                 token_signs=ts_rows)
                                    if tw_rows is not None else None)
                        if flow == "refpre" and gate:
                            j = slot_of[i]
                            controls = UNetControls(
                                token_weights=tw_rows, token_signs=ts_rows,
                                inject_gate=True,
                                inject_qk={
                                    n: (q[j:j + 1], k[j:j + 1])
                                    for n, (q, k) in ref_cache["qk"].items()},
                                inject_resnet={
                                    n: f[j:j + 1]
                                    for n, f in ref_cache["resnet"].items()},
                                inject_dst=(1, 1 + R))
                        eps_all, _ = self._unet_call(
                            torch.cat([lat_in] * (R + 2), dim=0), t, emb,
                            controls, enc_cache=enc_cache, name="rich",
                            key=key)
                        eps_all = eps_all.float()
                        eps_uncond = eps_all[0:1]
                        eps_spans = eps_all[1:1 + R]
                        eps_base = eps_all[R + 1:R + 2]
                    noise = composite_noise(masks, g, eps_uncond, eps_base,
                                            eps_spans[None])
                    if lat_ref is not None:
                        # both trajectories through one scheduler step
                        eps_ref = eps_all[2:3] + g * (eps_all[3:4]
                                                      - eps_all[2:3])
                        pair, st = sched.step(
                            plan, i, st, torch.cat([noise, eps_ref], dim=0),
                            torch.cat([lat, lat_ref], dim=0))
                        lat, lat_ref = pair[0:1], pair[1:2]
                    else:
                        lat, st = sched.step(plan, i, st, noise, lat)
                if guidance_gates[i]:
                    lat = self._guided(lat, noise, float(alpha_raw[i]),
                                       color)
                if spec.inject_background > 0 and i == bg_step:
                    # background injection (region_diffusion.py:171-173); the
                    # refer trajectory after step i is the stored latent i+1
                    src = (ref_cache["traj"][min(bg_step + 1, S)][None]
                           if flow == "refpre" else lat_ref)
                    bg = masks[-1][None]
                    lat = src * bg + lat * (1 - bg)
        return lat

    def _region_masks(self, h: int, w: int) -> torch.Tensor:
        """``self.masks`` (spans, then the background) on the device as
        [R+1, h, w, 1] float32."""
        return torch.from_numpy(np.stack(
            [np.asarray(m, np.float32).reshape(h, w) for m in self.masks]
        )).to(self.device)[..., None]

    def _guidance_vae(self, bf16: bool) -> AutoencoderKL:
        """The VAE of the guided decode: the pipeline's float32 one, or a
        bfloat16 copy of it, made once."""
        if not bf16:
            return self.vae
        if self._vae_bf16 is None:
            self._vae_bf16 = copy.deepcopy(self.vae).to(torch.bfloat16)
        return self._vae_bf16

    def _color_inputs(self, fmt: dict, height: int, width: int, h: int,
                      w: int, downsample: int, bf16: bool,
                      weight: float) -> dict:
        """The colour guidance's inputs on the device: the pixel masks
        (pooled by the downsample factor d, which falls back to 1 where it
        does not divide the sizes), target colours, the latent mask the
        gradient is applied under, the weight, d and the VAE to decode
        with."""
        dev = self.device
        d = max(int(downsample), 1)
        if h % d or w % d or height % d or width % d:
            d = 1  # non-divisible sizes: the exact path
        m = torch.from_numpy(np.stack(
            [np.asarray(a, np.float32).reshape(height, width)
             for a in fmt["color_obj_atten"]])).to(dev)
        if d > 1:
            n = m.shape[0]
            m = m.reshape(n, height // d, d, width // d, d).mean(dim=(2, 4))
        return dict(
            masks_px=m,
            target_rgb=torch.from_numpy(np.stack(
                [np.asarray(c, np.float32).reshape(3)
                 for c in fmt["target_RGB"]])).to(dev),
            all=torch.from_numpy(np.asarray(
                fmt["color_obj_atten_all"], np.float32).reshape(h, w)
            ).to(dev)[None, :, :, None],
            weight=float(weight), ds=d, vae=self._guidance_vae(bf16))

    def _color_loss(self, lat, noise, a: float, color: dict) -> torch.Tensor:
        """The reference's colour loss (region_diffusion.py:151-168): the
        squared distance of each colour span's mean RGB in the decoded x0
        prediction from its target, x100, summed; the x0 prediction pooled
        by ``color["ds"]`` first."""
        a32 = torch.tensor(a, dtype=torch.float32, device=lat.device)
        x0 = (lat - noise * torch.sqrt(1 - a32)) / torch.sqrt(a32)
        d = color["ds"]
        if d > 1:
            _, hh, ww, c = x0.shape
            x0 = x0.reshape(1, hh // d, d, ww // d, d, c).mean(dim=(2, 4))
        imgs = self._decode_imgs(x0, color["vae"]).float()
        m = color["masks_px"]
        num = torch.einsum("bhwc,nhw->nc", imgs, m)
        den = m.sum(dim=(1, 2))[:, None] + 1e-12
        per = ((num / den - color["target_rgb"]) ** 2).mean(dim=1) * 100.0
        return per.sum()

    def _guided(self, lat, noise, a: float, color: dict) -> torch.Tensor:
        """One colour-guided step: the latent moved against the gradient
        of the colour loss, under the colour spans' latent mask."""
        tracing.count("guided_steps")
        with tracing.span("guided_step", device=True):
            with torch.enable_grad():
                l = lat.detach().requires_grad_(True)
                with tracing.span("guided_forward"):
                    loss = self._color_loss(l, noise, a, color)
                with tracing.span("guided_backward"):
                    (grad,) = torch.autograd.grad(loss, l)
            return (lat - grad * color["weight"] * color["all"]).detach()

    # ------------------------------------------------ batched plain txt2img
    @torch.no_grad()
    def text_to_images(self, prompts: Sequence[str], negative_prompt: str = "",
                       height: int = 512, width: int = 512,
                       num_inference_steps: int = 50,
                       guidance_scale: float = 7.5, seed: int = 0,
                       encoder_reuse: int = 1,
                       encoder_schedule: str = "early") -> np.ndarray:
        """Throughput mode: N prompts in one CFG loop of 2N rows
        ([uncond x N, prompts]), no capture; ``encoder_reuse`` as in the
        rich pass. The N latents are one draw of ``draw_latents``.
        Returns uint8 images [N, H, W, 3]."""
        prompts = list(prompts)
        N = len(prompts)
        embeds = self.get_text_embeds(prompts, [negative_prompt])
        embeds = torch.cat([embeds[0:1].expand(N, -1, -1), embeds[1:]])
        h, w = height // self.vae_scale_factor, width // self.vae_scale_factor
        plan = self.scheduler.plan(num_inference_steps)
        lat = self._init_latents(None, h, w, seed, batch=N) * getattr(
            plan, "init_noise_sigma", 1.0)
        stride = max(int(encoder_reuse), 1)
        keys = encoder_key_gates(plan.num_steps, stride, encoder_schedule)
        enc_cache = {} if stride > 1 else None
        g = float(guidance_scale)
        st = self.scheduler.init_state(lat.shape, self.device)
        for i in range(plan.num_steps):
            x = self.scheduler.scale_model_input(plan, i,
                                                 torch.cat([lat, lat]))
            eps, _ = self._unet_call(x, plan.timesteps[i], embeds,
                                     enc_cache=enc_cache, name="batch",
                                     key=bool(keys[i]))
            eps = eps.float()
            e = eps[:N] + g * (eps[N:] - eps[:N])
            lat, st = self.scheduler.step(plan, i, st, e, lat)
        return self.decode_latents(lat)

    # ----------------------------------------------- batched colour bench
    def color_bench_batch(self, region_prompts: Sequence[str],
                          base_prompt: str, target_rgbs, region_mask_px,
                          height: int, width: int, num_inference_steps: int,
                          guidance_scale: float, seed: int = 0, latents=None,
                          inject_selfattn: float = 0.2,
                          inject_background: float = 0.3,
                          color_guidance_weight: float = 1.0,
                          guidance_start_step: int = 999,
                          bf16_guidance: bool = False,
                          guidance_downsample: int = 1) -> np.ndarray:
        """K colour-benchmark items in one loop. The reference trajectory
        never sees the region prompt, so within one (seed, prompt) it is
        the same for every colour: each step runs one forward of [ref_u,
        ref_c, uncond x K, base x K, region x K] (2+3K rows) in which the
        region rows take the ref_c row's (Q, K) and resnet feature in-batch
        (``UNetControls.inject_src``). Past the reference's last use (the
        last injection step and the background-injection step) its rows
        are dropped and ``ref`` and its scheduler state are frozen: one
        forward of 3K rows. The colour guidance runs per item at batch 1,
        each item's graph freed before the next. Per item this is the
        sequential ``prompt_to_img(use_guidance=True, inject_selfattn,
        inject_background)`` of [region, base].

        ``self.masks`` holds [region mask, background mask], shared by the
        K items. Returns uint8 images [K, H, W, 3]."""
        K = len(region_prompts)
        if len(self.masks) != 2:
            raise ValueError("the colour bench takes [region, background] "
                             f"masks, got {len(self.masks)}")
        dev = self.device
        h, w = height // self.vae_scale_factor, width // self.vae_scale_factor
        embeds = self.get_text_embeds(list(region_prompts) + [base_prompt],
                                      [""])  # [uncond, regions..., base]
        sched = self.scheduler
        plan = sched.plan(num_inference_steps)
        S = plan.num_steps
        ref = self._init_latents(latents, h, w, seed) * getattr(
            plan, "init_noise_sigma", 1.0)
        lat = ref.expand(K, -1, -1, -1).clone()
        inject_gates = plan.timesteps.astype(np.float64) > (
            (1 - inject_selfattn) * 1000)
        bg_step = int(inject_background * S)
        inject_steps = np.nonzero(inject_gates)[0]
        last_use = max(int(inject_steps[-1]) if len(inject_steps) else -1,
                       bg_step if inject_background > 0 else -1)
        guidance_gates = (plan.timesteps.astype(np.int64)
                          < guidance_start_step)
        alpha_raw = sched.alphas_cumprod[plan.timesteps].astype(np.float32)
        masks = self._region_masks(h, w)  # [region, background]
        rgbs = np.asarray(target_rgbs, np.float32).reshape(K, 3)
        color = self._color_inputs(
            {"color_obj_atten": [region_mask_px],
             "target_RGB": [rgbs[0]],
             "color_obj_atten_all": self.masks[0]},
            height, width, h, w, guidance_downsample, bf16_guidance,
            color_guidance_weight)
        uncond_e, base_e = embeds[0:1], embeds[-1:]
        em_items = torch.cat([uncond_e.expand(K, -1, -1),
                              base_e.expand(K, -1, -1), embeds[1:-1]])
        em_ref = torch.cat([uncond_e, base_e, em_items])
        g = float(guidance_scale)
        st = sched.init_state(lat.shape, dev)
        st_ref = sched.init_state(ref.shape, dev)
        for i in range(S):
            t = plan.timesteps[i]
            with torch.no_grad():
                lat_in = sched.scale_model_input(plan, i, lat)
                with_ref = i <= last_use
                if with_ref:
                    ref_in = sched.scale_model_input(plan, i, ref)
                    eps, _ = self._unet_call(
                        torch.cat([ref_in, ref_in] + [lat_in] * 3), t,
                        em_ref, UNetControls(
                            inject_gate=bool(inject_gates[i]), inject_src=1,
                            inject_dst=(2 + 2 * K, 2 + 3 * K)))
                    eps = eps.float()
                    eps_ref = eps[0:1] + g * (eps[1:2] - eps[0:1])
                    eps = eps[2:]
                else:
                    eps, _ = self._unet_call(torch.cat([lat_in] * 3), t,
                                             em_items)
                    eps = eps.float()
                eps_uncond, eps_base, eps_reg = eps.split(K)
                noise = composite_noise(masks, g, eps_uncond, eps_base,
                                        eps_reg[:, None])
                lat, st = sched.step(plan, i, st, noise, lat)
                if with_ref:
                    # past the last use ref and st_ref stay frozen: they
                    # are never read again
                    ref, st_ref = sched.step(plan, i, st_ref, eps_ref, ref)
            if guidance_gates[i]:
                lat = torch.cat([
                    self._guided(lat[k:k + 1], noise[k:k + 1],
                                 float(alpha_raw[i]),
                                 dict(color, target_rgb=torch.from_numpy(
                                     rgbs[k:k + 1]).to(dev)))
                    for k in range(K)])
            if inject_background > 0 and i == bg_step:
                lat = ref * masks[1][None] + lat * (1 - masks[1][None])
        return self.decode_latents(lat)

    # ------------------------------------------------ batched style bench
    @torch.no_grad()
    def style_bench_batch(self, item_prompts: Sequence[Sequence[str]],
                          height: int, width: int, num_inference_steps: int,
                          guidance_scale: float, seed: int = 0,
                          latents=None) -> np.ndarray:
        """K style-benchmark items in one loop: each item's [uncond,
        spans..., base] rows (R+2) in one forward of K·(R+2) rows,
        items-major, under the shared ``self.masks`` and initial latent; no
        injection, no guidance. Per item this is the sequential
        ``prompt_to_img``. Returns uint8 images [K, H, W, 3]."""
        K = len(item_prompts)
        R = len(self.masks) - 1
        if any(len(p) != R + 1 for p in item_prompts):
            raise ValueError(f"each item takes {R + 1} prompts (spans, then "
                             "the base prompt)")
        dev = self.device
        h, w = height // self.vae_scale_factor, width // self.vae_scale_factor
        embeds = self.get_text_embeds(
            [p for item in item_prompts for p in item], [""])
        item_e = embeds[1:].reshape(K, R + 1, *embeds.shape[1:])
        e_flat = torch.cat([embeds[0][None, None].expand(K, 1, -1, -1),
                            item_e], dim=1).reshape(K * (R + 2),
                                                    *embeds.shape[1:])
        sched = self.scheduler
        plan = sched.plan(num_inference_steps)
        lat = (self._init_latents(latents, h, w, seed)
               * getattr(plan, "init_noise_sigma", 1.0)).expand(
                   K, -1, -1, -1).clone()
        masks = self._region_masks(h, w)
        g = float(guidance_scale)
        st = sched.init_state(lat.shape, dev)
        for i in range(plan.num_steps):
            lat_in = sched.scale_model_input(plan, i, lat)
            eps, _ = self._unet_call(lat_in.repeat_interleave(R + 2, dim=0),
                                     plan.timesteps[i], e_flat)
            eps = eps.float().reshape(K, R + 2, *lat.shape[1:])
            noise = composite_noise(masks, g, eps[:, 0], eps[:, -1],
                                    eps[:, 1:1 + R])
            lat, st = sched.step(plan, i, st, noise, lat)
        return self.decode_latents(lat)

    def predict_x0(self, x_t, eps_t, t: int):
        """The x0 prediction (x_t − sqrt(1 − ᾱ_t)·ε) / sqrt(ᾱ_t)."""
        a = float(self.scheduler.alphas_cumprod[int(t)])
        return (x_t - eps_t * np.sqrt(1 - a)) / np.sqrt(a)
