"""RegionDiffusionXL — the SDXL / AnimeXL rich-text pipeline in PyTorch.

Counterpart of ``rich_text_to_image_tpu/pipelines/region_sdxl.py``. What
SDXL adds to the SD-1.5 pipeline (``region_sd.RegionDiffusion``, whose VAE,
colour guidance, refer-cache and encoder-reuse pieces it shares):

  * two CLIP text towers, their penultimate hidden states concatenated
    (2048 wide), the second tower's projected pooled row, and zero rows
    for an empty negative prompt (``force_zeros_for_empty_prompt``);
  * the UNet's text_time conditioning: every forward takes the pooled rows
    and the six time ids (original size, crop corner, target size);
  * Euler by default, with ``scale_model_input`` on every forward; the
    rich pass casts the float timesteps to int64 where it reads
    ``alphas_cumprod``, so it runs under Euler;
  * a float32 VAE (a bfloat16 copy with ``vae_dtype=torch.bfloat16``), the
    invisible watermark on every decoded image, and opt-in tiled or sliced
    decoding;
  * the plain pass captures ALL self-attention layers at the segmentation
    resolution and sums their maps over the steps from
    ``agg_start_step`` on (SD keeps the last step's);
  * the rich pass's gates (docs/PARITY.md): the refer trajectory steps
    while ``inject_selfattn > 0 or i < inject_background * S``, only up to
    its last use, and the in-batch flow drops its two refer rows past it;
    the background is composited at ``i == int(inject_background * S)``;
    font-size weights on the base row only.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import weights
from ..models import config as cfgs
from ..models.clip import CLIPTextModel
from ..models.tokenizer import CLIPTokenizer
from ..models.unet import (EMPTY_CAPTURE, INJECT_RESNET_NAME, CaptureSpec,
                           UNet2DCondition, UNetControls)
from ..models.vae import AutoencoderKL
from ..models.vae_tiling import sliced_decode, tiled_decode
from ..ops.attention import make_token_weight_vectors
from ..schedulers.euler import EulerDiscreteScheduler
from ..utils.registries import CrossAttentionLayers_XL, attn_layer_resolutions
from ..utils.token_maps import SEG_RESOLUTION, AttnAggregates
from ..utils.watermark import apply_watermark
from .base import encoder_key_gates, ref_cache_matches, ref_fingerprint
from .region_sd import (CAPTURE_REF, RegionDiffusion, RichControlSpec,
                        composite_noise)


def _on_device(make, device, dtype, seed: int):
    """A module built on the meta device, allocated on ``device`` in
    ``dtype`` and filled by ``weights.random_init_device``."""
    with torch.device("meta"):
        mod = make()
    mod = mod.to(dtype=dtype).to_empty(device=device)
    return weights.random_init_device(mod, seed)


class RegionDiffusionXL(RegionDiffusion):
    """SDXL rich-text-to-image pipeline (also AnimeXL checkpoints)."""

    def __init__(self, unet: UNet2DCondition, vae: AutoencoderKL,
                 text_encoder: CLIPTextModel, text_encoder_2: CLIPTextModel,
                 tokenizer: CLIPTokenizer, tokenizer_2: CLIPTokenizer,
                 unet_cfg: cfgs.UNetConfig = cfgs.SDXL_UNET,
                 vae_cfg: cfgs.VAEConfig = cfgs.SDXL_VAE,
                 agg_start_step: int = 10, scheduler=None,
                 vae_dtype=torch.float32, device="cuda"):
        super().__init__(
            unet, vae, text_encoder, tokenizer, unet_cfg, vae_cfg,
            agg_start_step=agg_start_step,
            scheduler=(scheduler if scheduler is not None
                       else EulerDiscreteScheduler()), device=device)
        self.text_encoder_2 = (text_encoder_2.to(self.device).eval()
                               .requires_grad_(False))
        self.tokenizer_2 = tokenizer_2
        # the VAE stays float32 (the colour guidance differentiates through
        # it); with vae_dtype bfloat16 the final decode takes a bf16 copy
        self.vae_dtype = vae_dtype
        self.watermark = True  # any falsy value opts out
        self._vae_tiling = False
        self._vae_slicing = False

    # ------------------------------------------------------------ factories
    @classmethod
    def random_init(cls, seed: int = 0,
                    unet_cfg: cfgs.UNetConfig = cfgs.SDXL_UNET,
                    vae_cfg: cfgs.VAEConfig = cfgs.SDXL_VAE,
                    text_cfg: cfgs.CLIPTextConfig = cfgs.SDXL_TEXT,
                    text2_cfg: cfgs.CLIPTextConfig = cfgs.SDXL_TEXT_2,
                    tokenizer: CLIPTokenizer | None = None,
                    dtype=torch.bfloat16, device="cuda", **kw):
        """Random-weight pipeline, drawn on ``device`` from seeded torch
        generators (``weights.random_init_device``): the UNet in ``dtype``,
        the VAE and both text towers in float32."""
        tokenizer = tokenizer or CLIPTokenizer.byte_level()
        tokenizer_2 = kw.pop("tokenizer_2", None) or tokenizer
        vocab = max(len(tokenizer.encoder), len(tokenizer_2.encoder))
        if vocab > text_cfg.vocab_size:
            text_cfg = dataclasses.replace(text_cfg, vocab_size=vocab)
        if vocab > text2_cfg.vocab_size:
            text2_cfg = dataclasses.replace(text2_cfg, vocab_size=vocab)
        # add_embedding takes [pooled row, six time embeddings]
        pooled = text2_cfg.projection_dim or text2_cfg.hidden_size
        unet_cfg = dataclasses.replace(
            unet_cfg, projection_class_embeddings_input_dim=(
                pooled + 6 * unet_cfg.addition_time_embed_dim))
        dev, f32 = torch.device(device), torch.float32
        unet = _on_device(lambda: UNet2DCondition(unet_cfg), dev, dtype, seed)
        vae = _on_device(lambda: AutoencoderKL(vae_cfg), dev, f32, seed + 1)
        text = _on_device(lambda: CLIPTextModel(text_cfg), dev, f32, seed + 2)
        text2 = _on_device(lambda: CLIPTextModel(text2_cfg), dev, f32,
                           seed + 3)
        return cls(unet, vae, text, text2, tokenizer, tokenizer_2, unet_cfg,
                   vae_cfg, device=device, **kw)

    @classmethod
    def from_pretrained(cls, checkpoint_dir: str, dtype=torch.bfloat16,
                        device="cuda", **kw):
        """Load a local diffusers-layout SDXL directory (``unet/``, ``vae/``,
        ``text_encoder/``, ``text_encoder_2/`` safetensors, ``tokenizer/``
        and ``tokenizer_2/``, whose pad token is ``"!"``)."""
        tok = CLIPTokenizer.from_pretrained(
            os.path.join(checkpoint_dir, "tokenizer"))
        tok2 = CLIPTokenizer.from_pretrained(
            os.path.join(checkpoint_dir, "tokenizer_2"), pad_token="!")
        mods = {"unet": UNet2DCondition(cfgs.SDXL_UNET),
                "vae": AutoencoderKL(cfgs.SDXL_VAE),
                "text_encoder": CLIPTextModel(cfgs.SDXL_TEXT),
                "text_encoder_2": CLIPTextModel(cfgs.SDXL_TEXT_2)}
        for sub, mod in mods.items():
            sd = weights.load_safetensors_dir(os.path.join(checkpoint_dir, sub))
            sd.pop("text_model.embeddings.position_ids", None)
            mod.load_state_dict(sd, strict=True)
        return cls(mods["unet"].to(dtype), mods["vae"], mods["text_encoder"],
                   mods["text_encoder_2"], tok, tok2, device=device, **kw)

    # ----------------------------------------------------------------- text
    @torch.no_grad()
    def _encode_one(self, prompt: str):
        rows = []
        for tok, enc in ((self.tokenizer, self.text_encoder),
                         (self.tokenizer_2, self.text_encoder_2)):
            ids = torch.from_numpy(tok([prompt]).astype(np.int64)).to(
                self.device)
            rows.append(enc(ids, eos_token_id=tok.eos_token_id))
        pooled = rows[1].get("projected", rows[1]["pooled"])
        return torch.cat([rows[0]["penultimate"], rows[1]["penultimate"]],
                         dim=-1), pooled

    @torch.no_grad()
    def encode_prompt(self, prompts, negative_prompt=""):
        """([uncond, prompts...] embeddings [N+1, 77, 2048], pooled rows
        [N+1, P]), float32. An empty negative prompt gives zero rows
        (``force_zeros_for_empty_prompt``). Each prompt is encoded in a call
        of its own, so that its rows do not depend on the batch (the refer
        cache's fingerprint compares the plain and rich passes' rows)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if isinstance(negative_prompt, (list, tuple)):
            negative_prompt = negative_prompt[0] if negative_prompt else ""
        rows = [self._encode_one(p) for p in prompts]
        if negative_prompt == "":  # SDXL's force_zeros_for_empty_prompt
            neg = tuple(torch.zeros_like(t) for t in rows[0])
        else:
            neg = self._encode_one(negative_prompt)
        rows = [neg] + rows
        return (torch.cat([e for e, _ in rows], dim=0),
                torch.cat([p for _, p in rows], dim=0))

    def _get_add_time_ids(self, original_size, crops_coords_top_left,
                          target_size) -> np.ndarray:
        return np.asarray([list(original_size) + list(crops_coords_top_left)
                           + list(target_size)], dtype=np.float32)

    def _time_ids(self, height: int, width: int) -> torch.Tensor:
        return torch.from_numpy(self._get_add_time_ids(
            (height, width), (0, 0), (height, width))).to(self.device)

    # ------------------------------------------------------------ VAE utils
    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """latents [B,h,w,4] -> watermarked uint8 images [B,H,W,3], whole,
        in tiles of 128 latent pixels (``enable_vae_tiling``) or a batch
        row at a time (``enable_vae_slicing``)."""
        vae = self._guidance_vae(self.vae_dtype == torch.bfloat16)

        def dec(z):
            return self._decode_imgs(z, vae).float()

        f = self.vae_scale_factor
        if self._vae_tiling:
            imgs = tiled_decode(dec, latents, tile_latent=1024 // f, scale=f)
        elif self._vae_slicing:
            imgs = sliced_decode(dec, latents)
        else:
            imgs = dec(latents)
        u8 = (imgs * 255).round().to(torch.uint8)
        if self.watermark:
            u8 = apply_watermark(u8)
        return u8.cpu().numpy()

    def enable_vae_tiling(self):
        self._vae_tiling = True

    def disable_vae_tiling(self):
        self._vae_tiling = False

    def enable_vae_slicing(self):
        self._vae_slicing = True

    def disable_vae_slicing(self):
        self._vae_slicing = False

    # ------------------------------------------------------- capture layout
    def _capture_layout(self, latent_hw):
        """(segmentation rows, ALL attn1 layers at them, {rows: the SDXL
        registry's attn2 layers}). As in the SD pipeline, a latent with no
        level at the reference's 32 rows takes the next finer level."""
        res_map = attn_layer_resolutions(self.unet_cfg, latent_hw)
        want = min(SEG_RESOLUTION, latent_hw[0] // 2)
        levels = sorted({r for n, r in res_map.items()
                         if n.endswith(".attn1")})
        seg_res = next((r for r in levels if r >= want), want)
        self_layers = tuple(n for n, r in sorted(res_map.items())
                            if n.endswith(".attn1") and r == seg_res)
        cross_by_res: dict[int, tuple[str, ...]] = {}
        for n in CrossAttentionLayers_XL:
            r = res_map.get(n)
            if r is not None:
                cross_by_res.setdefault(r, ())
                cross_by_res[r] += (n,)
        return seg_res, self_layers, cross_by_res

    # --------------------------------------------------------------- UNet
    def _fwd(self, x, t, emb, pooled, tid, controls=None,
             capture: CaptureSpec = EMPTY_CAPTURE, enc_cache=None,
             name: str = "", key: bool = True):
        """The UNet on rows ``x`` with their text rows ``emb`` and pooled
        rows, and the time ids ``tid`` [1, 6] for every row; with
        ``enc_cache`` (encoder reuse) ``encode`` runs on key steps only."""
        added = {"text_embeds": pooled,
                 "time_ids": tid.expand(x.shape[0], -1)}
        if enc_cache is None:
            return self.unet(x, t, emb, controls, capture, added_cond=added)
        if controls is not None:
            controls.check_supported()
        e = self.unet.embed_time(t, x.shape[0], added)
        if key:
            enc_cache[name] = self.unet.encode(x, e, emb, controls, capture)
        return self.unet.decode(enc_cache[name], e, emb, controls, capture)

    # ------------------------------------------------------------ plain pass
    def produce_attn_maps(self, prompts, negative_prompts="",
                          height: int = 1024, width: int = 1024,
                          num_inference_steps: int = 50,
                          guidance_scale: float = 5.0, latents=None,
                          seed: int = 0, ref_capture_steps=None):
        """Plain CFG pass; returns (images uint8, AttnAggregates). The self
        maps are summed over every step from ``agg_start_step`` on and over
        every attn1 layer at the segmentation resolution. With
        ``ref_capture_steps`` it also keeps the refer cache, as
        ``RegionDiffusion.produce_attn_maps`` does."""
        if not isinstance(prompts, str):
            prompts = list(prompts)
            if len(prompts) != 1:
                raise ValueError("produce_attn_maps takes exactly one prompt "
                                 f"(the aggregates are per prompt); got "
                                 f"{len(prompts)}")
        embeds, pooled = self.encode_prompt(prompts, negative_prompts)
        tid = self._time_ids(height, width)
        h, w = height // self.vae_scale_factor, width // self.vae_scale_factor
        sched = self.scheduler
        plan = sched.plan(num_inference_steps)
        lat = self._init_latents(latents, h, w, seed) * getattr(
            plan, "init_noise_sigma", 1.0)
        slots = (tuple(int(s) for s in ref_capture_steps)
                 if ref_capture_steps is not None else None)
        if slots and (self._ref_qk_bytes_per_slot((h, w)) * len(slots)
                      > self.ref_precompute_max_bytes):
            slots = None
        self.ref_cache = None  # before the new cache fills
        S = plan.num_steps
        seg_res, self_layers, cross_by_res = self._capture_layout((h, w))
        capture = CaptureSpec(
            self_probs=frozenset(self_layers),
            cross_probs=frozenset(n for ns in cross_by_res.values()
                                  for n in ns))
        slot_of = {s: j for j, s in enumerate(slots or ())}
        cache = None
        if slots is not None:
            cache = dict(traj=torch.empty((S + 1, *lat.shape[1:]),
                                          dtype=torch.float32,
                                          device=lat.device), qk={}, resnet={})

        def tokens(r):  # of a level with r rows, at the latent's aspect
            return r * (r * w // h)

        self_sum = torch.zeros((tokens(seg_res), tokens(seg_res)),
                               dtype=torch.float32, device=self.device)
        cross = {r: torch.zeros((tokens(r), 77), dtype=torch.float32,
                                device=self.device)
                 for r in sorted(cross_by_res)}
        st = sched.init_state(lat.shape, self.device)
        g = float(guidance_scale)
        lat0 = lat
        with torch.no_grad():
            for i in range(S):
                if cache is not None:
                    cache["traj"][i].copy_(lat[0])
                x = sched.scale_model_input(plan, i, torch.cat([lat, lat]))
                agg = i >= self.agg_start_step
                spec = capture if agg else EMPTY_CAPTURE
                if i in slot_of:
                    spec = dataclasses.replace(
                        spec, qk=True, resnet=frozenset({INJECT_RESNET_NAME}))
                eps, aux = self._fwd(x, plan.timesteps[i], embeds[:2],
                                     pooled[:2], tid, capture=spec)
                if agg:
                    # SDXL sums the self maps over the steps
                    for n in self_layers:
                        self_sum += aux["self_probs"][n][1].float()
                    for r, ns in cross_by_res.items():
                        for n in ns:
                            cross[r] += aux["cross_probs"][n][1].float()
                if i in slot_of:
                    self._store_slot(cache, len(slot_of), slot_of[i], aux)
                eps = eps.float()
                e = eps[0:1] + g * (eps[1:2] - eps[0:1])
                lat, st = sched.step(plan, i, st, e, lat)
            if cache is not None:
                cache["traj"][S].copy_(lat[0])
        if cache is not None:
            cache.update(steps=slots, g=g, hw=(h, w), fp=ref_fingerprint(
                lat0, embeds[0], embeds[1], pooled[0], pooled[1], tid))
            self.ref_cache = cache
        agg = AttnAggregates(
            self_sum=self_sum, self_count=len(self_layers),
            cross_sums={r: c.cpu().numpy() for r, c in cross.items()},
            cross_layer_count=sum(len(v) for v in cross_by_res.values()))
        self.attn_aggregates = agg
        return self.decode_latents(lat), agg

    # ------------------------------------------------------------- rich pass
    def prompt_to_img(self, prompts: Sequence[str], negative_prompts="",
                      height: int = 1024, width: int = 1024,
                      num_inference_steps: int = 50,
                      guidance_scale: float = 5.0, latents=None,
                      text_format_dict: Optional[dict] = None,
                      use_guidance: bool = False,
                      inject_selfattn: float = 0.0,
                      inject_background: float = 0.0, seed: int = 0,
                      encoder_reuse: int = 1, encoder_schedule: str = "early",
                      bf16_guidance: bool = False,
                      guidance_downsample: int = 1,
                      ref_cache: Optional[dict] = None) -> np.ndarray:
        """Rich region-based sampling; ``prompts`` are the region prompts,
        base prompt last, with ``len(prompts)`` masks in ``self.masks``."""
        fmt = dict(text_format_dict or {})
        spec = RichControlSpec(
            guidance_scale=guidance_scale, inject_selfattn=inject_selfattn,
            inject_background=inject_background, use_guidance=use_guidance,
            guidance_start_step=fmt.get("guidance_start_step", 999),
            color_guidance_weight=fmt.get("color_guidance_weight", 1.0),
            encoder_reuse=int(encoder_reuse),
            encoder_schedule=encoder_schedule,
            bf16_guidance=bool(bf16_guidance),
            guidance_downsample=int(guidance_downsample))
        embeds, pooled = self.encode_prompt(list(prompts), negative_prompts)
        lat = self.rich_latents(embeds, pooled, height, width,
                                num_inference_steps, latents, spec, fmt,
                                seed, ref_cache)
        return self.decode_latents(lat)

    def rich_latents(self, embeds, pooled, height: int, width: int,
                     num_inference_steps: int, latents=None,
                     spec: RichControlSpec = RichControlSpec(),
                     fmt: Optional[dict] = None, seed: int = 0,
                     ref_cache: Optional[dict] = None) -> torch.Tensor:
        """The rich loop on [uncond, spans..., base] rows; returns the final
        latent [1, h, w, 4] float32. Flows, as in the JAX package:

          * no injection: one forward of [uncond, spans..., base];
          * refer-precompute, when ``ref_cache`` fits this run: one forward
            of [uncond, base, spans...] a step, rows 2.. injected from the
            step's slot, the background from the stored trajectory;
          * in-batch: [uncond, base, ref_u, ref_c, spans...], the spans
            taking row 3's (Q, K) and feature; the refer rows dropped on
            the steps past the refer trajectory's last use;
          * in-batch with encoder reuse: [uncond, base, ref_u, ref_c] with
            the capture, then the spans, each with its own encoder cache.
        """
        fmt = dict(fmt or {})
        dev = self.device
        f = self.vae_scale_factor
        h, w = height // f, width // f
        n_styles = embeds.shape[0] - 1
        if n_styles != len(self.masks):
            raise ValueError(f"{n_styles} region prompts but "
                             f"{len(self.masks)} masks")
        R = n_styles - 1
        sched = self.scheduler
        plan = sched.plan(num_inference_steps)
        S = plan.num_steps
        lat = self._init_latents(latents, h, w, seed) * getattr(
            plan, "init_noise_sigma", 1.0)
        tid = self._time_ids(height, width)
        ts = plan.timesteps
        inject_gates = ts.astype(np.float64) > (1 - spec.inject_selfattn) * 1000
        run_ref = spec.inject_selfattn > 0 or spec.inject_background > 0
        # the refer trajectory steps while inject_selfattn > 0 or i <
        # inject_background * S, and not past its last use (the last
        # injection step, the background step): freezing it there is exact
        ref_gates = np.asarray([spec.inject_selfattn > 0
                                or i < spec.inject_background * S
                                for i in range(S)], bool)
        bg_step = int(spec.inject_background * S)
        if run_ref:
            inj = np.nonzero(inject_gates)[0]
            last_use = max(int(inj[-1]) if len(inj) else -1,
                           bg_step if spec.inject_background > 0 else -1)
            ref_gates &= np.arange(S) <= last_use
        bg_gates = (np.arange(S) == bg_step) & (spec.inject_background > 0)
        guidance_gates = ((ts.astype(np.int64) < spec.guidance_start_step)
                          & spec.use_guidance)
        # Euler's float timesteps cast to int64, as the JAX SDXL pass does
        alpha_raw = sched.alphas_cumprod[ts.astype(np.int64)].astype(
            np.float32)
        stride = max(int(spec.encoder_reuse), 1)
        key_steps = encoder_key_gates(S, stride, spec.encoder_schedule)
        enc_cache = {} if stride > 1 else None
        ref_skip = bool(run_ref and stride == 1 and not ref_gates.all())

        flow = "plain"
        if run_ref:
            flow = "in_batch_two" if stride > 1 else "in_batch"
            if ref_cache is not None:
                want = tuple(np.nonzero(inject_gates)[0].tolist())
                fp = ref_fingerprint(lat, embeds[0], embeds[-1], pooled[0],
                                     pooled[-1], tid)
                if ref_cache_matches(ref_cache, want, S, spec.guidance_scale,
                                     (h, w), fp):
                    flow = "refpre"
                    slot_of = {s: j for j, s in enumerate(want)}

        tw, tsg = make_token_weight_vectors(fmt.get("word_pos"),
                                            fmt.get("font_size"))

        def controls_for(n, base, **kw):
            """Controls of an n-row forward, font-size weights on row
            ``base`` only."""
            if tw is None:
                return UNetControls(**kw) if kw else None
            rows = [torch.ones((n, 77), dtype=torch.float32, device=dev)
                    for _ in range(2)]
            for r, v in zip(rows, (tw, tsg)):
                r[base] = torch.from_numpy(v).to(dev)
            return UNetControls(token_weights=rows[0], token_signs=rows[1],
                                **kw)

        def rows(*idx):  # (text rows, pooled rows) in the order given
            return (torch.cat([embeds[a:b] for a, b in idx], dim=0),
                    torch.cat([pooled[a:b] for a, b in idx], dim=0))

        U, B, SP = (0, 1), (R + 1, R + 2), (1, 1 + R)
        cond_plain = (embeds, pooled)
        cond_short = rows(U, B, SP)  # [uncond, base, spans...]
        cond_merged = rows(U, B, U, B, SP)
        cond_quad, cond_spans = rows(U, B, U, B), rows(SP)

        masks = self._region_masks(h, w)
        color = None
        if spec.use_guidance:
            color = self._color_inputs(fmt, height, width, h, w,
                                       spec.guidance_downsample,
                                       spec.bf16_guidance,
                                       spec.color_guidance_weight)
        g = float(spec.guidance_scale)
        lat_ref = lat if flow.startswith("in_batch") else None
        st = sched.init_state(lat.shape, dev)
        st_ref = sched.init_state(lat.shape, dev)
        for i in range(S):
            t = ts[i]
            gate, key = bool(inject_gates[i]), bool(key_steps[i])
            eps_ref = None
            with torch.no_grad():
                x_in = sched.scale_model_input(plan, i, lat)
                with_ref = lat_ref is not None and not (
                    ref_skip and not ref_gates[i])
                if flow == "plain":
                    eps = self._fwd(torch.cat([x_in] * (R + 2)), t,
                                    *cond_plain, tid,
                                    controls_for(R + 2, R + 1),
                                    enc_cache=enc_cache, name="rich",
                                    key=key)[0].float()
                    eu, es, eb = eps[0:1], eps[1:1 + R], eps[R + 1:R + 2]
                elif flow == "refpre" or not with_ref:
                    kw = {}
                    if flow == "refpre" and gate:
                        j = slot_of[i]
                        kw = dict(
                            inject_gate=True, inject_dst=(2, 2 + R),
                            inject_qk={n: (q[j:j + 1], k[j:j + 1]) for n, (q, k)
                                       in ref_cache["qk"].items()},
                            inject_resnet={n: v[j:j + 1] for n, v
                                           in ref_cache["resnet"].items()})
                    eps = self._fwd(torch.cat([x_in] * (R + 2)), t,
                                    *cond_short, tid,
                                    controls_for(R + 2, 1, **kw),
                                    enc_cache=enc_cache, name="rich",
                                    key=key)[0].float()
                    eu, eb, es = eps[0:1], eps[1:2], eps[2:]
                else:
                    ref_in = sched.scale_model_input(plan, i, lat_ref)
                    quad = [x_in, x_in, ref_in, ref_in]
                    if flow == "in_batch":
                        eps = self._fwd(
                            torch.cat(quad + [x_in] * R), t, *cond_merged,
                            tid, controls_for(R + 4, 1, inject_gate=gate,
                                              inject_src=3,
                                              inject_dst=(4, 4 + R))
                        )[0].float()
                        es = eps[4:]
                    else:
                        eps, aux = self._fwd(
                            torch.cat(quad), t, *cond_quad, tid,
                            controls_for(4, 1), CAPTURE_REF, enc_cache,
                            "ref", key)
                        eps = eps.float()
                        es = eps[4:]
                        if R > 0:
                            es = self._fwd(
                                x_in.repeat(R, 1, 1, 1), t, *cond_spans, tid,
                                UNetControls(
                                    inject_gate=gate,
                                    inject_qk={n: (q[3:4], k[3:4]) for n, (q, k)
                                               in aux["self_qk"].items()},
                                    inject_resnet={n: v[3:4] for n, v in
                                                   aux["resnet_hidden"].items()}),
                                EMPTY_CAPTURE, enc_cache, "spans",
                                key)[0].float()
                    eu, eb = eps[0:1], eps[1:2]
                    eps_ref = eps[2:3] + g * (eps[3:4] - eps[2:3])
                noise = composite_noise(masks, g, eu, eb, es[None])
                lat_new, st = sched.step(plan, i, st, noise, lat)
                if lat_ref is not None and ref_gates[i]:
                    # past its window the refer latent and its scheduler
                    # state hold
                    lat_ref, st_ref = sched.step(plan, i, st_ref, eps_ref,
                                                 lat_ref)
            lat = lat_new
            if guidance_gates[i]:
                lat = self._guided(lat, noise, float(alpha_raw[i]), color)
            if run_ref and bg_gates[i]:
                src = (ref_cache["traj"][min(bg_step + 1, S)][None]
                       if flow == "refpre" else lat_ref)
                bg = masks[-1][None]
                lat = src * bg + lat * (1 - bg)
        return lat
