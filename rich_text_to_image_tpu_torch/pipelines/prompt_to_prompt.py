"""Prompt-to-prompt baseline (AttentionRefine / Replace / Reweight,
LocalBlend) through the UNet's controls.

Counterpart of ``rich_text_to_image_tpu/pipelines/prompt_to_prompt.py``.
Each step runs two forwards:

  * A at batch 3, [uncond, uncond, base cond] from [base, edited, base]
    latents, capturing every attn1 layer's (Q, K) and every attn2 layer's
    full probabilities (``CaptureSpec(qk=True, cross_full=True)``);
  * B at batch 1, the edited cond row, with the base row's (Q, K) injected
    at the self-attention layers of at most 256 tokens while ``i <
    self_replace_steps · S``, and its cross-attention probabilities
    blended in per token (``cross_mix`` = alphas while ``i <
    cross_replace_steps · S``), re-indexed by the Refine mapper (a column
    gather) or the Replace matrix, then scaled by the equalizer with no
    renormalization.

Defaults are the benchmarks': cross_replace_steps 0.8, self_replace_steps
0.4 (reference evaluation/benchmark_color.py:266-270).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.unet import EMPTY_CAPTURE, CaptureSpec, UNetControls
from ..utils.registries import attn_layer_resolutions
from ..utils.seq_aligner import (get_refinement_mapper,
                                 get_replacement_mapper, get_word_inds)
from .region_sd import RegionDiffusion

CAPTURE_A = CaptureSpec(qk=True, cross_full=True)
CAPTURE_B = CaptureSpec(cross_full=True)
SELF_INJECT_MAX_TOKENS = 256  # ptp replace_self_attention's shape gate


class PromptToPromptPipeline:
    """Runs on a RegionDiffusion's UNet, VAE, text encoder and scheduler."""

    def __init__(self, model: RegionDiffusion):
        self.model = model

    @torch.no_grad()
    def generate(self, base_prompt: str, edited_prompt: str,
                 cross_replace_steps: float = 0.8,
                 self_replace_steps: float = 0.4,
                 num_inference_steps: int = 41, guidance_scale: float = 8.5,
                 height: int = 512, width: int = 512, latents=None,
                 seed: int = 0, equalizer: Optional[np.ndarray] = None,
                 blend_words: Optional[tuple] = None,
                 blend_threshold: float = 0.3,
                 controller: str = "refine") -> np.ndarray:  # or "replace"
        """Returns uint8 images [2, H, W, 3] (base, edited).

        ``equalizer``: optional (77,) post-softmax scales of the edited
        prompt's cross-attention (AttentionReweight, ptp_utils.py:677-686),
        applied without renormalization through ``token_signs`` with unit
        ``token_weights``. ``blend_words``: (words of the base prompt,
        words of the edited one) for LocalBlend (ptp_utils.py:465-493):
        after each step the edited latent is pulled back to the base one
        outside the union of the two words' masks, made from the cross maps
        of the finest level at most 16 rows (3×3 max-pool, max-normalized,
        thresholded at ``blend_threshold``)."""
        m = self.model
        dev = m.device
        h, w = height // m.vae_scale_factor, width // m.vae_scale_factor
        lat0 = m._init_latents(latents, h, w, seed)
        embeds = m.get_text_embeds([base_prompt, edited_prompt], [""])
        if controller == "replace":
            mapper = get_replacement_mapper(base_prompt, edited_prompt,
                                            m.tokenizer)
            alphas = np.ones(77, np.float32)
        else:
            mapper, alphas = get_refinement_mapper(
                m.tokenizer(base_prompt)[0], m.tokenizer(edited_prompt)[0])
        sched = m.scheduler
        plan = sched.plan(num_inference_steps)
        S = plan.num_steps
        eq = (np.ones(77, np.float32) if equalizer is None
              else np.asarray(equalizer, np.float32).reshape(77))
        as_t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        mapper_t, alphas_t, eq_t = as_t(mapper), as_t(alphas), as_t(eq)
        ones = torch.ones(77, device=dev)

        blend = None
        if blend_words is not None:
            alpha_b = np.zeros(77, np.float32)
            alpha_e = np.zeros(77, np.float32)
            for prompt, words, alpha in (
                    (base_prompt, blend_words[0], alpha_b),
                    (edited_prompt, blend_words[1], alpha_e)):
                for word in ([words] if isinstance(words, str) else words):
                    alpha[get_word_inds(prompt, word, m.tokenizer)] = 1.0
            res_map = attn_layer_resolutions(m.unet_cfg, (h, w))
            blend_res = max((r for r in set(res_map.values()) if r <= 16),
                            default=16)
            layers = sorted(n for n, r in res_map.items()
                            if n.endswith(".attn2") and r == blend_res)
            blend = (layers, blend_res, as_t(alpha_b), as_t(alpha_e))

        lat = lat0.expand(2, -1, -1, -1).clone()  # base, edited
        st = sched.init_state(lat.shape, dev)
        g = float(guidance_scale)
        ea = torch.stack([embeds[0], embeds[0], embeds[1]])
        for i in range(S):
            t = plan.timesteps[i]
            lat_in = sched.scale_model_input(plan, i, lat)
            lat_b, lat_e = lat_in[0:1], lat_in[1:2]
            eps_a, aux = m._unet_call(torch.cat([lat_b, lat_e, lat_b]), t, ea,
                                      capture=CAPTURE_A)
            eps_a = eps_a.float()
            controls = UNetControls(
                inject_gate=bool(i < self_replace_steps * S),
                token_weights=ones, token_signs=eq_t,
                inject_qk={n: (q[2:3], k[2:3])
                           for n, (q, k) in aux["self_qk"].items()
                           if q.shape[2] <= SELF_INJECT_MAX_TOKENS},
                inject_cross={n: p[2:3]
                              for n, p in aux["cross_probs_full"].items()},
                cross_mapper=mapper_t,
                cross_mix=alphas_t * float(i < cross_replace_steps * S))
            eps_e, aux_e = m._unet_call(lat_e, t, embeds[2:3], controls,
                                        CAPTURE_B if blend else EMPTY_CAPTURE)
            eps_e = eps_e.float()
            eps = torch.cat([eps_a[0:1] + g * (eps_a[2:3] - eps_a[0:1]),
                             eps_a[1:2] + g * (eps_e - eps_a[1:2])])
            lat, st = sched.step(plan, i, st, eps, lat)
            if blend is not None:
                layers, r, alpha_b, alpha_e = blend
                mb = _blend_mask([aux["cross_probs_full"][n][2:3]
                                  for n in layers], alpha_b, r, (h, w))
                me = _blend_mask([aux_e["cross_probs_full"][n]
                                  for n in layers], alpha_e, r, (h, w))
                mask = ((mb > blend_threshold) | (me > blend_threshold)).to(
                    lat.dtype)
                lat = torch.cat([lat[0:1],
                                 lat[0:1] + mask * (lat[1:2] - lat[0:1])])
        return m.decode_latents(lat)


def _blend_mask(probs_list, alpha, rows: int, hw) -> torch.Tensor:
    """LocalBlend's mask [1, h, w, 1] (ptp_utils.py:467-480): the maps
    [1,H,S,77] averaged over heads and layers, summed over the words'
    tokens, 3×3 max-pooled (stride 1, edges padded with −inf), resized to
    the latent by nearest neighbour (half-pixel centres, as
    ``jax.image.resize``) and divided by their max."""
    maps = torch.stack([p.float().mean(dim=1) for p in probs_list]).mean(0)[0]
    sel = (maps * alpha[None]).sum(-1).reshape(1, 1, rows, -1)
    pooled = F.max_pool2d(sel, 3, stride=1, padding=1)
    mask = F.interpolate(pooled, size=tuple(hw), mode="nearest-exact")
    mask = mask.permute(0, 2, 3, 1)
    return mask / (mask.max() + 1e-12)
