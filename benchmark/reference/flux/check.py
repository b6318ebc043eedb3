"""The comparison that decides ``correct`` for FLUX.1-dev: the plain
reference run again over one recorded sample of the program, stage by
stage, as ``reference/check.py`` does for the UNet (its ``compare`` and
``subject_of`` take this module's outputs unchanged):

  text       T5's rows and CLIP-L's pooled row, each prompt alone
  plain      at the checked steps, the program's latent stepped anew: one
             row, velocity, x + (sigma_{i+1} - sigma_i) v
  maps       the double blocks' joint attention of the one row, image
             queries, head-averaged, image->image pooled 2x2 on both axes,
             image->text pooled on the queries, summed over every step from
             ``agg_start_step`` on (the single blocks are skipped at a step
             that is not checked: they do not feed the maps)
  rich       at the checked steps, R + 1 rows (region prompts, base last)
             on the program's latent, the velocities blended under the
             masks, one step
  masks      segmented from the program's sums with the reference's
             clustering, over T5 positions (no start token)
  decodes    the program's final latents through the float32 VAE
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..check import _TF32
from ..maps import resize, spectral
from ..nets import CLIPText
from ..text import ByteTokenizer, rich_inputs
from . import nets as N

UNIT_OFFSET, EOS, PAD = 3, 1, 0  # the T5 stand-in's ids


def t5_ids(tok: ByteTokenizer, text: str, length: int) -> np.ndarray:
    units = [tok.vocab[t] + UNIT_OFFSET for t in tok.tokenize(text)]
    row = units[:length - 1] + [EOS]
    return np.asarray(row + [PAD] * (length - len(row)), np.int64)


def flow_sigmas(steps: int, image_tokens: int) -> np.ndarray:
    """(S + 1,) float32: linspace(1, 1/S, S) shifted by mu from (256, 0.5)
    to (4096, 1.15), then 0."""
    mu = 0.5 + (1.15 - 0.5) * (image_tokens - 256) / (4096 - 256)
    s = np.linspace(1.0, 1.0 / steps, steps)
    s = math.exp(mu) / (math.exp(mu) + (1.0 / s - 1.0))
    return np.concatenate([s, [0.0]]).astype(np.float32)


def sample_inputs(traffic: dict):
    return rich_inputs(ByteTokenizer(), traffic["rich_text"],
                       traffic["flags"].get("color_guidance_weight", 0.5))


def token_maps(self_sum, cross_sums: dict, cross_count: int, spans,
               latent_hw, seed, threshold, k, labels=None):
    """``reference/maps.token_maps`` over the T5 row: as wide as the sums,
    span id i at position i - 1."""
    h, w = latent_hw
    res = int(round(np.sqrt(self_sum.shape[0] * h / w)))
    res_w = res * w // h
    if labels is None:
        labels = spectral(self_sum, k, seed).cpu().numpy().reshape(res, res_w)
    width = next(iter(cross_sums.values())).shape[-1]
    cross = np.zeros((res, res_w, width), np.float32)
    for r, m in cross_sums.items():
        m = np.asarray(m, np.float32).reshape(r, -1, width)
        if r != res:
            m = resize(m.transpose(2, 0, 1), (res, res_w)).transpose(1, 2, 0)
        cross += m
    cross /= max(cross_count, 1)
    span_maps = []
    for ids in spans:
        s = cross[:, :, np.asarray(ids) - 1]
        lo = s.min(axis=(0, 1), keepdims=True)
        hi = s.max(axis=(0, 1), keepdims=True)
        span_maps.append((s - np.abs(lo)) / (hi - lo + 1e-12))
    fg = [np.zeros((res, res_w), np.float32) for _ in spans]
    bg = np.zeros((res, res_w), np.float32)
    for c in range(k):
        cm = (labels == c).astype(np.float32)
        n = max(cm.sum(), 1e-12)
        hit = False
        for sm, f in zip(span_maps, fg):
            if ((cm[:, :, None] * sm).sum(axis=(0, 1)) / n).max() > threshold:
                f += cm
                hit = True
        if not hit:
            bg += cm
    out = np.clip(resize(np.stack(fg + [bg]), (h, w)), 0.0, 1.0)
    return out / (out.sum(axis=0, keepdims=True) + 1e-8), labels


class Reference:
    """FLUX.1-dev's networks on one device over a drawn state (not copied:
    the bfloat16 tensors are upcast where used). ``round_fn`` rounds both
    operands of every transformer and T5 matrix product (the control's);
    ``tf32`` allows TF32 in CLIP-L and the VAE."""

    def __init__(self, cfg: dict, state: dict, device, round_fn=None,
                 tf32: bool = False):
        self.cfg, self.device = cfg, torch.device(device)
        self.round_fn, self.tf32 = round_fn, tf32
        self.tok = ByteTokenizer()
        self.eos = self.tok.vocab["<|endoftext|>"]
        self.length = cfg["pipeline"]["max_sequence_length"]
        with torch.device("meta"):
            mods = {"transformer": N.Transformer(cfg["transformer"]),
                    "text_encoder": CLIPText(cfg["text_encoder"]),
                    "text_encoder_2": N.T5(cfg["text_encoder_2"]),
                    "vae": N.VAE(cfg["vae"])}
        for name, mod in mods.items():
            mod.load_state_dict({k: v.to(self.device) for k, v
                                 in state[name].items()}, assign=True)
            mod.eval().requires_grad_(False)
        self.transformer, self.clip = mods["transformer"], mods["text_encoder"]
        self.t5, self.vae = mods["text_encoder_2"], mods["vae"]

    @contextlib.contextmanager
    def _rounding(self):
        N.ROUND["fn"] = self.round_fn
        try:
            yield
        finally:
            N.ROUND["fn"] = None

    @torch.no_grad()
    def encode(self, prompts):
        """(T5 rows [N, T, 4096], CLIP-L pooled rows [N, 768])."""
        rows, pooled = [], []
        for text in prompts:
            ids = torch.from_numpy(self.tok.ids(text))[None].to(self.device)
            with _TF32(self.tf32):
                pooled.append(self.clip(ids, self.eos)["pooled"])
            ids = torch.from_numpy(t5_ids(self.tok, text, self.length))[
                None].to(self.device)
            with _TF32(False), self._rounding():
                rows.append(self.t5(ids))
        return torch.cat(rows), torch.cat(pooled)

    @torch.no_grad()
    def velocity(self, lat, sigma, emb, pooled, guidance, pool=None,
                 double_only=False):
        """lat [1, h, w, 16] for every row of ``emb`` -> [rows, h, w, 16]
        (None with ``double_only``)."""
        _, h, w, C = lat.shape
        x = lat.float().permute(0, 3, 1, 2).reshape(1, C, h // 2, 2, w // 2, 2)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(1, -1, 4 * C)
        x = x.expand(emb.shape[0], -1, -1)
        with _TF32(False), self._rounding():
            v = self.transformer(x, sigma, emb, pooled, guidance,
                                 (h // 2, w // 2), pool, double_only)
        if v is None:
            return None
        v = v.reshape(-1, h // 2, w // 2, C, 2, 2).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(-1, h, w, C)

    @torch.no_grad()
    def images(self, latents):
        with _TF32(self.tf32):
            return self.vae.images(latents)


def _masks(ref, rec, inp, f, seed, hw):
    agg = rec["agg"]
    kw = dict(cross_sums=agg["cross"], cross_count=agg["cross_count"],
              latent_hw=hw, seed=seed, threshold=f["segment_threshold"],
              k=f["num_segments"])
    cmasks, labels = token_maps(agg["self"], spans=inp["color_ids"], **kw)
    masks, _ = token_maps(agg["self"], spans=inp["region_ids"][:-1],
                          labels=labels, **kw)
    return masks, cmasks


def evaluate(ref: Reference, rec: dict, traffic: dict, seed: int,
             steps) -> dict:
    """The reference's outputs from the states in ``rec``
    (``benchmark/recorder.py``'s layout), at the steps ``steps`` of both
    passes, in ``reference/check.evaluate``'s layout."""
    cfg, dev = ref.cfg, ref.device
    p, f = cfg["pipeline"], traffic["flags"]
    inp = sample_inputs(traffic)
    s = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    hw = (p["height"] // s, p["width"] // s)
    out: dict = {}
    masks, cmasks = _masks(ref, rec, inp, f, seed, hw)
    color_all = np.zeros_like(cmasks[-1])
    out["masks"] = np.concatenate([masks.ravel(), color_all.ravel()])
    S = len(rec["plain"]["lat"]) - 1
    sig = flow_sigmas(p["steps"], (hw[0] // 2) * (hw[1] // 2))
    C = cfg["vae"]["latent_channels"]
    out["lat0"] = torch.randn(
        (1, *hw, C), generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    emb_p, pool_p = ref.encode([inp["base"]])
    emb_r, pool_r = ref.encode(inp["region_prompts"])
    out["text"] = [emb_p, emb_r, pool_p, pool_r]
    g = float(p["guidance_scale"])
    agg_start = p["agg_start_step"]
    mk = torch.from_numpy(np.stack(masks)).to(dev)[..., None]  # [R+1,h,w,1]
    pool = N.Pool(emb_p.shape[1], hw[0] // 2, hw[1] // 2)
    sel = set(steps)
    nxt_plain, nxt_rich = {}, {}
    for i in range(S):
        if i not in sel and i < agg_start:
            continue
        dt = float(sig[i + 1]) - float(sig[i])
        lat = rec["plain"]["lat"][i].to(dev).float()
        v = ref.velocity(lat, float(sig[i]), emb_p, pool_p, g,
                         pool if i >= agg_start else None,
                         double_only=i not in sel)
        if i not in sel:
            continue
        nxt_plain[i] = lat + dt * v
        lat = rec["rich"]["lat"][i].to(dev).float()
        v = (ref.velocity(lat, float(sig[i]), emb_r, pool_r, g) * mk).sum(
            0, keepdim=True)
        nxt_rich[i] = lat + dt * v
    out["plain_next"], out["rich_next"] = nxt_plain, nxt_rich
    out["maps"] = [pool.self_sum, pool.cross]
    out["guided"] = {}
    out["images"] = [ref.images(rec[k]["lat"][S].to(dev))
                     for k in ("plain", "rich")]
    return out
