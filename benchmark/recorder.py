"""What the comparison reads of one sample of the timed path: wrappers on
the pipeline object (never on its class) that keep, while ``active``, the
states each stage starts from and what it produced.

``rec`` layout, the pass being ``plain`` or ``rich``:

  rec[pass]["lat"]     the latent each sampler step started from, then the
                       latent the pass decoded (S + 1 entries)
  rec[pass]["noise"]   the noise prediction each sampler step took (the
                       sampler's history)
  rec["rich"]["guided"]  {step: (sampler output, noise, guided output)}
  rec["text"]          [plain rows, rich rows] (+ [plain, rich] pooled rows)
  rec["agg"]           the plain pass's aggregated maps (the token maps'
                       input): {"self", "cross", "cross_count"}
  rec["masks"]         the region masks, the colour masks at pixel size and
                       the colour spans' latent mask, flattened
  rec["images"]        the two final decodes, float in [0, 1]

Copies are taken on the card without a synchronisation; they are a few MB
a sample.
"""

from __future__ import annotations

import numpy as np
import torch


class Recorder:
    def __init__(self, model):
        self.model = model
        self.active = False
        self.rec = None
        self._pass = None
        self._step = None
        self._text = {}
        m = model
        xl = hasattr(m, "encode_prompt")
        self._wrap(m, "produce_attn_maps", self._plain)
        self._wrap(m, "prompt_to_img", self._rich)
        self._wrap(m, "encode_prompt" if xl else "get_text_embeds", self._enc)
        self._wrap(m, "_guided", self._guided)
        self._wrap(m, "_decode_imgs", self._decode)
        self._wrap(m.scheduler, "step", self._sched)

    def _wrap(self, obj, name, fn):
        orig = getattr(obj, name)
        setattr(obj, name, lambda *a, **k: fn(orig, *a, **k))

    def start(self):
        self.active = True
        self.rec = {"plain": {"lat": [], "noise": []},
                    "rich": {"lat": [], "noise": [], "guided": {}},
                    "images": []}
        self._text = {}

    def stop(self) -> dict:
        self.active = False
        rec = self.rec
        t = self._text
        rec["text"] = [t["plain"][0], t["rich"][0]]
        if t["plain"][1] is not None:
            rec["text"] += [t["plain"][1], t["rich"][1]]
        return rec

    # ------------------------------------------------------------ wrappers
    def _plain(self, orig, *a, **k):
        self._pass = "plain"
        try:
            img, agg = orig(*a, **k)
        finally:
            self._pass = None
        if self.active:
            self.rec["agg"] = {"self": agg.self_sum, "cross": dict(
                agg.cross_sums), "cross_count": agg.cross_layer_count}
        return img, agg

    def _rich(self, orig, *a, **k):
        if self.active:
            fmt = k.get("text_format_dict") or {}
            parts = [np.stack([np.asarray(m, np.float32)
                               for m in self.model.masks]).ravel()]
            parts += [np.asarray(m, np.float32).ravel()
                      for m in fmt.get("color_obj_atten", [])]
            parts.append(np.asarray(fmt["color_obj_atten_all"],
                                    np.float32).ravel())
            self.rec["masks"] = np.concatenate(parts)
        self._pass = "rich"
        try:
            return orig(*a, **k)
        finally:
            self._pass = None

    def _enc(self, orig, *a, **k):
        out = orig(*a, **k)
        if self.active and self._pass:
            emb, pooled = out if isinstance(out, tuple) else (out, None)
            self._text[self._pass] = (emb.clone(), None if pooled is None
                                      else pooled.clone())
        return out

    def _sched(self, orig, plan, i, state, noise, sample):
        out = orig(plan, i, state, noise, sample)
        if self.active and self._pass:
            noise = noise.detach().clone()
            self.rec[self._pass]["lat"].append(sample.detach().clone())
            self.rec[self._pass]["noise"].append(noise)
            self._step = (i, noise, out[0].detach().clone())
        return out

    def _guided(self, orig, lat, noise, a, color):
        out = orig(lat, noise, a, color)
        if self.active:
            i, noise_c, sched_out = self._step
            self.rec["rich"]["guided"][i] = (sched_out, noise_c,
                                             out.detach().clone())
        return out

    def _decode(self, orig, latents, *a, **k):
        out = orig(latents, *a, **k)
        if self.active and self._pass and not torch.is_grad_enabled():
            self.rec[self._pass]["lat"].append(latents.detach().clone())
            self.rec["images"].append(out.detach().float().clone())
        return out
