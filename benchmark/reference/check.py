"""The comparison that decides ``correct``: the plain reference, run again
over one sample that the timed path produced, stage by stage.

A diffusion sample is a chain of 100 UNet steps and a clustering between
its two passes, so the reference follows the program's own states instead
of sampling again on its own: at a sample of the steps of both passes,
drawn from the run's seed, it takes the latent the program stepped from
(and the sampler's history, the program's earlier noise predictions) and
computes the step anew: text encoders, UNet with its captures, region
compositing, font-size weights, self-attention and background injection,
the sampler. It sums the captured maps itself over every step they cover,
segments the token maps from the program's sums, computes the
colour-guided step from the program's stepped latent and noise, and the
decodes from the program's final latents. Each stage is thus checked by
itself, and nothing that the reference computes comes from the program:
only the states each stage starts from. The initial latents and the masks
are compared exactly.

``evaluate`` runs one reference (or the control, a reference in a lower
precision) over a record; ``compare`` turns a subject's outputs and the
reference's into the numbers held against the cell's limits:

  text_rel        the text encoders' rows, both passes (and SDXL's pooled)
  plain_step_rel  the plain pass's steps: UNet at B=2 under CFG, sampler
  maps_rel        the captured maps: the self-attention affinity and the
                  cross-attention sums the token maps segment
  rich_step_rel   the rich pass's steps: region compositing, injection,
                  font-size weights, UNet at R+2 rows, sampler, background
  guided_rel      the colour-guided steps (VAE decode of x0 and its
                  gradient), where the cell has colour
  decode_rel      the two final decodes
  inputs_max_abs  the initial latents and the masks: exact

A ``*_rel`` number is the root of the summed squared differences over its
stage's outputs, over the root of the summed squared changes the reference
makes (for a step: its latent minus the latent it started from).
"""

from __future__ import annotations

import numpy as np
import torch

from . import maps as M
from .nets import INJECT_RESNET, VAE, CLIPText, Controls, UNet
from .sched import SAMPLERS
from .text import ByteTokenizer, rich_inputs


class Reference:
    """The networks of one configuration on one device, at one precision:
    ``unet_dtype`` for the UNet (float32 for the reference), ``tf32`` for
    the float32 matrix products of the text towers, the VAE and its
    gradient."""

    def __init__(self, cfg: dict, state: dict, device, unet_dtype=torch.float32,
                 tf32: bool = False):
        self.cfg, self.device, self.tf32 = cfg, torch.device(device), tf32
        self.xl = cfg["pipeline"]["model"] == "SDXL"
        self.tok = ByteTokenizer()
        self.eos = self.tok.vocab["<|endoftext|>"]
        with torch.device("meta"):  # filled from the state dict
            mods = {"unet": UNet(cfg["unet"]), "vae": VAE(cfg["vae"]),
                    "text_encoder": CLIPText(cfg["text_encoder"])}
            if self.xl:
                mods["text_encoder_2"] = CLIPText(cfg["text_encoder_2"])
        for name, mod in mods.items():
            mod.load_state_dict({k: v.to(self.device, torch.float32)
                                 for k, v in state[name].items()},
                                assign=True)
            mod.eval().requires_grad_(False)
        mods["unet"].to(unet_dtype)
        self.unet, self.vae = mods["unet"], mods["vae"]
        self.texts = [mods["text_encoder"]] + (
            [mods["text_encoder_2"]] if self.xl else [])

    def _precision(self):
        return _TF32(self.tf32)

    @torch.no_grad()
    def encode(self, prompts, negative=""):
        """([uncond, prompts...] rows, pooled rows or None), each prompt
        encoded alone; SDXL's empty negative prompt is zero rows."""
        with self._precision():
            rows, pooled = [], []
            for text in [negative] + list(prompts):
                if self.xl and text is negative and negative == "":
                    rows.append(None)  # SDXL: zero rows, after the others
                    pooled.append(None)
                    continue
                ids = torch.from_numpy(self.tok.ids(text))[None].to(self.device)
                if not self.xl:
                    rows.append(self.texts[0](ids, self.eos)["last"])
                    continue
                a, b = (t(ids, self.eos) for t in self.texts)
                rows.append(torch.cat([a["penultimate"], b["penultimate"]], -1))
                pooled.append(b["projected"])
            if rows[0] is None:
                rows[0], pooled[0] = (torch.zeros_like(rows[1]),
                                      torch.zeros_like(pooled[1]))
        return torch.cat(rows), torch.cat(pooled) if self.xl else None

    @torch.no_grad()
    def eps(self, x, t, emb, pooled, tid, c=Controls()):
        added = None
        if self.xl:
            added = {"text_embeds": pooled, "time_ids": tid}
        return self.unet(x, t, emb, added, c)

    @torch.no_grad()
    def images(self, latents):
        with self._precision():
            return self.vae.images(latents)

    def guided(self, lat, noise, alpha, color):
        """The colour-guided step of the reference implementation
        (region_diffusion.py:151-168): the gradient, with respect to the
        latent, of the squared distance of each colour span's mean RGB in
        the decoded x0 prediction from its target, x100, applied under the
        colour spans' latent mask."""
        with self._precision(), torch.enable_grad():
            lat = lat.detach().float().requires_grad_(True)
            a = torch.tensor(alpha, dtype=torch.float32, device=lat.device)
            x0 = (lat - noise * torch.sqrt(1 - a)) / torch.sqrt(a)
            img = self.vae.images(x0)
            m = color["masks_px"]
            mean = (torch.einsum("bhwc,nhw->nc", img, m)
                    / (m.sum(dim=(1, 2))[:, None] + 1e-12))
            loss = (((mean - color["rgb"]) ** 2).mean(1) * 100.0).sum()
            (grad,) = torch.autograd.grad(loss, lat)
        return (lat - grad * color["weight"] * color["all"]).detach()


class _TF32:
    """TF32 on the card's float32 matrix products and convolutions inside
    the block, or strictly off."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        b = torch.backends
        self.old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.old


def sample_inputs(traffic: dict):
    """The rich-text inputs of one sample (independent of its seed)."""
    return rich_inputs(ByteTokenizer(), traffic["rich_text"],
                       traffic["flags"].get("color_guidance_weight", 0.5))


def _masks(ref: Reference, rec: dict, inp: dict, f: dict, seed: int):
    """The reference's masks and colour inputs, segmented from the
    program's aggregated maps."""
    p = ref.cfg["pipeline"]
    H, W = p["height"], p["width"]
    s = 2 ** (len(ref.cfg["vae"]["block_out_channels"]) - 1)
    hw = (H // s, W // s)
    agg = rec["agg"]
    kw = dict(cross_sums=agg["cross"], cross_count=agg["cross_count"],
              latent_hw=hw, seed=seed, threshold=f["segment_threshold"],
              k=f["num_segments"])
    cmasks, labels = M.token_maps(agg["self"], spans=inp["color_ids"], **kw)
    masks, _ = M.token_maps(agg["self"], spans=inp["region_ids"][:-1],
                            labels=labels, **kw)
    px = [M.resize(m[None], (H, W))[0] for m in cmasks[:-1]]
    return masks, cmasks, px, hw


def evaluate(ref: Reference, rec: dict, traffic: dict, seed: int,
             guided_steps=(), steps=None) -> dict:
    """The reference's outputs, stage by stage, from the states in ``rec``
    (see ``benchmark/recorder.py`` for its layout): the steps ``steps`` of
    both passes (all where None), the colour-guided steps
    ``guided_steps``, the maps, the masks, the text rows and the decodes.
    The maps need the conditional row of every step they sum; where such a
    step is not checked, that row alone runs."""
    cfg, dev = ref.cfg, ref.device
    p, f = cfg["pipeline"], traffic["flags"]
    inp = sample_inputs(traffic)
    g = float(p["guidance_scale"])
    neg = traffic.get("negative_prompt", "")
    out: dict = {}
    masks, cmasks, px, hw = _masks(ref, rec, inp, f, seed)
    color_all = np.zeros_like(cmasks[-1]) + sum(cmasks[:-1])
    out["masks"] = np.concatenate([masks.ravel()] + [m.ravel() for m in px]
                                  + [color_all.ravel()])
    S = len(rec["plain"]["lat"]) - 1
    sel = set(range(S)) if steps is None else set(steps)
    sampler = SAMPLERS[p["sampler"]](p["steps"])
    out["lat0"] = torch.randn(
        (1, *hw, 4), generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev) * sampler.init_sigma
    emb_p, pool_p = ref.encode([inp["base"]], neg)
    emb_r, pool_r = ref.encode(inp["region_prompts"], neg)
    out["text"] = [emb_p, emb_r] + ([pool_p, pool_r] if ref.xl else [])
    tid = torch.tensor([[p["height"], p["width"], 0, 0, p["height"],
                         p["width"]]], dtype=torch.float32, device=dev)
    R = len(inp["region_prompts"]) - 1
    self_layers, cross_rows = M.capture_layout(cfg["unet"], hw[0], ref.xl)
    cross_names = frozenset(n for ns in cross_rows.values() for n in ns)
    agg_start = p["agg_start_step"]
    self_sum = 0
    cross = {r: 0 for r in cross_rows}
    # the rich pass's rows: [uncond, spans..., base]; font-size weights on
    # the base row
    tw = ts = None
    if inp["word_pos"] is not None:
        tw = torch.ones((R + 2, 77), device=dev)
        ts = torch.ones((R + 2, 77), device=dev)
        tw[R + 1, inp["word_pos"]] = torch.from_numpy(
            np.abs(inp["font_size"])).to(dev)
        ts[R + 1, inp["word_pos"]] = torch.from_numpy(
            np.sign(inp["font_size"])).to(dev)
    mk = torch.from_numpy(np.stack(masks)).to(dev)[..., None]  # [R+1,h,w,1]
    inj, bg_w = f.get("inject_selfattn", 0.0), f.get("inject_background", 0.0)
    bg_step = int(bg_w * S)
    hist = {k: [t.to(dev) for t in rec[k]["noise"]] for k in ("plain", "rich")}
    first = {k: rec[k]["lat"][0].to(dev) for k in ("plain", "rich")}
    nxt_plain, nxt_rich = {}, {}
    for i in range(S):
        t = sampler.timesteps[i]
        gate = bool(inj > 0 and float(t) > (1 - inj) * 1000)
        self_here = i == S - 1 or (ref.xl and i >= agg_start)
        if i not in sel and not (self_here or i >= agg_start):
            continue
        # ---- plain step i from the program's latent (its conditional row
        # alone where the step is not checked but its maps are summed)
        lat = rec["plain"]["lat"][i].to(dev)
        x = sampler.scale(i, lat)
        capture = Controls(
            capture_self=frozenset(self_layers) if self_here else frozenset(),
            capture_cross=cross_names if i >= agg_start else frozenset(),
            capture_qk=gate, capture_resnet=gate)
        if i in sel:
            e, aux = ref.eps(torch.cat([x, x]), t, emb_p, pool_p, tid, capture)
            row = 1
            nxt_plain[i] = sampler.step(i, e[0:1] + g * (e[1:2] - e[0:1]),
                                        lat, hist["plain"], first["plain"])
        else:
            e, aux = ref.eps(x, t, emb_p[1:], None if pool_p is None
                             else pool_p[1:], tid, capture)
            row = 0
        if self_here:
            s = sum(aux["self"][n][row].float() for n in self_layers)
            self_sum = (self_sum + s) if ref.xl else s
        if i >= agg_start:
            for r, ns in cross_rows.items():
                cross[r] = cross[r] + sum(aux["cross"][n][row] for n in ns)
        if i not in sel:
            continue
        # ---- rich step i from the program's latent
        lat = rec["rich"]["lat"][i].to(dev)
        x = sampler.scale(i, lat)
        c = Controls(token_weights=tw, token_signs=ts)
        if gate:
            c.inject_rows = (1, 1 + R)
            c.inject_qk = {n: (q[row:row + 1], k[row:row + 1])
                           for n, (q, k) in aux["qk"].items()}
            c.inject_resnet = {INJECT_RESNET: aux["resnet"][row:row + 1]}
        del aux
        e, _ = ref.eps(torch.cat([x] * (R + 2)), t, emb_r, pool_r, tid, c)
        eu, es, eb = e[0:1], e[1:1 + R], e[R + 1:]
        nu = eu * mk.sum(0)
        nt = eb * mk[-1] + (es * mk[:-1]).sum(0, keepdim=True)
        nxt = sampler.step(i, nu + g * (nt - nu), lat, hist["rich"],
                           first["rich"])
        if i in rec["rich"]["guided"]:
            sched_out, _, guided_out = rec["rich"]["guided"][i]
            nxt = nxt + (guided_out.to(dev) - sched_out.to(dev))
        if bg_w > 0 and i == bg_step:
            src = rec["plain"]["lat"][min(bg_step + 1, S)].to(dev)
            nxt = src * mk[-1][None] + nxt * (1 - mk[-1][None])
        nxt_rich[i] = nxt
    out["plain_next"], out["rich_next"] = nxt_plain, nxt_rich
    out["maps"] = [self_sum] + [cross[r] for r in sorted(cross)]
    out["guided"] = {}
    if guided_steps:
        color = dict(
            masks_px=torch.from_numpy(np.stack(px)).to(dev),
            rgb=torch.from_numpy(np.stack(inp["color_rgb"])).to(dev),
            all=torch.from_numpy(color_all).to(dev)[None, :, :, None],
            weight=inp["color_weight"])
        for i in guided_steps:
            sched_out, noise, _ = rec["rich"]["guided"][i]
            out["guided"][i] = ref.guided(sched_out.to(dev), noise.to(dev),
                                          sampler.alpha(i), color)
    out["images"] = [ref.images(rec[k]["lat"][S].to(dev))
                     for k in ("plain", "rich")]
    return out


def check_steps(traffic: dict, steps: int, seed: int, n: int) -> list:
    """The steps of both passes a comparison checks: ``n`` drawn from the
    seed, and the background injection's step."""
    rng = np.random.default_rng(seed)
    out = set(int(i) for i in rng.choice(steps, min(n, steps), replace=False))
    bg = traffic["flags"].get("inject_background", 0.0)
    if bg > 0:
        out.add(int(bg * steps))
    return sorted(out)


def subject_of(rec: dict) -> dict:
    """The program's outputs in ``evaluate``'s layout."""
    S = len(rec["plain"]["lat"]) - 1
    return dict(
        masks=rec["masks"], lat0=rec["plain"]["lat"][0],
        lat0_rich=rec["rich"]["lat"][0], text=rec["text"],
        plain_next=rec["plain"]["lat"][1:S + 1],
        rich_next=rec["rich"]["lat"][1:S + 1],  # [i]: the latent after step i
        maps=[rec["agg"]["self"]] + [
            torch.as_tensor(rec["agg"]["cross"][r])
            for r in sorted(rec["agg"]["cross"])],
        guided={i: v[2] for i, v in rec["rich"]["guided"].items()},
        images=rec["images"])


def _rel(pairs) -> float:
    """sqrt(sum |a - b|^2) / sqrt(sum |d|^2) over (a, b, d) triples."""
    num = den = 0.0
    for a, b, d in pairs:
        a, b, d = (torch.as_tensor(v).double().cpu() for v in (a, b, d))
        num += float(((a - b) ** 2).sum())
        den += float((d ** 2).sum())
    return (num / den) ** 0.5 if den > 0 else float("inf")


def compare(sub: dict, ref: dict, rec: dict) -> dict:
    """The numbers of one subject against the reference (both from
    ``evaluate``'s layout; the states from ``rec``)."""
    out = {}
    out["text_rel"] = _rel((a, b, b) for a, b in zip(sub["text"], ref["text"]))
    out["plain_step_rel"] = _rel(
        (sub["plain_next"][i], b, b - rec["plain"]["lat"][i].to(b.device))
        for i, b in ref["plain_next"].items())
    out["maps_rel"] = _rel((a, b, b) for a, b in zip(sub["maps"], ref["maps"]))
    out["rich_step_rel"] = _rel(
        (sub["rich_next"][i], b, b - rec["rich"]["lat"][i].to(b.device))
        for i, b in ref["rich_next"].items())
    if ref["guided"]:
        out["guided_rel"] = _rel(
            (sub["guided"][i], b, b - rec["rich"]["guided"][i][0].to(b.device))
            for i, b in ref["guided"].items())
    out["decode_rel"] = _rel((a, b, b) for a, b in zip(sub["images"],
                                                       ref["images"]))
    diffs = [np.abs(np.asarray(sub["masks"]) - ref["masks"]).max()]
    for k in ("lat0", "lat0_rich"):
        if k in sub:
            diffs.append(float((sub[k].to(ref["lat0"].device)
                                - ref["lat0"]).abs().max()))
    out["inputs_max_abs"] = float(max(diffs))
    return out
