"""The benchmark's own count of the work in one sample, for ``mfu`` and
``attn_roofline``, made over the reference's modules and never over the
program's.

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the reference
networks on the meta device (nothing executes), two FLOPs a multiply-add,
matrix products and convolutions only; attention is the reference's
explicit softmax, so its two products count. One sample is: every UNet
evaluation of both passes at its batch (the plain pass [uncond, base] on
every step of the sampler's plan, PNDM's extra step included; the rich
pass [uncond, spans..., base]), the text towers on each prompt alone, the
two final decodes, and each colour-guided step's decode forward and
backward as autograd runs them.

The roofline of self-attention: for every attn1 call the sample needs, the
larger of 4·B·H·Sq·Skv·d FLOPs over the peak rate and its bytes (q, k, v
read once and o written once, bfloat16; a capture layer also writes the
conditional row's head-averaged probabilities once, float32) over the
peak bandwidth.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit: 989 TFLOP/s
dense bfloat16, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import maps as M
from .reference.nets import VAE, CLIPText, UNet, unet_levels
from .reference.sched import SAMPLERS

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def count(fn) -> float:
    with FlopCounterMode(display=False) as c:
        fn()
    return float(c.get_total_flops())


def latent_hw(cfg: dict):
    s = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    return cfg["pipeline"]["height"] // s, cfg["pipeline"]["width"] // s


def unet_flops(cfg: dict, batch: int) -> float:
    h, w = latent_hw(cfg)
    u = cfg["unet"]
    with torch.device("meta"):
        net = UNet(u)
        x = torch.empty(batch, h, w, u["in_channels"])
        ctx = torch.empty(batch, 77, u["cross_attention_dim"])
        added = None
        if u.get("addition_embed_type") == "text_time":
            pool = (u["projection_class_embeddings_input_dim"]
                    - 6 * u["addition_time_embed_dim"])
            added = {"text_embeds": torch.empty(batch, pool),
                     "time_ids": torch.empty(1, 6)}
        t = torch.zeros(())
    with torch.no_grad():
        return count(lambda: net(x, t, ctx, added))


def text_flops(tcfg: dict) -> float:
    with torch.device("meta"):
        net = CLIPText(tcfg)
        ids = torch.zeros(1, 77, dtype=torch.long)
    with torch.no_grad():
        return count(lambda: net(ids, 0))


def decode_flops(cfg: dict) -> float:
    h, w = latent_hw(cfg)
    with torch.device("meta"):
        vae = VAE(cfg["vae"])
        z = torch.empty(1, h, w, cfg["vae"]["latent_channels"])
    with torch.no_grad():
        return count(lambda: vae.images(z))


def guided_flops(cfg: dict, spans: int) -> float:
    h, w = latent_hw(cfg)
    H, W = cfg["pipeline"]["height"], cfg["pipeline"]["width"]
    with torch.device("meta"):
        vae = VAE(cfg["vae"]).requires_grad_(False)
        m = torch.empty(spans, H, W)
        rgb = torch.empty(spans, 3)

    def run():
        with torch.enable_grad():
            lat = torch.empty(1, h, w, 4, device="meta", requires_grad=True)
            img = vae.images(lat * 2.0)
            mean = torch.einsum("bhwc,nhw->nc", img, m) / m.sum(dim=(1, 2))[
                :, None]
            loss = ((mean - rgb) ** 2).mean(1).sum()
            torch.autograd.grad(loss, lat)

    return count(run)


def plan(cfg: dict, traffic: dict, inp: dict) -> dict:
    """What one sample runs, from the reference's plan: steps, rich rows
    R+2, the colour-guided steps and the steps whose maps are captured."""
    p = cfg["pipeline"]
    s = SAMPLERS[p["sampler"]](p["steps"])
    S = len(s.timesteps)
    colour = bool(inp["color_ids"])
    start = traffic["flags"].get("guidance_start_step", 999)
    guided = [i for i in range(S)
              if colour and int(s.timesteps[i]) < start]
    xl = p["model"] == "SDXL"
    a = p["agg_start_step"]
    capture_steps = list(range(a, S)) if xl else [S - 1]
    return dict(steps=S, rich_rows=len(inp["region_prompts"]) + 1,
                guided=guided, capture_steps=capture_steps, xl=xl)


def sample_flops(cfg: dict, traffic: dict, inp: dict) -> float:
    """FLOPs of one sample."""
    pl = plan(cfg, traffic, inp)
    total = pl["steps"] * (unet_flops(cfg, 2)
                           + unet_flops(cfg, pl["rich_rows"]))
    towers = [cfg["text_encoder"]] + (
        [cfg["text_encoder_2"]] if "text_encoder_2" in cfg else [])
    neg = traffic.get("negative_prompt", "")
    # each prompt alone: plain [neg, base], rich [neg, spans..., base];
    # SDXL's empty negative prompt is zero rows, not encoded
    prompts = 1 + len(inp["region_prompts"])
    negs = 0 if (pl["xl"] and neg == "") else 2
    total += (prompts + negs) * sum(text_flops(t) for t in towers)
    total += 2 * decode_flops(cfg)
    if pl["guided"]:
        total += len(pl["guided"]) * guided_flops(cfg, len(inp["color_ids"]))
    return total


def attn_calls(cfg: dict, traffic: dict, inp: dict):
    """(count, B, H, S, d, capture) of every self-attention call of one
    sample, grouped by shape."""
    pl = plan(cfg, traffic, inp)
    u = cfg["unet"]
    h, w = latent_hw(cfg)
    rows = M.layer_rows(u, h)
    heads, _ = unet_levels(u)
    chans = list(u["block_out_channels"])
    L = len(chans)
    self_layers, _ = M.capture_layout(u, h, pl["xl"])
    calls: dict = {}

    def level(name):
        part, _, rest = name.partition(".")
        if part == "mid_block":
            return L - 1
        lvl = int(rest.split(".")[0])
        return lvl if part == "down_blocks" else L - 1 - lvl

    def add(key, n):
        calls[key] = calls.get(key, 0) + n

    S_steps, ncap = pl["steps"], len(pl["capture_steps"])
    for name, r in rows.items():
        if not name.endswith(".attn1"):
            continue
        lv = level(name)
        H, d = heads[lv], chans[lv] // heads[lv]
        S = r * (r * w // h)
        # the plain pass [uncond, base], its capture layers on the capture
        # steps; the rich pass [uncond, spans..., base]
        cap = ncap if name in self_layers else 0
        add((2, H, S, d, True), cap)
        add((2, H, S, d, False), S_steps - cap)
        add((pl["rich_rows"], H, S, d, False), S_steps)
    return [(n, *k) for k, n in sorted(calls.items()) if n]


def attn_bound_seconds(cfg: dict, traffic: dict, inp: dict) -> float:
    """The least time, on the data sheet's peaks, of one sample's
    self-attention and capture work."""
    total = 0.0
    for n, B, H, S, d, cap in attn_calls(cfg, traffic, inp):
        fl = 4.0 * B * H * S * S * d
        by = 4.0 * B * H * S * d * 2 + (S * S * 4 if cap else 0)
        total += n * max(fl / PEAK_FLOPS, by / PEAK_BYTES)
    return total
