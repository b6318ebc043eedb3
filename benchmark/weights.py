"""The weights of a cell, drawn on the card from the seed: the same state
dicts go to the program and to the reference.

The rule is the program's random init (``models/init_utils.fast_init`` of
the original package): ones for norm weights, zeros for biases, N(0,
1/fan_in) elsewhere, fan_in counted over all but the output dimension (the
row count for an embedding table). Each network is drawn in a few large
calls of a ``torch.Generator`` on the card, in the dtype it is served in:
the UNet in bfloat16, the rest in float32. Parameter names and shapes come
from the reference's modules built on the meta device.
"""

from __future__ import annotations

import hashlib
import time

import torch
from torch import nn

from .reference.nets import VAE, CLIPText, UNet

CHUNK = 1 << 28  # elements drawn by one call


def derive(seed: int, what) -> int:
    """A 48-bit seed for one use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).hexdigest()
    return int(h[:12], 16)


def networks(cfg: dict) -> dict:
    """{state-dict name: reference module on the meta device}."""
    with torch.device("meta"):
        nets = {"unet": UNet(cfg["unet"]), "vae": VAE(cfg["vae"]),
                "text_encoder": CLIPText(cfg["text_encoder"])}
        if "text_encoder_2" in cfg:
            nets["text_encoder_2"] = CLIPText(cfg["text_encoder_2"])
    return nets


def _fan_in(mod, p) -> int:
    if isinstance(mod, nn.Embedding):
        return p.shape[0]
    n = 1
    for s in p.shape[1:]:
        n *= s
    return max(n, 1)


@torch.no_grad()
def draw(module: nn.Module, seed: int, device, dtype) -> dict:
    """{name: tensor} for every parameter of ``module`` (on the meta
    device), drawn on ``device`` in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out, todo = {}, []
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if pname == "bias":
                out[name] = torch.zeros(p.shape, device=device, dtype=dtype)
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                out[name] = torch.ones(p.shape, device=device, dtype=dtype)
            else:
                todo.append((name, p.shape, _fan_in(mod, p)))
    i = 0
    while i < len(todo):
        j, n = i, 0
        while j < len(todo) and (j == i or n + todo[j][1].numel() <= CHUNK):
            n += todo[j][1].numel()
            j += 1
        flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
        at = 0
        for name, shape, fan in todo[i:j]:
            k = shape.numel()
            out[name] = flat[at:at + k].view(shape).mul_(fan ** -0.5)
            at += k
        i = j
    return out


def draw_state(cfg: dict, seed: int, device, log=None) -> dict:
    """{network: state dict} of a configuration, from the run's seed;
    ``log`` (a callable) gets the seconds each part took."""
    unet_dtype = getattr(torch, cfg["precision"]["unet"])
    t = time.perf_counter()
    nets = networks(cfg)
    took = {"meta modules": time.perf_counter() - t}
    out = {}
    for name, mod in nets.items():
        t = time.perf_counter()
        out[name] = draw(mod, derive(seed, f"weights:{name}"), device,
                         unet_dtype if name == "unet" else torch.float32)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        took[name] = time.perf_counter() - t
    if log is not None:
        log("weights drawn: " + ", ".join(f"{k} {v:.3f} s"
                                          for k, v in took.items()))
    return out
