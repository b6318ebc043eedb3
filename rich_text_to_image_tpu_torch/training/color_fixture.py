"""Train the colour fixture: a tiny VAE and UNet whose colour steering is
real.

Counterpart of ``scripts/train_color_fixture.py``. On synthetic images (a
solid background and one coloured square) it trains

  1. the TINY_VAE: reconstruction plus 1e-4·KL through ``encode_moments``
     and a reparameterised draw, Adam lr 2e-3, so that decode is
     colour-faithful;
  2. the FIXTURE_UNET: ε-prediction (denoising score matching, t in [0,
     1000)) on the trained VAE's mean latents, conditioned on "a <colour>
     square" through the frozen random tiny text encoder (the port's
     ``random_init(seed=0)``) and the byte-level tokenizer, 20% of the rows
     unconditional, Adam lr 1e-3;

then writes ``unet_params.npz`` and ``vae_params.npz`` (float16, the JAX
package's flax paths through ``weights.to_flax``, so that both packages'
``load_color_fixture`` read them) and ``fixture_meta.json`` with the JAX
script's keys. The images come from the JAX script's ``np.random.
RandomState(0)`` stream, so the batches are the same arrays; the draws of the
reparameterisation, ``t`` and the noise come from a ``torch.Generator`` of
the device seeded with 0 (not the JAX package's numbers). Attention runs
through the plain ops (``ops.attention.plain_attention``): the hand-written
kernels have no backward pass.

    python scripts/port_train_color_fixture.py [--device cuda]
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .. import weights
from ..models import config as cfgs
from ..ops.attention import plain_attention
from ..schedulers.common import make_alphas_cumprod
from ..utils.colors import COLORS

OUT_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "results", "color_fixture_torch"))
VAE_LR, UNET_LR, KL_WEIGHT, UNCOND_SHARE = 2e-3, 1e-3, 1e-4, 0.2
WARM_STEPS = 3  # eager steps before a card captures the step as a graph


def make_batch(rng: np.random.RandomState, n: int, px: int):
    """Synthetic data: a solid background and one coloured axis-aligned
    square. Returns images [n,px,px,3] in [-1,1], the squares' colour names
    (for the prompt) and their RGB in [0,1]."""
    names = list(COLORS)
    imgs = np.empty((n, px, px, 3), np.float32)
    fg_names = []
    fg_rgb = np.empty((n, 3), np.float32)
    for i in range(n):
        name = names[rng.randint(len(names))]
        fg = np.asarray(COLORS[name], np.float32) / 255.0
        # jitter the named colour a little so the manifold isn't 11 points
        fg = np.clip(fg + rng.uniform(-0.08, 0.08, 3).astype(np.float32), 0, 1)
        bg = rng.uniform(0, 1, 3).astype(np.float32)
        img = np.broadcast_to(bg, (px, px, 3)).copy()
        side = rng.randint(px // 2, px - 2)
        y = rng.randint(0, px - side)
        x = rng.randint(0, px - side)
        img[y:y + side, x:x + side] = fg
        imgs[i] = img * 2.0 - 1.0
        fg_names.append(name)
        fg_rgb[i] = fg
    return imgs, fg_names, fg_rgb


def adam(params, lr: float, capturable: bool = False) -> torch.optim.Adam:
    """optax's ``adam``: betas 0.9 and 0.999, eps 1e-8 outside the square
    root, bias-corrected, no weight decay; ``capturable`` keeps its step
    count on the card, as a CUDA graph of the step needs."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


def vae_loss(vae, imgs: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Reconstruction MSE of the reparameterised sample ``mean +
    exp(logvar / 2)·eps``, plus KL_WEIGHT times the mean KL to N(0, 1)."""
    mean, logvar = vae.encode_moments(imgs)
    rec = vae.decode(mean + torch.exp(0.5 * logvar) * eps)
    kl = 0.5 * torch.mean(mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
    return torch.mean((rec - imgs) ** 2) + KL_WEIGHT * kl


def dsm_loss(unet, alphas: torch.Tensor, lat: torch.Tensor,
             ehs: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """ε-prediction MSE at timesteps ``t`` [B] with ``noise`` of the
    latents' shape."""
    a = alphas[t][:, None, None, None]
    x_t = torch.sqrt(a) * lat + torch.sqrt(1.0 - a) * noise
    with plain_attention():
        eps, _ = unet(x_t, t, ehs)
    return torch.mean((eps - noise) ** 2)


def step(opt: torch.optim.Optimizer, loss: torch.Tensor) -> torch.Tensor:
    """One optimiser step on ``loss``; returns it detached."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def solid_color_roundtrip(model) -> float:
    """Mean |ΔRGB| in [0, 1] units of the solid colour images of every
    named colour through ``encode`` (the mean) and ``decode``."""
    px = model.unet_cfg.sample_size * model.vae_scale_factor
    probe = torch.from_numpy(np.stack([
        np.full((px, px, 3), c, np.float32) * 2 - 1
        for c in np.asarray(list(COLORS.values()), np.float32) / 255.0
    ])).to(model.device)
    with torch.no_grad():
        z = model.vae.encode(probe)
        rt = model.vae.decode(z / model.vae_cfg.scaling_factor)
    return float((rt - probe).abs().mean()) / 2.0


def _save_npz(path: str, module, which: str) -> None:
    flat = {"/".join(k): v.astype(np.float16) for k, v in
            weights._flatten(weights.to_flax(module, which)).items()}
    np.savez_compressed(path, **flat)


def run_steps(n: int, load, one_step, dev: torch.device, log) -> torch.Tensor:
    """``n`` training steps: ``load(i)`` writes step i's inputs into the
    tensors that ``one_step()`` reads, ``one_step()`` takes one optimiser
    step on them and returns its loss, ``log(i, loss)`` follows each step.
    On a card the steps after the first WARM_STEPS (eager, on a side
    stream) replay one CUDA graph of ``one_step``: at the fixture's size a
    step is hundreds of small kernels, which the host cannot launch as fast
    as the card runs them. Elsewhere every step runs eagerly. Returns the
    last loss."""
    graph, loss = None, torch.zeros(())
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    for i in range(n):
        load(i)
        if side is None:
            loss = one_step()
        elif i < WARM_STEPS:
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                loss = one_step()
            torch.cuda.current_stream(dev).wait_stream(side)
        else:
            if graph is None:  # capture records the step without running it
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    loss = one_step()
            graph.replay()
        log(i, loss)
    return loss


def train(vae_steps: int = 1500, unet_steps: int = 4000, batch: int = 64,
          out_dir: str = OUT_DIR, device="cuda") -> dict:
    """Both stages, then the fixture written to ``out_dir``. Returns the
    meta (as written), the stages' seconds and last losses, and the trained
    pipeline (float32, on ``device``)."""
    from ..pipelines.region_sd import RegionDiffusion

    t_start = time.time()
    dev = torch.device(device)
    model = RegionDiffusion.random_init(
        seed=0, unet_cfg=cfgs.FIXTURE_UNET, vae_cfg=cfgs.TINY_VAE,
        text_cfg=cfgs.TINY_TEXT, dtype=torch.float32, device=dev)
    px = model.unet_cfg.sample_size * model.vae_scale_factor
    h = model.unet_cfg.sample_size
    vae, unet = model.vae, model.unet
    rng_np = np.random.RandomState(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    graphs = dev.type == "cuda"
    # the steps' inputs, written in place each step (a graph reads them)
    imgs_s = torch.zeros((batch, px, px, 3), device=dev)
    noise_s = torch.zeros((batch, h, h, model.vae_cfg.latent_channels),
                          device=dev)

    def sync():
        if graphs:
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------ VAE stage
    vae.requires_grad_(True)
    opt = adam(vae.parameters(), VAE_LR, capturable=graphs)

    def load_vae(i):
        imgs_s.copy_(torch.from_numpy(make_batch(rng_np, batch, px)[0]))
        noise_s.normal_(generator=gen)

    def log_vae(i, loss):
        if i % 300 == 0 or i == vae_steps - 1:
            print(f"[vae {i}/{vae_steps}] recon+kl={float(loss):.5f}",
                  flush=True)

    sync()
    t0 = time.time()
    vae_loss_v = run_steps(vae_steps, load_vae, lambda: step(
        opt, vae_loss(vae, imgs_s, noise_s)), dev, log_vae)
    sync()
    vae_seconds = time.time() - t0
    vae.requires_grad_(False)
    color_err = solid_color_roundtrip(model)
    print(f"[vae] solid-color round-trip mean|dRGB| = {color_err:.4f}",
          flush=True)

    # ----------------------------------------------------------- UNet stage
    prompts = [""] + [f"a {n} square" for n in COLORS]
    ehs_bank = model.get_text_embeds(prompts[1:], prompts[:1])
    name_to_idx = {n: i + 1 for i, n in enumerate(COLORS)}
    alphas = torch.as_tensor(make_alphas_cumprod(), dtype=torch.float32,
                             device=dev)
    unet.requires_grad_(True)
    opt = adam(unet.parameters(), UNET_LR, capturable=graphs)
    pidx_s = torch.zeros((batch,), dtype=torch.int64, device=dev)
    t_s = torch.zeros((batch,), dtype=torch.int64, device=dev)

    def load_unet(i):
        imgs, names, _ = make_batch(rng_np, batch, px)
        # 20% unconditional rows for classifier-free guidance
        pidx = np.asarray([0 if rng_np.rand() < UNCOND_SHARE
                           else name_to_idx[n] for n in names], np.int64)
        imgs_s.copy_(torch.from_numpy(imgs))
        pidx_s.copy_(torch.from_numpy(pidx))
        t_s.random_(0, 1000, generator=gen)
        noise_s.normal_(generator=gen)

    def unet_step():
        with torch.no_grad():
            lat = vae.encode(imgs_s)  # the scaled mean latents
        return step(opt, dsm_loss(unet, alphas, lat, ehs_bank[pidx_s], t_s,
                                  noise_s))

    def log_unet(i, loss):
        if i % 500 == 0 or i == unet_steps - 1:
            print(f"[unet {i}/{unet_steps}] dsm={float(loss):.5f}",
                  flush=True)

    sync()
    t0 = time.time()
    dsm = run_steps(unet_steps, load_unet, unet_step, dev, log_unet)
    sync()
    unet_seconds = time.time() - t0
    unet.requires_grad_(False)

    # -------------------------------------------------------------- persist
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    _save_npz(os.path.join(out_dir, "unet_params.npz"), unet, "unet")
    _save_npz(os.path.join(out_dir, "vae_params.npz"), vae, "vae")
    meta = {
        "px": px,
        "vae_steps": vae_steps,
        "unet_steps": unet_steps,
        "batch": batch,
        "vae_solid_color_roundtrip_mean_abs_drgb": round(color_err, 5),
        "final_dsm_loss": round(float(dsm), 5),
        "prompt_bank": prompts,
        "configs": {"unet": "FIXTURE_UNET", "vae": "TINY_VAE",
                    "text": "TINY_TEXT, rich_text_to_image_tpu_torch "
                            "RegionDiffusion.random_init(seed=0)",
                    "tokenizer": "byte_level", "random_init_seed": 0,
                    "dtype": "float32"},
        "train_seconds": round(time.time() - t_start, 1),
    }
    with open(os.path.join(out_dir, "fixture_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return {"meta": meta, "vae_seconds": vae_seconds,
            "unet_seconds": unet_seconds, "vae_loss": float(vae_loss_v),
            "dsm_loss": float(dsm), "model": model}


def main(argv=None) -> dict:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--vae_steps", type=int, default=1500)
    p.add_argument("--unet_steps", type=int, default=4000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--out", default=OUT_DIR,
                   help="the fixture's directory (never the committed one)")
    a = p.parse_args(argv)
    res = train(a.vae_steps, a.unet_steps, a.batch, a.out, a.device)
    print(json.dumps(res["meta"]), flush=True)
    return res
