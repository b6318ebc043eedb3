"""AutoencoderKL (the SD VAE) in PyTorch.

Counterpart of ``rich_text_to_image_tpu/models/vae.py``, with diffusers'
module names (``decoder.up_blocks.{i}.resnets.{j}``,
``decoder.mid_block.attentions.0.to_q`` ...). Public layout is NHWC; inside,
NCHW. Runs in float32, by the precision policy. The decoder is the gradient
path of colour guidance: the pipeline differentiates through it with
``torch.autograd.grad``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import VAEConfig

_EPS = 1e-6  # the VAE's GroupNorm eps (as in the JAX package)


class VAEResnet(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=_EPS)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=_EPS)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention (the mid block's)."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=_EPS)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        s = torch.einsum("bqc,bkc->bqk", q, k).float()
        p = torch.softmax(s * C ** -0.5, dim=-1).to(x.dtype)
        o = self.to_out[0](torch.einsum("bqk,bkc->bqc", p, v))
        return x + o.reshape(B, H, W, C).permute(0, 3, 1, 2)


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch, groups),
                                      VAEResnet(ch, ch, groups)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _Sampler(nn.Module):
    def __init__(self, ch: int, stride: int, pad: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=pad)


class _Block(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            VAEResnet(in_ch if j == 0 else out_ch, out_ch, groups)
            for j in range(n)])


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        blocks, prev = [], chs[0]
        for lvl, ch in enumerate(chs):
            blk = _Block(prev, ch, cfg.layers_per_block, g)
            if lvl != len(chs) - 1:
                blk.downsamplers = nn.ModuleList([_Sampler(ch, 2, 0)])
            blocks.append(blk)
            prev = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(chs[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=_EPS)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                # diffusers' encoder downsample: asymmetric (0, 1) padding
                x = blk.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], g)
        blocks, prev = [], rev[0]
        for lvl, ch in enumerate(rev):
            blk = _Block(prev, ch, cfg.layers_per_block + 1, g)
            if lvl != len(rev) - 1:
                blk.upsamplers = nn.ModuleList([_Sampler(ch, 1, 1)])
            blocks.append(blk)
            prev = ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=_EPS)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = F.interpolate(x, scale_factor=2.0, mode="nearest")
                x = blk.upsamplers[0].conv(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        # FLUX.1's VAE has neither 1x1 conv (use_*quant_conv false); a
        # config without the fields (the JAX package's) has both
        self.quant_conv = (nn.Conv2d(2 * cfg.latent_channels,
                                     2 * cfg.latent_channels, 1)
                           if getattr(cfg, "use_quant_conv", True) else None)
        self.post_quant_conv = (
            nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
            if getattr(cfg, "use_post_quant_conv", True) else None)
        self.shift_factor = getattr(cfg, "shift_factor", 0.0)

    def encode_moments(self, x):
        """Pixels in [-1, 1], NHWC -> (mean, logvar), each NHWC
        [B, h, w, latent], logvar clamped to [-30, 20]."""
        moments = self.encoder(x.permute(0, 3, 1, 2))
        if self.quant_conv is not None:
            moments = self.quant_conv(moments)
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x, generator: torch.Generator | None = None):
        """Pixels in [-1, 1], NHWC -> *scaled* latent NHWC, (z - shift) x
        scale: a sample drawn with ``generator``, or the mean when it is
        None."""
        mean, logvar = self.encode_moments(x)
        if generator is not None:
            b, h, w, c = mean.shape  # drawn in the encoder's NCHW layout
            mean = mean + torch.exp(0.5 * logvar) * torch.randn(
                (b, c, h, w), generator=generator, device=mean.device,
                dtype=mean.dtype).permute(0, 2, 3, 1)
        return (mean - self.shift_factor) * self.cfg.scaling_factor

    def unscale(self, latents):
        """Scaled latents -> the decoder's: latents / scale + shift."""
        return latents / self.cfg.scaling_factor + self.shift_factor

    def decode(self, z):
        """*Unscaled* latent NHWC -> pixels in [-1, 1], NHWC."""
        z = z.permute(0, 3, 1, 2)
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z).permute(0, 2, 3, 1)
