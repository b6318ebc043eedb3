"""FLUX.1-dev's networks for the plain reference, written from the
published equations (diffusers' ``FluxTransformer2DModel``, transformers'
``T5EncoderModel``, ``AutoencoderKL`` without quant convs), with the
parameter names of those checkpoints, so that one drawn state dict fills
the program and the reference alike.

Everything computes in float32. The weights stay as drawn (bfloat16 for the
transformer and T5) and each matrix is upcast where it is used, so that
the reference fits on the card beside the state it reads. ``ROUND`` (None
here) is the control's: a function applied to each matrix product's two
operands (``Lin``).

Departures from the program, each deliberate: no bfloat16 anywhere (the
program casts after each norm and product); the attention is explicit
softmax(Q K^T / sqrt d) V with the probabilities in memory, and the
capture their head average; the RoPE tables and the sinusoids in float64
before a cast to float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nets import _Coder

ROUND = {"fn": None}  # the control sets a rounding of both operands


class Lin(nn.Module):
    """y = x W^T + b in float32, W upcast from its stored dtype."""

    def __init__(self, i: int, o: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i))
        self.bias = nn.Parameter(torch.empty(o)) if bias else None

    def forward(self, x):
        w, x = self.weight.float(), x.float()
        r = ROUND["fn"]
        if r is not None:
            w, x = r(w), r(x)
        return F.linear(x, w, None if self.bias is None
                        else self.bias.float())


class Norm(nn.Module):
    """RMS norm with a weight (T5's layer norms, FLUX's q/k norms)."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
                * self.weight.float())


def layer_norm(x):
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6)


def sinusoid(t, dim: int = 256):
    """[cos, sin] of t e^(-ln(10000) k / (dim / 2)), k < dim / 2."""
    half = dim // 2
    f = np.exp(-math.log(10000.0) * np.arange(half) / half)
    a = t.double()[:, None] * torch.from_numpy(f).to(t.device)[None]
    return torch.cat([torch.cos(a), torch.sin(a)], -1).float()


def rope(axes, theta, txt, gh, gw, device):
    """(cos, sin) [txt + gh gw, sum(axes)] over ids [0 ; (0, i, j)]."""
    ids = np.zeros((txt + gh * gw, 3))
    ids[txt:, 1] = np.repeat(np.arange(gh), gw)
    ids[txt:, 2] = np.tile(np.arange(gw), gh)
    cos, sin = [], []
    for i, d in enumerate(axes):
        a = np.outer(ids[:, i], theta ** (-np.arange(0, d, 2) / d))
        cos.append(np.repeat(np.cos(a), 2, 1))
        sin.append(np.repeat(np.sin(a), 2, 1))
    return (torch.from_numpy(np.concatenate(cos, 1)).float().to(device),
            torch.from_numpy(np.concatenate(sin, 1)).float().to(device))


def rotate(x, cos, sin):
    """Pairs (x_2k, x_2k+1) turned by the angle: x [B, H, S, D]."""
    a, b = x[..., 0::2], x[..., 1::2]
    rot = torch.stack([-b, a], -1).flatten(-2)
    return x * cos + rot * sin


class Pool:
    """Summed head averages of the image queries' attention: image->image
    pooled k x k on both axes, image->text pooled on the queries."""

    def __init__(self, txt, gh, gw, k=2):
        self.txt, self.gh, self.gw, self.k = txt, gh, gw, k
        self.self_sum = self.cross = 0

    def add(self, pavg):  # [S, S], one row's head average
        T, k = self.txt, self.k
        sh, sw = self.gh // k, self.gw // k
        img = pavg[T:]
        ii = img[:, T:].reshape(sh, k, sw, k, sh, k, sw, k).mean((1, 3, 5, 7))
        it = img[:, :T].reshape(sh, k, sw, k, T).mean((1, 3))
        self.self_sum = self.self_sum + ii.reshape(sh * sw, sh * sw)
        self.cross = self.cross + it.reshape(sh * sw, T)


def attention(q, k, v, pool=None):
    """q, k, v [B, H, S, D]; the capture reads batch row 0."""
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k)
                      / math.sqrt(q.shape[-1]), -1)
    if pool is not None:
        pool.add(p[0].mean(0))
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o.transpose(1, 2).flatten(2)


class _Emb(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.linear_1, self.linear_2 = Lin(i, o), Lin(o, o)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _Ada(nn.Module):
    def __init__(self, d, n):
        super().__init__()
        self.linear, self.n = Lin(d, n * d), n

    def forward(self, temb):
        return self.linear(F.silu(temb))[:, None].chunk(self.n, -1)


class _FF(nn.Module):
    def __init__(self, d, inner):
        super().__init__()
        p = nn.Module()
        p.proj = Lin(d, inner)
        self.net = nn.ModuleList([p, nn.Identity(), Lin(inner, d)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class _Attn(nn.Module):
    def __init__(self, d, hd, dual):
        super().__init__()
        self.hd = hd
        self.to_q, self.to_k, self.to_v = Lin(d, d), Lin(d, d), Lin(d, d)
        self.norm_q, self.norm_k = Norm(hd), Norm(hd)
        if dual:
            self.add_q_proj, self.add_k_proj = Lin(d, d), Lin(d, d)
            self.add_v_proj = Lin(d, d)
            self.norm_added_q, self.norm_added_k = Norm(hd), Norm(hd)
            self.to_out = nn.ModuleList([Lin(d, d)])
            self.to_add_out = Lin(d, d)

    def heads(self, x, lin, norm=None):
        B, S, _ = x.shape
        y = lin(x).view(B, S, -1, self.hd)
        return (y if norm is None else norm(y)).transpose(1, 2)

    def forward(self, x, c, rp, pool=None):
        q = self.heads(x, self.to_q, self.norm_q)
        k = self.heads(x, self.to_k, self.norm_k)
        v = self.heads(x, self.to_v)
        if c is not None:  # text first
            q = torch.cat([self.heads(c, self.add_q_proj, self.norm_added_q),
                           q], 2)
            k = torch.cat([self.heads(c, self.add_k_proj, self.norm_added_k),
                           k], 2)
            v = torch.cat([self.heads(c, self.add_v_proj), v], 2)
        o = attention(rotate(q, *rp), rotate(k, *rp), v, pool)
        if c is None:
            return o
        T = c.shape[1]
        return self.to_out[0](o[:, T:]), self.to_add_out(o[:, :T])


class _Double(nn.Module):
    def __init__(self, d, hd, inner):
        super().__init__()
        self.norm1, self.norm1_context = _Ada(d, 6), _Ada(d, 6)
        self.attn = _Attn(d, hd, True)
        self.ff, self.ff_context = _FF(d, inner), _FF(d, inner)

    def forward(self, x, c, temb, rp, pool):
        s1, c1, g1, s2, c2, g2 = self.norm1(temb)
        t1, d1, h1, t2, d2, h2 = self.norm1_context(temb)
        a, ca = self.attn(layer_norm(x) * (1 + c1) + s1,
                          layer_norm(c) * (1 + d1) + t1, rp, pool)
        x = x + g1 * a
        x = x + g2 * self.ff(layer_norm(x) * (1 + c2) + s2)
        c = c + h1 * ca
        c = c + h2 * self.ff_context(layer_norm(c) * (1 + d2) + t2)
        return x, c


class _Single(nn.Module):
    def __init__(self, d, hd, inner):
        super().__init__()
        self.norm = _Ada(d, 3)
        self.proj_mlp = Lin(d, inner)
        self.attn = _Attn(d, hd, False)
        self.proj_out = Lin(d + inner, d)

    def forward(self, x, temb, rp):
        s, c, g = self.norm(temb)
        h = layer_norm(x) * (1 + c) + s
        m = F.gelu(self.proj_mlp(h), approximate="tanh")
        return x + g * self.proj_out(torch.cat([self.attn(h, None, rp), m], -1))


class _NormOut(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.linear = Lin(d, 2 * d)

    def forward(self, x, temb):
        scale, shift = self.linear(F.silu(temb))[:, None].chunk(2, -1)
        return layer_norm(x) * (1 + scale) + shift


class _TimeText(nn.Module):
    def __init__(self, cfg, d):
        super().__init__()
        self.timestep_embedder = _Emb(256, d)
        if cfg["guidance_embeds"]:
            self.guidance_embedder = _Emb(256, d)
        self.text_embedder = _Emb(cfg["pooled_projection_dim"], d)


class Transformer(nn.Module):
    """``FluxTransformer2DModel`` of a diffusers config dict."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        hd = cfg["attention_head_dim"]
        d = cfg["num_attention_heads"] * hd
        inner = 4 * d
        self.x_embedder = Lin(cfg["in_channels"], d)
        self.context_embedder = Lin(cfg["joint_attention_dim"], d)
        self.time_text_embed = _TimeText(cfg, d)
        self.transformer_blocks = nn.ModuleList(
            [_Double(d, hd, inner) for _ in range(cfg["num_layers"])])
        self.single_transformer_blocks = nn.ModuleList(
            [_Single(d, hd, inner) for _ in range(cfg["num_single_layers"])])
        self.norm_out = _NormOut(d)
        self.proj_out = Lin(d, cfg["in_channels"])

    def forward(self, x, sigma: float, ctx, pooled, guidance: float,
                grid, pool=None, double_only=False):
        """x [B, gh gw, 64] -> velocity [B, gh gw, 64]; ``pool`` takes the
        double blocks' maps; ``double_only`` stops after them (None)."""
        B, T, dev = x.shape[0], ctx.shape[1], x.device
        te = self.time_text_embed
        temb = te.timestep_embedder(sinusoid(
            torch.full((B,), 1000.0 * sigma, dtype=torch.float64,
                       device=dev)))
        if self.cfg["guidance_embeds"]:
            temb = temb + te.guidance_embedder(sinusoid(torch.full(
                (B,), 1000.0 * guidance, dtype=torch.float64, device=dev)))
        temb = temb + te.text_embedder(pooled)
        h, c = self.x_embedder(x), self.context_embedder(ctx)
        rp = rope(self.cfg["axes_dims_rope"], 10000.0, T, *grid, dev)
        for blk in self.transformer_blocks:
            h, c = blk(h, c, temb, rp, pool)
        if double_only:
            return None
        h = torch.cat([c, h], 1)
        for blk in self.single_transformer_blocks:
            h = blk(h, temb, rp)
        return self.proj_out(self.norm_out(h[:, T:], temb))


# ------------------------------------------------------------------- T5
class _T5Attn(nn.Module):
    def __init__(self, cfg, bias):
        super().__init__()
        d, inner = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"]
        self.cfg = cfg
        self.q, self.k = Lin(d, inner, False), Lin(d, inner, False)
        self.v, self.o = Lin(d, inner, False), Lin(inner, d, False)
        if bias:
            n = cfg["relative_attention_num_buckets"]
            self.relative_attention_bias = nn.Embedding(
                n, cfg["num_heads"], _weight=torch.empty(n, cfg["num_heads"]))

    def bias(self, S, dev):
        """[1, H, S, S]: the bias of the bucket of each key-minus-query
        offset, both directions, exact below 8, logarithmic up to 128."""
        c = self.cfg
        rel = (torch.arange(S, device=dev)[None]
               - torch.arange(S, device=dev)[:, None])
        half = c["relative_attention_num_buckets"] // 2
        exact = half // 2
        mag = rel.abs()
        # in float32, as transformers computes it: the floor of a log
        # lands on the other bucket at some offsets in float64
        far = exact + (torch.log(mag.clamp_min(1).float() / exact)
                       / math.log(c["relative_attention_max_distance"] / exact)
                       * (half - exact)).long()
        bucket = (rel > 0).long() * half + torch.where(
            mag < exact, mag, far.clamp(max=half - 1))
        w = self.relative_attention_bias.weight.float()
        return w[bucket].permute(2, 0, 1)[None]

    def forward(self, x, pb):
        B, S, _ = x.shape

        def sp(t):
            return t.view(B, S, self.cfg["num_heads"], -1).transpose(1, 2)

        q, k, v = sp(self.q(x)), sp(self.k(x)), sp(self.v(x))
        p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) + pb, -1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v)
        return self.o(o.transpose(1, 2).flatten(2))


class _T5Block(nn.Module):
    def __init__(self, cfg, bias):
        super().__init__()
        a, f = nn.Module(), nn.Module()
        a.SelfAttention = _T5Attn(cfg, bias)
        a.layer_norm = Norm(cfg["d_model"], cfg["layer_norm_epsilon"])
        f.DenseReluDense = nn.Module()
        d, ff = cfg["d_model"], cfg["d_ff"]
        f.DenseReluDense.wi_0 = Lin(d, ff, False)
        f.DenseReluDense.wi_1 = Lin(d, ff, False)
        f.DenseReluDense.wo = Lin(ff, d, False)
        f.layer_norm = Norm(d, cfg["layer_norm_epsilon"])
        self.layer = nn.ModuleList([a, f])

    def forward(self, x, pb):
        a, f = self.layer
        x = x + a.SelfAttention(a.layer_norm(x), pb)
        r = f.DenseReluDense
        h = f.layer_norm(x)
        return x + r.wo(F.gelu(r.wi_0(h), approximate="tanh") * r.wi_1(h))


class T5(nn.Module):
    """T5 v1.1's encoder of a transformers config dict; no attention
    mask."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.shared = nn.Embedding(cfg["vocab_size"], cfg["d_model"],
                                   _weight=torch.empty(cfg["vocab_size"],
                                                       cfg["d_model"]))
        self.encoder = nn.Module()
        self.encoder.block = nn.ModuleList(
            [_T5Block(cfg, i == 0) for i in range(cfg["num_layers"])])
        self.encoder.final_layer_norm = Norm(cfg["d_model"],
                                             cfg["layer_norm_epsilon"])

    def forward(self, ids):
        x = self.shared.weight.float()[ids]
        blocks = self.encoder.block
        pb = blocks[0].layer[0].SelfAttention.bias(ids.shape[1], ids.device)
        for b in blocks:
            x = b(x, pb)
        return self.encoder.final_layer_norm(x)


# ------------------------------------------------------------------ VAE
class VAE(nn.Module):
    """AutoencoderKL with no quant convs; latents are (z - shift) x
    scale."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Coder(cfg, down=True)
        self.decoder = _Coder(cfg, down=False)

    def images(self, latents):
        """Scaled latents NHWC -> images in [0, 1] NHWC, float32."""
        z = (latents.float() / self.cfg["scaling_factor"]
             + self.cfg["shift_factor"])
        x = self.decoder(z.permute(0, 3, 1, 2))
        return (x.permute(0, 2, 3, 1) / 2 + 0.5).clamp(0.0, 1.0)
