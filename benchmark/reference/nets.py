"""The networks of the plain reference: the SD-1.5 / SDXL UNet, the VAE and
the CLIP text towers, in plain PyTorch with diffusers' parameter names, so
that the state dict the benchmark draws loads into them as it loads into
the program. A frozen copy of the program's module code at the time the
benchmark was written, with its kernels, tensor parallelism and dual
transformer taken out: attention is an explicit softmax in float32.

Layouts: latents NHWC in and out, NCHW inside. The UNet computes in the
dtype of its parameters (float32 for the reference). What the rich-text
method adds to the UNet goes in through ``Controls``:

  * ``capture_self`` / ``capture_cross``: layer names whose head-averaged
    attention probabilities go into ``aux["self"]`` / ``aux["cross"]``;
  * ``capture_qk`` / ``capture_resnet``: every attn1 layer's (Q, K)
    ``[B, H, S, hd]`` and the injected resnet's pre-residual feature
    (NCHW) go into ``aux["qk"]`` / ``aux["resnet"]``;
  * ``inject_qk`` / ``inject_resnet`` with ``inject_rows`` (d0, d1): rows
    d0:d1 attend with the given (Q, K) ``[1, H, S, hd]`` at every attn1
    layer and take the given feature at the injected resnet;
  * ``token_weights`` / ``token_signs`` ``[B, 77]``: the font-size
    reweighting of cross-attention, softmax(s + log w) * sign.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

INJECT_RESNET = "up_blocks.1.resnets.1"


@dataclasses.dataclass
class Controls:
    capture_self: frozenset = frozenset()
    capture_cross: frozenset = frozenset()
    capture_qk: bool = False
    capture_resnet: bool = False
    inject_qk: Optional[dict] = None
    inject_resnet: Optional[dict] = None
    inject_rows: Optional[tuple] = None
    token_weights: Optional[torch.Tensor] = None
    token_signs: Optional[torch.Tensor] = None


NO_CONTROLS = Controls()


def timestep_embedding(t, dim, flip=True, shift=0.0, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - shift))
    args = t.float()[..., None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip:
        emb = torch.cat([emb[..., half:], emb[..., :half]], dim=-1)
    return emb


def softmax_attention(q, k, v, scale, weights=None, signs=None):
    """(out in q's dtype, probs [B,H,Sq,Skv] float32), all in float32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if weights is not None:
        s = s + torch.log(weights.float()[:, None, None, :])
    p = torch.softmax(s, dim=-1)
    if signs is not None:
        p = p * signs.float()[:, None, None, :]
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype), p


class TimestepEmbedding(nn.Module):
    def __init__(self, i, d):
        super().__init__()
        self.linear_1, self.linear_2 = nn.Linear(i, d), nn.Linear(d, d)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _Conv(nn.Module):
    def __init__(self, ch, stride):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=1)

    def forward(self, x):
        return self.conv(x)


class ResnetBlock2D(nn.Module):
    def __init__(self, i, o, temb, groups, name):
        super().__init__()
        self.name = name
        self.norm1 = nn.GroupNorm(groups, i, eps=1e-5)
        self.conv1 = nn.Conv2d(i, o, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, o)
        self.norm2 = nn.GroupNorm(groups, o, eps=1e-5)
        self.conv2 = nn.Conv2d(o, o, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(i, o, 1) if i != o else None

    def forward(self, x, temb, c: Controls, aux):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.name == INJECT_RESNET:
            if c.capture_resnet:
                aux["resnet"] = h
            if c.inject_resnet is not None and self.name in c.inject_resnet:
                d0, d1 = c.inject_rows
                f = c.inject_resnet[self.name].to(h.dtype)
                h = torch.cat([h[:d0], f.expand(d1 - d0, *h.shape[1:]),
                               h[d1:]])
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim, heads, kv_dim=None, name=""):
        super().__init__()
        self.heads, self.dim, self.name = heads, dim, name
        kv = kv_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kv, dim, bias=False)
        self.to_v = nn.Linear(kv, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context, c: Controls, aux):
        B, S, _ = x.shape
        hd = self.dim // self.heads
        ctx = x if context is None else context

        def split(t):
            return t.view(B, t.shape[1], self.heads, hd).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(ctx)), split(
            self.to_v(ctx))
        if context is not None:
            o, p = softmax_attention(q, k, v, hd ** -0.5, c.token_weights,
                                     c.token_signs)
            if self.name in c.capture_cross:
                aux.setdefault("cross", {})[self.name] = p.mean(dim=1)
        else:
            if c.capture_qk:
                aux.setdefault("qk", {})[self.name] = (q, k)
            if c.inject_qk is not None and self.name in c.inject_qk:
                d0, d1 = c.inject_rows
                qi, ki = (t.to(q.dtype) for t in c.inject_qk[self.name])
                q = torch.cat([q[:d0], qi.expand(d1 - d0, *q.shape[1:]),
                               q[d1:]])
                k = torch.cat([k[:d0], ki.expand(d1 - d0, *k.shape[1:]),
                               k[d1:]])
            o, p = softmax_attention(q, k, v, hd ** -0.5)
            if self.name in c.capture_self:
                aux.setdefault("self", {})[self.name] = p.mean(dim=1)
        return self.to_out[0](o.transpose(1, 2).reshape(B, S, -1))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, kv_dim, name):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads, name=f"{name}.attn1")
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, heads, kv_dim, name=f"{name}.attn2")
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, context, c, aux):
        x = x + self.attn1(self.norm1(x), None, c, aux)
        x = x + self.attn2(self.norm2(x), context, c, aux)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, cfg, heads, dim, depth, name):
        super().__init__()
        self.linear = cfg["use_linear_projection"]
        self.norm = nn.GroupNorm(cfg["norm_num_groups"], dim, eps=1e-6)
        proj = ((lambda: nn.Linear(dim, dim)) if self.linear
                else (lambda: nn.Conv2d(dim, dim, 1)))
        self.proj_in, self.proj_out = proj(), proj()
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(dim, heads, cfg["cross_attention_dim"],
                                  f"{name}.transformer_blocks.{i}")
            for i in range(depth)])

    def forward(self, x, context, c, aux):
        B, C, H, W = x.shape
        h = self.norm(x)
        if self.linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context, c, aux)
        if self.linear:
            h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return h + x


class DownBlock(nn.Module):
    def __init__(self, cfg, i, o, temb, heads, depth, cross, down, name):
        super().__init__()
        n, g = cfg["layers_per_block"], cfg["norm_num_groups"]
        self.resnets = nn.ModuleList([
            ResnetBlock2D(i if j == 0 else o, o, temb, g, f"{name}.resnets.{j}")
            for j in range(n)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(cfg, heads, o, depth, f"{name}.attentions.{j}")
            for j in range(n)]) if cross else None
        self.downsamplers = nn.ModuleList([_Conv(o, 2)]) if down else None

    def forward(self, x, temb, context, c, aux):
        skips = []
        for j, res in enumerate(self.resnets):
            x = res(x, temb, c, aux)
            if self.attentions is not None:
                x = self.attentions[j](x, context, c, aux)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UpBlock(nn.Module):
    def __init__(self, cfg, prev, o, skip_chs, temb, heads, depth, cross, up,
                 name):
        super().__init__()
        n, g = cfg["layers_per_block"] + 1, cfg["norm_num_groups"]
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev if j == 0 else o) + skip_chs[j], o, temb, g,
                          f"{name}.resnets.{j}") for j in range(n)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(cfg, heads, o, depth, f"{name}.attentions.{j}")
            for j in range(n)]) if cross else None
        self.upsamplers = nn.ModuleList([_Conv(o, 1)]) if up else None

    def forward(self, x, skips, temb, context, c, aux):
        for j, res in enumerate(self.resnets):
            x = res(torch.cat([x, skips.pop()], dim=1), temb, c, aux)
            if self.attentions is not None:
                x = self.attentions[j](x, context, c, aux)
        if self.upsamplers is not None:
            x = self.upsamplers[0](F.interpolate(x, scale_factor=2.0,
                                                 mode="nearest"))
        return x


class MidBlock(nn.Module):
    def __init__(self, cfg, ch, temb, heads, depth):
        super().__init__()
        g = cfg["norm_num_groups"]
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, temb, g, f"mid_block.resnets.{j}")
            for j in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(cfg, heads, ch, depth, "mid_block.attentions.0")])

    def forward(self, x, temb, context, c, aux):
        x = self.resnets[0](x, temb, c, aux)
        x = self.attentions[0](x, context, c, aux)
        return self.resnets[1](x, temb, c, aux)


def unet_levels(cfg: dict):
    """(heads, transformer depth) of each level: diffusers keeps SD-1.5's
    head count in ``attention_head_dim``, and a scalar means every level."""
    L = len(cfg["block_out_channels"])

    def per_level(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * L

    heads = per_level(cfg.get("num_attention_heads")
                      or cfg["attention_head_dim"])
    return heads, per_level(cfg.get("transformer_layers_per_block", 1))


class UNet(nn.Module):
    """UNet2DConditionModel of a diffusers ``unet/config.json`` (a dict)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch0, L = cfg["block_out_channels"][0], len(cfg["block_out_channels"])
        temb = ch0 * 4
        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.text_time = cfg.get("addition_embed_type") == "text_time"
        if self.text_time:
            self.add_embedding = TimestepEmbedding(
                cfg["projection_class_embeddings_input_dim"], temb)
        self.conv_in = nn.Conv2d(cfg["in_channels"], ch0, 3, padding=1)
        heads, depth = unet_levels(cfg)
        down, skip_chs, prev = [], [ch0], ch0
        for lvl, kind in enumerate(cfg["down_block_types"]):
            ch, last = cfg["block_out_channels"][lvl], lvl == L - 1
            down.append(DownBlock(cfg, prev, ch, temb, heads[lvl], depth[lvl],
                                  kind == "CrossAttnDownBlock2D", not last,
                                  f"down_blocks.{lvl}"))
            skip_chs += [ch] * cfg["layers_per_block"] + ([] if last else [ch])
            prev = ch
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = MidBlock(cfg, prev, temb, heads[-1], depth[-1])
        up = []
        rev = list(reversed(cfg["block_out_channels"]))
        for lvl, kind in enumerate(cfg["up_block_types"]):
            mine = [skip_chs.pop() for _ in range(cfg["layers_per_block"] + 1)]
            up.append(UpBlock(cfg, prev, rev[lvl], mine, temb,
                              heads[L - 1 - lvl], depth[L - 1 - lvl],
                              kind == "CrossAttnUpBlock2D", lvl != L - 1,
                              f"up_blocks.{lvl}"))
            prev = rev[lvl]
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(cfg["norm_num_groups"], prev,
                                          eps=1e-5)
        self.conv_out = nn.Conv2d(prev, cfg["out_channels"], 3, padding=1)

    def forward(self, x, t, context, added=None, c: Controls = NO_CONTROLS):
        """x [B,h,w,4] -> (eps [B,h,w,4] float32, aux)."""
        dt, dev = self.conv_in.weight.dtype, self.conv_in.weight.device
        B = x.shape[0]
        cfg = self.cfg
        tt = torch.as_tensor(t, device=dev, dtype=torch.float32).expand(B)
        flip, shift = cfg["flip_sin_to_cos"], cfg["freq_shift"]
        emb = self.time_embedding(timestep_embedding(
            tt, cfg["block_out_channels"][0], flip, shift).to(dt))
        if self.text_time:
            ids = added["time_ids"].to(dev).float().expand(B, -1)
            te = timestep_embedding(
                ids.reshape(-1), cfg["addition_time_embed_dim"], flip,
                shift).reshape(B, -1)
            emb = emb + self.add_embedding(torch.cat(
                [added["text_embeds"].to(dt), te.to(dt)], dim=-1))
        aux: dict = {}
        context = context.to(dt)
        h = self.conv_in(x.to(dt).permute(0, 3, 1, 2))
        skips = [h]
        for blk in self.down_blocks:
            h, s = blk(h, emb, context, c, aux)
            skips += s
        h = self.mid_block(h, emb, context, c, aux)
        for blk in self.up_blocks:
            h = blk(h, skips, emb, context, c, aux)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1).float(), aux


# ----------------------------------------------------------------------- VAE
class VAEResnet(nn.Module):
    def __init__(self, i, o, g):
        super().__init__()
        self.norm1 = nn.GroupNorm(g, i, eps=1e-6)
        self.conv1 = nn.Conv2d(i, o, 3, padding=1)
        self.norm2 = nn.GroupNorm(g, o, eps=1e-6)
        self.conv2 = nn.Conv2d(o, o, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(i, o, 1) if i != o else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class VAEAttention(nn.Module):
    def __init__(self, ch, g):
        super().__init__()
        self.group_norm = nn.GroupNorm(g, ch, eps=1e-6)
        self.to_q, self.to_k = nn.Linear(ch, ch), nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        p = torch.softmax(torch.einsum("bqc,bkc->bqk", q, k) * C ** -0.5, -1)
        o = self.to_out[0](torch.einsum("bqk,bkc->bqc", p, v))
        return x + o.reshape(B, H, W, C).permute(0, 3, 1, 2)


class _VAEMid(nn.Module):
    def __init__(self, ch, g):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch, g),
                                      VAEResnet(ch, ch, g)])
        self.attentions = nn.ModuleList([VAEAttention(ch, g)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Sampler(nn.Module):
    def __init__(self, ch, stride, pad):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=stride, padding=pad)


class _VAEBlock(nn.Module):
    def __init__(self, i, o, n, g):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(i if j == 0 else o, o, g)
                                      for j in range(n)])


class _Coder(nn.Module):
    """The encoder (``down``) or decoder of AutoencoderKL; the encoder is
    here only so that the whole VAE's state dict loads."""

    def __init__(self, cfg, down: bool):
        super().__init__()
        g, n = cfg["norm_num_groups"], cfg["layers_per_block"]
        lat = cfg["latent_channels"]
        chs = list(cfg["block_out_channels"])
        if not down:
            chs = chs[::-1]
        self.conv_in = nn.Conv2d(cfg["in_channels"] if down else lat, chs[0],
                                 3, padding=1)
        if not down:
            self.mid_block = _VAEMid(chs[0], g)
        blocks, prev = [], chs[0]
        for lvl, ch in enumerate(chs):
            blk = _VAEBlock(prev, ch, n if down else n + 1, g)
            if lvl != len(chs) - 1:
                s = _Sampler(ch, 2, 0) if down else _Sampler(ch, 1, 1)
                if down:
                    blk.downsamplers = nn.ModuleList([s])
                else:
                    blk.upsamplers = nn.ModuleList([s])
            blocks.append(blk)
            prev = ch
        if down:
            self.down_blocks = nn.ModuleList(blocks)
            self.mid_block = _VAEMid(chs[-1], g)
        else:
            self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * lat if down
                                  else cfg["out_channels"], 3, padding=1)

    def forward(self, z):  # the decoder's
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(F.interpolate(
                    x, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        lat = cfg["latent_channels"]
        self.encoder = _Coder(cfg, down=True)
        self.decoder = _Coder(cfg, down=False)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def images(self, latents):
        """Scaled latents NHWC -> images in [0, 1] NHWC, float32."""
        z = latents.float() / self.cfg["scaling_factor"]
        x = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        return (x.permute(0, 2, 3, 1) / 2 + 0.5).clamp(0.0, 1.0)


# ---------------------------------------------------------------------- CLIP
class _CLIPAttention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, mask):
        B, S, D = x.shape
        hd = D // self.heads

        def split(t):
            return t.view(B, S, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x) * hd ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) + mask, -1)
        return self.out_proj(torch.einsum("bhqk,bhkd->bhqd", p, v)
                             .transpose(1, 2).reshape(B, S, D))


class _CLIPMLP(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.act = cfg["hidden_act"]
        self.fc1 = nn.Linear(cfg["hidden_size"], cfg["intermediate_size"])
        self.fc2 = nn.Linear(cfg["intermediate_size"], cfg["hidden_size"])

    def forward(self, x):
        h = self.fc1(x)
        h = (h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu"
             else F.gelu(h))
        return self.fc2(h)


class _CLIPLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.self_attn = _CLIPAttention(d, cfg["num_attention_heads"])
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = _CLIPMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Holder(nn.Module):
    pass


class CLIPText(nn.Module):
    """CLIPTextModel, or CLIPTextModelWithProjection where the config's
    ``architectures`` names it."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d = cfg["hidden_size"]
        tm = self.text_model = _Holder()
        tm.embeddings = _Holder()
        # tables left unfilled (the state dict fills them): an embedding's
        # random init on the meta device imports torch's compiler stack
        n_pos = cfg["max_position_embeddings"]
        tm.embeddings.token_embedding = nn.Embedding(
            cfg["vocab_size"], d, _weight=torch.empty(cfg["vocab_size"], d))
        tm.embeddings.position_embedding = nn.Embedding(
            n_pos, d, _weight=torch.empty(n_pos, d))
        tm.encoder = _Holder()
        tm.encoder.layers = nn.ModuleList(
            [_CLIPLayer(cfg) for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=cfg["layer_norm_eps"])
        self.projected = "CLIPTextModelWithProjection" in cfg.get(
            "architectures", ())
        if self.projected:
            self.text_projection = nn.Linear(d, cfg["projection_dim"],
                                             bias=False)

    def forward(self, ids, eos_id):
        """ids [B, 77] -> {last, penultimate, pooled[, projected]}."""
        tm = self.text_model
        S = ids.shape[1]
        x = (tm.embeddings.token_embedding(ids)
             + tm.embeddings.position_embedding.weight[None, :S])
        mask = torch.triu(torch.full((S, S), float("-inf"), device=ids.device),
                          diagonal=1)[None, None]
        layers = tm.encoder.layers
        pen = None
        for i, layer in enumerate(layers):
            if i == len(layers) - 1:
                pen = x
            x = layer(x, mask)
        last = tm.final_layer_norm(x)
        pooled = last[torch.arange(ids.shape[0], device=ids.device),
                      (ids == eos_id).int().argmax(dim=-1)]
        out = {"last": last, "penultimate": pen, "pooled": pooled}
        if self.projected:
            out["projected"] = self.text_projection(pooled)
        return out
