"""FLUX.1's transformer (``FluxTransformer2DModel``) in PyTorch, with
diffusers' module names and equations.

  * ``x_embedder`` takes the 2x2-packed 16-channel latent (64 a token),
    ``context_embedder`` T5's 4096-wide rows.
  * ``time_text_embed``: TimestepEmbedding(sinusoid_256(1000 sigma)) +
    TimestepEmbedding(sinusoid_256(1000 guidance)) + MLP(pooled CLIP-L);
    the sinusoids are taken in float32 from float32 inputs (diffusers casts
    sigma and the guidance to the model's dtype first).
  * 19 double-stream blocks: image and text each with AdaLN-Zero (6
    chunks), q/k/v with bias and RMSNorm on q and k, one joint attention
    over [text ; image] with 3-axis RoPE, ``to_out`` / ``to_add_out``,
    gated residuals, GELU(tanh) MLPs of 4x.
  * 38 single-stream blocks on [text ; image]: AdaLN-Zero (3 chunks),
    q/k/v and ``proj_mlp`` from one normed input, ``proj_out`` over
    [attention ; GELU(mlp)], a gated residual.
  * ``norm_out`` (scale, shift: diffusers' order) and ``proj_out``.

Every attention call goes through ``ops/attention.flash_attention``
(the d = 128 instance of the hand-written kernel on the card), or, where a
:class:`JointCapture` is given to a double block, through the capture
kernels, which also return the head-averaged probabilities.

Latents: :func:`pack` turns NHWC [B, H, W, C] into [B, (H/2)(W/2), 4C] in
diffusers' order (channel, row offset, column offset); the image ids are
(0, i, j) on the packed grid, the text ids 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention, flash_attention_avg_probs
from ..ops.qk_norm_rope import qk_norm_rope
from ..utils import tracing
from .config import FluxConfig

_EPS = 1e-6
_ROPE_THETA = 10000.0  # FluxPosEmbed's theta
_MLP_RATIO = 4  # the MLPs' width over the hidden size


def pack(lat: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, (H/2)(W/2), 4C]."""
    B, H, W, C = lat.shape
    x = lat.permute(0, 3, 1, 2).reshape(B, C, H // 2, 2, W // 2, 2)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(B, (H // 2) * (W // 2), C * 4)


def unpack(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, (H/2)(W/2), 4C] -> NHWC [B, H, W, C]."""
    B, _, C4 = x.shape
    C = C4 // 4
    x = x.reshape(B, H // 2, W // 2, C, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H, W, C)


def timestep_sinusoid(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """diffusers' ``Timesteps(dim, flip_sin_to_cos=True, shift=0)``:
    [cos, sin] of t e^(-ln(10000) k / (dim/2)), float32."""
    half = dim // 2
    k = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-np.log(10000.0) * k / half)
    a = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def _rope_host(axes: tuple, txt: int, gh: int, gw: int):
    ids = np.zeros((txt + gh * gw, 3), np.float64)
    ids[txt:, 1] = np.repeat(np.arange(gh), gw)
    ids[txt:, 2] = np.tile(np.arange(gw), gh)
    cos, sin = [], []
    for i, d in enumerate(axes):
        freqs = 1.0 / _ROPE_THETA ** (np.arange(0, d, 2, dtype=np.float64) / d)
        a = np.outer(ids[:, i], freqs)
        cos.append(np.repeat(np.cos(a), 2, axis=1))
        sin.append(np.repeat(np.sin(a), 2, axis=1))
    return (np.concatenate(cos, 1).astype(np.float32),
            np.concatenate(sin, 1).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _rope_device(axes: tuple, txt: int, gh: int, gw: int,
                 device: torch.device):
    cos, sin = _rope_host(axes, txt, gh, gw)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def rope_tables(cfg: FluxConfig, txt: int, gh: int, gw: int, device):
    """(cos, sin) [txt + gh gw, head dim] float32 of ``FluxPosEmbed`` on
    the ids [text zeros ; (0, i, j)], computed in float64 on the host once
    a shape and device."""
    return _rope_device(tuple(cfg.axes_dims_rope), txt, gh, gw,
                        torch.device(device))


class RMSNorm(nn.Module):
    """The weight and eps of diffusers' ``RMSNorm`` on q or k: the joint
    attention hands both to ``qk_norm_rope``, which applies the norm
    (``ops/qk_norm_rope.rms_norm``)."""

    def __init__(self, d: int, eps: float = _EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps


def _layer_norm(x):
    return F.layer_norm(x, x.shape[-1:], eps=_EPS)


class JointCapture:
    """What the plain pass keeps of each double block's joint attention,
    of its one row: the head-averaged probabilities of the image queries,
    image->image average-pooled 2x2 on both axes to the segmentation grid
    (``self_sum`` [N, N]) and image->text pooled on the query axis
    (``cross_sum`` [N, T]), both summed over the calls."""

    POOL = 2

    def __init__(self, txt: int, grid_hw, device):
        gh, gw = grid_hw
        self.txt = txt
        self.seg = (gh // self.POOL, gw // self.POOL)
        n = self.seg[0] * self.seg[1]
        self.self_sum = torch.zeros((n, n), dtype=torch.float32,
                                    device=device)
        self.cross_sum = torch.zeros((n, txt), dtype=torch.float32,
                                     device=device)
        self.layers = 0

    def add(self, p: torch.Tensor):
        """``p``: [B, T + gh gw, T + gh gw] head-averaged probabilities."""
        T, k = self.txt, self.POOL
        sh, sw = self.seg
        img = p[0, T:]
        ii = img[:, T:].reshape(sh, k, sw, k, sh, k, sw, k)
        self.self_sum += ii.mean(dim=(1, 3, 5, 7)).reshape(sh * sw, sh * sw)
        it = img[:, :T].reshape(sh, k, sw, k, T)
        self.cross_sum += it.mean(dim=(1, 3)).reshape(sh * sw, T)
        self.layers += 1


class AttentionCore(nn.Module):
    """softmax(Q K^T / sqrt d) V over the joint sequence: q, k, v [B, S, H,
    D], q and k normed and after RoPE -> [B, S, H D]; with a capture,
    through the capture kernels, whose head average goes into it. A module
    of its own (no parameters) so that a span can be hooked around the
    attention alone."""

    def forward(self, q, k, v, capture: JointCapture | None = None):
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        with tracing.span("attn_joint", path="plain" if capture is None
                          else "capture"):
            if capture is None:
                o = flash_attention(q, k, v)
            else:
                o, p = flash_attention_avg_probs(q, k, v)
                capture.add(p)
        B, H, S, D = o.shape
        return o.transpose(1, 2).reshape(B, S, H * D)


class _Proj(nn.Module):
    """Linear, activation, Linear (``TimestepEmbedding``,
    ``PixArtAlphaTextProjection``): ``linear_1``, SiLU, ``linear_2``."""

    def __init__(self, i: int, o: int):
        super().__init__()
        self.linear_1 = nn.Linear(i, o)
        self.linear_2 = nn.Linear(o, o)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class TimeTextEmbed(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d = cfg.inner_dim
        self.timestep_embedder = _Proj(256, d)
        if cfg.guidance_embeds:
            self.guidance_embedder = _Proj(256, d)
        self.text_embedder = _Proj(cfg.pooled_projection_dim, d)

    def forward(self, t, guidance, pooled):
        dt = self.timestep_embedder.linear_1.weight.dtype
        emb = self.timestep_embedder(timestep_sinusoid(t * 1000.0).to(dt))
        if guidance is not None:
            emb = emb + self.guidance_embedder(
                timestep_sinusoid(guidance * 1000.0).to(dt))
        return emb + self.text_embedder(pooled.to(dt))


class _AdaNorm(nn.Module):
    """AdaLN-Zero: ``linear`` of SiLU(temb) in ``n`` chunks."""

    def __init__(self, d: int, n: int):
        super().__init__()
        self.linear = nn.Linear(d, n * d)
        self.n = n

    def forward(self, temb):
        return self.linear(F.silu(temb))[:, None].chunk(self.n, dim=-1)


class _FeedForward(nn.Module):
    """``FeedForward(activation_fn="gelu-tanh")``: ``net.0.proj``, GELU
    (tanh), ``net.2``."""

    def __init__(self, d: int, inner: int):
        super().__init__()
        proj = nn.Module()
        proj.proj = nn.Linear(d, inner)
        self.net = nn.ModuleList([proj, nn.Identity(), nn.Linear(inner, d)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class JointAttention(nn.Module):
    """The double block's attention: image q/k/v (``to_*``) and text q/k/v
    (``add_*_proj``), each with RMSNorm on q and k, joint over [text ;
    image] with RoPE, split back into ``to_out`` / ``to_add_out``. With
    ``context`` None it is the single block's (``pre_only``: no output
    projection). The norms, RoPE and the joint rows of q and k are one
    call of ``ops/qk_norm_rope.qk_norm_rope`` (one kernel launch on the
    card); v's rows are concatenated."""

    def __init__(self, cfg: FluxConfig, dual: bool):
        super().__init__()
        d, hd = cfg.inner_dim, cfg.attention_head_dim
        self.heads = cfg.num_attention_heads
        self.to_q, self.to_k, self.to_v = (nn.Linear(d, d) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(hd), RMSNorm(hd)
        if dual:
            self.add_q_proj, self.add_k_proj, self.add_v_proj = (
                nn.Linear(d, d) for _ in range(3))
            self.norm_added_q, self.norm_added_k = RMSNorm(hd), RMSNorm(hd)
            self.to_out = nn.ModuleList([nn.Linear(d, d)])
            self.to_add_out = nn.Linear(d, d)
        self.core = AttentionCore()

    def _heads(self, t):
        return t.view(*t.shape[:2], self.heads, -1)

    def _source(self, x, q, k, nq, nk):
        """(q, k, q's norm weight, k's) of one stream, q and k [B, S, H,
        D] as the projections leave them."""
        return self._heads(q(x)), self._heads(k(x)), nq.weight, nk.weight

    def forward(self, x, context, rope, capture=None):
        parts = [self._source(x, self.to_q, self.to_k, self.norm_q,
                              self.norm_k)]
        v = self._heads(self.to_v(x))
        if context is not None:
            parts.insert(0, self._source(context, self.add_q_proj,
                                         self.add_k_proj, self.norm_added_q,
                                         self.norm_added_k))
            v = torch.cat([self._heads(self.add_v_proj(context)), v], dim=1)
        q, k = qk_norm_rope(parts, *rope, eps=self.norm_q.eps)
        o = self.core(q, k, v, capture)
        if context is None:
            return o
        T = context.shape[1]
        return self.to_out[0](o[:, T:]), self.to_add_out(o[:, :T])


class FluxTransformerBlock(nn.Module):
    """A double-stream block."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d = cfg.inner_dim
        inner = d * _MLP_RATIO
        self.norm1 = _AdaNorm(d, 6)
        self.norm1_context = _AdaNorm(d, 6)
        self.attn = JointAttention(cfg, dual=True)
        self.ff = _FeedForward(d, inner)
        self.ff_context = _FeedForward(d, inner)

    def forward(self, x, c, temb, rope, capture=None):
        sh, sc, g, sh2, sc2, g2 = self.norm1(temb)
        csh, csc, cg, csh2, csc2, cg2 = self.norm1_context(temb)
        a, ca = self.attn(_layer_norm(x) * (1 + sc) + sh,
                          _layer_norm(c) * (1 + csc) + csh, rope, capture)
        x = x + g * a
        x = x + g2 * self.ff(_layer_norm(x) * (1 + sc2) + sh2)
        c = c + cg * ca
        c = c + cg2 * self.ff_context(_layer_norm(c) * (1 + csc2) + csh2)
        return x, c


class FluxSingleTransformerBlock(nn.Module):
    """A single-stream block on [text ; image]."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d = cfg.inner_dim
        inner = d * _MLP_RATIO
        self.norm = _AdaNorm(d, 3)
        self.proj_mlp = nn.Linear(d, inner)
        self.attn = JointAttention(cfg, dual=False)
        self.proj_out = nn.Linear(d + inner, d)

    def forward(self, x, temb, rope):
        sh, sc, g = self.norm(temb)
        h = _layer_norm(x) * (1 + sc) + sh
        mlp = F.gelu(self.proj_mlp(h), approximate="tanh")
        a = self.attn(h, None, rope)
        return x + g * self.proj_out(torch.cat([a, mlp], dim=-1))


class _NormOut(nn.Module):
    """``AdaLayerNormContinuous``: (scale, shift) = linear(SiLU(temb))."""

    def __init__(self, d: int):
        super().__init__()
        self.linear = nn.Linear(d, 2 * d)

    def forward(self, x, temb):
        scale, shift = self.linear(F.silu(temb))[:, None].chunk(2, dim=-1)
        return _layer_norm(x) * (1 + scale) + shift


class FluxTransformer2DModel(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.inner_dim
        self.x_embedder = nn.Linear(cfg.in_channels, d)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, d)
        self.time_text_embed = TimeTextEmbed(cfg)
        self.transformer_blocks = nn.ModuleList(
            [FluxTransformerBlock(cfg) for _ in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [FluxSingleTransformerBlock(cfg)
             for _ in range(cfg.num_single_layers)])
        self.norm_out = _NormOut(d)
        self.proj_out = nn.Linear(d, cfg.in_channels)

    @property
    def dtype(self):
        return self.x_embedder.weight.dtype

    def forward(self, x, sigma, context, pooled, guidance, grid_hw,
                capture: JointCapture | None = None):
        """x: packed latents [B, gh gw, 64]; sigma: [B] (or a float);
        context: T5 rows [B, T, 4096]; pooled: CLIP-L rows [B, 768];
        guidance: the distilled guidance (a float, or None without a
        guidance embedding); grid_hw: (gh, gw). Returns the velocity [B, gh
        gw, 64] in the model's dtype."""
        dt, dev = self.dtype, x.device
        B, T = x.shape[0], context.shape[1]
        sig = torch.as_tensor(sigma, dtype=torch.float32,
                              device=dev).reshape(-1).expand(B)
        gd = (None if guidance is None or not self.cfg.guidance_embeds
              else torch.full((B,), float(guidance), device=dev))
        temb = self.time_text_embed(sig, gd, pooled)
        h = self.x_embedder(x.to(dt))
        c = self.context_embedder(context.to(dt))
        rope = rope_tables(self.cfg, T, *grid_hw, dev)
        with tracing.span("dit.double"):
            for blk in self.transformer_blocks:
                h, c = blk(h, c, temb, rope, capture)
        h = torch.cat([c, h], dim=1)
        with tracing.span("dit.single"):
            for blk in self.single_transformer_blocks:
                h = blk(h, temb, rope)
        return self.proj_out(self.norm_out(h[:, T:], temb))
