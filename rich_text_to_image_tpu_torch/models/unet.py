"""UNet2DCondition in PyTorch: the SD-1.5 and SDXL topologies.

Counterpart of ``rich_text_to_image_tpu/models/unet.py``. SDXL's
``text_time`` micro-conditioning adds ``add_embedding`` over the pooled
text row and the sinusoidal embedding of the six time ids
(``added_cond={"text_embeds", "time_ids"}``) to the time embedding; levels
of depth 0 (``DownBlock2D``, ``UpBlock2D``) hold no transformer. With
``dual_cross_attention`` each attention block holds two transformer streams
over a concatenated condition (:class:`DualTransformer2DModel`). The forward
returns ``(eps, aux)``: ``capture`` (:class:`CaptureSpec`) names the layers
whose head-averaged attention probabilities go into ``aux``, and ``controls``
(:class:`UNetControls`) carries the font-size token weights and the
self-attention / resnet-feature injection. Layers keep the
reference's registry names (``down_blocks.1.attentions.0.transformer_blocks.0
.attn1`` ...) as ``layer_name``, and modules carry diffusers' parameter names
so that a diffusers state dict loads into them as it is.

Public layout is NHWC (latents in and eps out), as in the JAX package;
inside, activations are NCHW. Self-attention dispatch follows the JAX
package: capture layers take the fused head-average kernel where its shape
gate admits them, other self-attention at S >= 512 the flash kernel, and the
rest the plain path. The 3×3 stride-1 convolutions go through the
hand-written convolution kernel when ``ops.conv.enable_kernel_conv()`` is on
and their shape qualifies, and through ``F.conv2d`` otherwise.

Parity traps kept from the JAX package (not diffusers' defaults): the
feed-forward's GELU is the tanh approximation (flax ``nn.gelu``), the
transformer LayerNorms and GroupNorm use eps 1e-6, the resnet and output
GroupNorms 1e-5.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attn_ops
from ..ops import conv as conv_ops
from ..parallel.mesh import all_reduce_sum
from ..parallel.tp import gather_channels
from ..utils import tracing
from . import unet_graphs
from .config import UNetConfig


# ------------------------------------------------------------------ controls
@dataclasses.dataclass
class UNetControls:
    """Control inputs (None = off).

    ``inject_gate`` is a Python bool or a bool tensor: where it is false the
    injected values give way to the layer's own. ``inject_qk`` maps attn1
    layer names to a (Q, K) pair, ``[B,H,S,hd]`` or pre-split ``[B,S,C]``,
    and ``inject_resnet`` resnet names to a pre-residual feature
    ``[B,h,w,C]``; with ``inject_dst = (d0, d1)`` and no ``inject_src`` they
    go into rows d0:d1 only, else into every row. With ``inject_src`` set,
    rows d0:d1 take row ``inject_src``'s own (Q, K) at every attn1 layer and
    its feature at :data:`INJECT_RESNET_NAME`, inside one forward.

    Prompt-to-prompt editing at the attn2 layers: ``inject_cross`` maps
    their names to a base pass's probabilities ``[1,H,S,77]``, re-indexed by
    ``cross_mapper`` (a ``[77]`` column gather, Refine's; or a ``[77,77]``
    matrix, Replace's) and blended into the layer's own by the per-token
    weight ``cross_mix`` ``[77]``: after the font-size weights, before the
    signs, with no renormalization."""

    token_weights: Optional[torch.Tensor] = None  # (77,) or (B,77) |font size|
    token_signs: Optional[torch.Tensor] = None
    inject_gate: Optional[object] = None  # bool or bool tensor
    inject_qk: Optional[dict] = None
    inject_resnet: Optional[dict] = None
    inject_cross: Optional[dict] = None
    cross_mapper: Optional[torch.Tensor] = None
    cross_mix: Optional[torch.Tensor] = None
    inject_src: Optional[int] = None
    inject_dst: Optional[tuple] = None

    def check_supported(self) -> None:
        if self.inject_src is not None and self.inject_dst is None:
            raise ValueError("UNetControls.inject_src needs inject_dst")


@dataclasses.dataclass(frozen=True)
class CaptureSpec:
    """Capture requests: attn1 / attn2 layer names whose head-averaged
    probabilities go into ``aux``; ``qk`` puts every attn1 layer's own
    (Q, K) ``[B,H,S,hd]`` under ``aux["self_qk"]`` and ``resnet`` the named
    resnets' pre-residual features ``[B,h,w,C]`` under
    ``aux["resnet_hidden"]``; ``cross_full`` (the prompt-to-prompt capture)
    every attn2 layer's full probabilities ``[B,H,S,77]`` fp32 under
    ``aux["cross_probs_full"]``."""

    self_probs: frozenset = frozenset()
    cross_probs: frozenset = frozenset()
    qk: bool = False
    resnet: frozenset = frozenset()
    cross_full: bool = False


EMPTY_CAPTURE = CaptureSpec()
# The resnet whose pre-residual feature the reference injects (16² for SD).
INJECT_RESNET_NAME = "up_blocks.1.resnets.1"


def _gated(gate, new, old):
    """``new`` where the gate is open (None = always), else ``old``."""
    if gate is None:
        return new
    if isinstance(gate, bool):
        return new if gate else old
    return torch.where(gate, new, old)


def _into_rows(t, rows, d0: int, d1: int):
    """``t`` with rows d0:d1 replaced (a new tensor; ``t`` is left alone)."""
    return torch.cat([t[:d0], rows, t[d1:]], dim=0)


def _use_flash(seq: int) -> bool:
    # below 512 tokens the plain path is used, as in the JAX package; on the
    # CPU the wrappers run their plain versions, and on the card they take
    # bfloat16 only and raise on anything else
    return seq >= 512 and not attn_ops.plain_forced()


# ------------------------------------------------------------------- helpers
def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, diffusers ``get_timestep_embedding`` parity."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - freq_shift)
    freqs = torch.exp(exponent)
    args = t.float()[..., None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[..., half:], emb[..., :half]], dim=-1)
    return emb


class Timesteps(nn.Module):
    """The sinusoidal embedding as a module without parameters (diffusers'
    ``Timesteps``): SDXL's ``add_time_proj`` of the six time ids."""

    def __init__(self, dim: int, flip_sin_to_cos: bool, freq_shift: float):
        super().__init__()
        self.dim, self.flip, self.shift = dim, flip_sin_to_cos, freq_shift

    def forward(self, t):
        return timestep_embedding(t, self.dim, self.flip, self.shift)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Conv3x3(nn.Conv2d):
    """A 3×3 stride-1 pad-1 ``nn.Conv2d`` (same parameters and names) that
    takes the hand-written kernel (``ops/conv.py``) when the gate is on and
    the shape qualifies, and ``F.conv2d`` otherwise. With the gate on a
    failed build or launch raises; nothing falls back. On a CPU tensor the
    op runs its plain version, as the attention ops do.

    The kernel has no backward pass: with the gate on, a forward that would
    record a gradient (autograd enabled and the input or a parameter
    requiring one) raises instead of returning a tensor cut off from the
    graph. The pipeline's UNet calls all run under ``torch.no_grad()``.

    The kernel works channels-last on weights repacked to ``[3,3,C,O]``;
    the repack is made once per weight tensor and kept on the module. The
    result comes back as an NCHW view of channels-last memory, which the
    following GroupNorm and convolutions take as it is."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, padding=1)
        self._packed = None  # (key of the weight it was made from, tensor)

    def packed_weight(self) -> torch.Tensor:
        w = self.weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, conv_ops.pack_weight(w.detach()))
        return self._packed[1]

    def forward(self, x):
        B, C, H, W = x.shape
        if not (conv_ops.kernel_conv_enabled()
                and conv_ops.conv3x3_supported(
                    (B, H, W, C), (3, 3, C, self.out_channels))):
            return super().forward(x)
        if torch.is_grad_enabled() and (
                x.requires_grad or self.weight.requires_grad
                or self.bias.requires_grad):
            raise RuntimeError(
                "Conv3x3: the convolution kernel has no backward pass; run "
                "the forward under torch.no_grad() or turn the gate off "
                "(ops.conv.enable_kernel_conv(False))")
        x_cl = x.permute(0, 2, 3, 1).contiguous()  # no copy if channels-last
        y = conv_ops.conv3x3(x_cl, self.packed_weight(), self.bias)
        return y.permute(0, 3, 1, 2)


class _Conv(nn.Module):
    """A module holding one 3×3 conv as ``.conv`` (diffusers' down- and
    upsamplers); the stride-2 one never qualifies for the kernel."""

    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.conv = (Conv3x3(ch, ch) if stride == 1
                     else nn.Conv2d(ch, ch, 3, stride=stride, padding=1))

    def forward(self, x):
        return self.conv(x)


# -------------------------------------------------------------------- resnet
class ResnetBlock2D(nn.Module):
    """GN-SiLU-Conv x2 plus the time projection (NCHW). The pre-residual
    branch is what ``CaptureSpec.resnet`` captures and what the injection
    controls replace."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, groups: int,
                 layer_name: str = ""):
        super().__init__()
        self.layer_name = layer_name
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=1e-5)
        self.conv1 = Conv3x3(in_ch, out_ch)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=1e-5)
        self.conv2 = Conv3x3(out_ch, out_ch)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def _injected(self, h, controls: UNetControls | None):
        if controls is None:
            return h
        name, gate = self.layer_name, controls.inject_gate
        if controls.inject_resnet is not None and name in controls.inject_resnet:
            inj = controls.inject_resnet[name].to(h.dtype).permute(0, 3, 1, 2)
            if controls.inject_dst is not None and controls.inject_src is None:
                # an explicit feature into a row range only
                d0, d1 = controls.inject_dst
                hs = _gated(gate, inj.expand(d1 - d0, *h.shape[1:]), h[d0:d1])
                return _into_rows(h, hs, d0, d1)
            return _gated(gate, inj.expand_as(h), h)
        if controls.inject_src is not None and name == INJECT_RESNET_NAME:
            # in-batch: rows d0:d1 take row inject_src's feature
            s0 = controls.inject_src
            d0, d1 = controls.inject_dst
            hs = _gated(gate, h[s0:s0 + 1].expand(d1 - d0, *h.shape[1:]),
                        h[d0:d1])
            return _into_rows(h, hs, d0, d1)
        return h

    def forward(self, x, temb, controls: UNetControls | None = None,
                capture: CaptureSpec = EMPTY_CAPTURE, aux: dict | None = None):
        rec = unet_graphs.recording()
        if rec is not None and unet_graphs.is_island(self.layer_name,
                                                     rec.touched):
            return rec.island(self, (x, temb), controls, capture, aux)
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if aux is not None and self.layer_name in capture.resnet:
            aux.setdefault("resnet_hidden", {})[self.layer_name] = (
                h.permute(0, 2, 3, 1))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + self._injected(h, controls)


# ----------------------------------------------------------------- attention
def _local_heads(t, heads: int, tpl, dim: int = 1):
    """``t``'s block of this tp rank's heads along ``dim`` where ``t``
    holds all ``heads`` (a whole stored map or (Q, K)), else ``t`` as it
    is."""
    if tpl is None or t.shape[dim] != heads:
        return t
    rank, tp, _ = tpl
    n = heads // tp
    return t.narrow(dim, rank * n, n)


class Attention(nn.Module):
    """Self- or cross-attention on [B, S, C] with capture dispatch.

    Under tp, where ``parallel/mesh.heads_local`` admits the block, ``to_q``,
    ``to_k`` and ``to_v`` hold this rank's heads and keep their outputs
    local: the kernels run on ``heads // tp`` heads and the output is
    gathered once, before ``to_out``. The capture layers gather q, k and v
    to every head first (their kernel averages over the heads); a captured
    cross-attention head mean is the sum of the ranks' head sums, and the
    prompt-to-prompt maps are gathered whole when captured and narrowed to
    this rank's heads when injected. ``capture.qk`` keeps this rank's heads,
    so a refer cache holds them, and a stored (Q, K) of every head is
    narrowed to them."""

    def __init__(self, dim: int, heads: int, kv_dim: int | None = None,
                 layer_name: str = ""):
        super().__init__()
        self.heads = heads
        self.dim = dim
        self.layer_name = layer_name
        kv = kv_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kv, dim, bias=False)
        self.to_v = nn.Linear(kv, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def tp_local(self):
        """(rank, tp, group) where this block runs on its tp rank's heads,
        else None."""
        loc = getattr(self.to_q, "tp_local", None)
        return None if loc is None else (*loc, self.to_q.tp_group)

    def local_heads(self) -> int:
        """The heads this rank's kernels see."""
        tpl = self.tp_local()
        return self.heads if tpl is None else self.heads // tpl[1]

    def _injected_qk(self, q, k, controls: UNetControls | None, tpl=None):
        """The (Q, K) this self-attention layer attends with: its own, or
        under the injection controls another row's or a stored pair."""
        if controls is None:
            return q, k
        own_q, own_k = q, k
        gate = controls.inject_gate
        inj = (controls.inject_qk.get(self.layer_name)
               if controls.inject_qk is not None else None)
        if inj is not None:
            qi, ki = inj
            hd = self.dim // self.heads
            if qi.dim() == 3:  # pre-split [B, S, C] storage layout
                qi, ki = (_local_heads(t.view(t.shape[0], t.shape[1], -1, hd),
                                       self.heads, tpl, 2).transpose(1, 2)
                          for t in (qi, ki))
            else:
                qi, ki = (_local_heads(t, self.heads, tpl) for t in (qi, ki))
            qi, ki = qi.to(q.dtype), ki.to(k.dtype)
            if controls.inject_dst is not None and controls.inject_src is None:
                # an explicit (Q, K) into a row range only
                d0, d1 = controls.inject_dst
                q, k = (_into_rows(t, _gated(
                    gate, ti.expand(d1 - d0, *t.shape[1:]), t[d0:d1]), d0, d1)
                    for t, ti in ((q, qi), (k, ki)))
            else:
                # one reference row broadcast over the batch
                q, k = (_gated(gate, ti.expand_as(t), t)
                        for t, ti in ((q, qi), (k, ki)))
        if controls.inject_src is not None:
            # in-batch: rows d0:d1 attend with row inject_src's own (Q, K)
            s0 = controls.inject_src
            d0, d1 = controls.inject_dst
            q, k = (_into_rows(t, _gated(
                gate, src[s0:s0 + 1].expand(d1 - d0, *t.shape[1:]),
                t[d0:d1]), d0, d1) for t, src in ((q, own_q), (k, own_k)))
        return q, k

    def forward(self, x, context=None, controls: UNetControls | None = None,
                capture: CaptureSpec = EMPTY_CAPTURE, aux: dict | None = None):
        rec = unet_graphs.recording()
        if rec is not None and unet_graphs.is_island(self.layer_name,
                                                     rec.touched):
            return rec.island(self, (x, context), controls, capture, aux)
        is_cross = context is not None
        ctx = context if is_cross else x
        B, S, _ = x.shape
        hd = self.dim // self.heads
        scale = hd ** -0.5
        tpl = self.tp_local()

        def split(t):  # [B, S, C] -> [B, H, S, hd] (a view); local heads
            return t.view(B, t.shape[1], -1, hd).transpose(1, 2)

        def whole(t, dim=1):  # every head, where t holds this rank's
            return t if tpl is None else gather_channels(t, dim, tpl[2],
                                                         tpl[0])

        q = split(self.to_q(x))
        k = split(self.to_k(ctx))
        v = split(self.to_v(ctx))
        name = self.layer_name
        gathered = tpl is None
        if is_cross:
            # font-size reweighting: softmax(s + log w) * sign, per row; the
            # prompt-to-prompt blend between the two
            tw = ts = blend = None
            if controls is not None:
                tw, ts = controls.token_weights, controls.token_signs
                if (controls.inject_cross is not None
                        and name in controls.inject_cross):
                    blend = (_local_heads(controls.inject_cross[name],
                                          self.heads, tpl),
                             controls.cross_mapper, controls.cross_mix)
            o, probs = attn_ops.cross_attention(q, k, v, scale, tw, ts,
                                                return_probs=True,
                                                blend=blend)
            if aux is not None and name in capture.cross_probs:
                if tpl is None:
                    pm = probs.mean(dim=1)
                else:  # the ranks' head sums, summed
                    pm = (all_reduce_sum(probs.float().sum(dim=1), tpl[2])
                          / self.heads).to(probs.dtype)
                aux.setdefault("cross_probs", {})[name] = pm
            if aux is not None and capture.cross_full:
                aux.setdefault("cross_probs_full", {})[name] = whole(probs)
        else:
            qu, ku = self._injected_qk(q, k, controls, tpl)
            # each path's attention call alone is the span attn_self
            if name in capture.self_probs:
                # capture layers use only the head average: every head
                qu, ku, vw = whole(qu), whole(ku), whole(v)
                gathered = True
                if (_use_flash(S) and attn_ops.avg_probs_kernel_fits(
                        S, ku.shape[2], hd)):
                    with tracing.span("attn_self",
                                      path="flash_attention_avg_probs"):
                        o, pavg = attn_ops.flash_attention_avg_probs(
                            qu, ku, vw, scale)
                else:
                    with tracing.span("attn_self",
                                      path="attention_with_probs"):
                        o, probs = attn_ops.attention_with_probs(qu, ku, vw,
                                                                 scale)
                    pavg = probs.mean(dim=1)
                if aux is not None:
                    aux.setdefault("self_probs", {})[name] = pavg
            elif _use_flash(S):
                with tracing.span("attn_self", path="flash_attention"):
                    o = attn_ops.flash_attention(qu, ku, v, scale)
            else:
                with tracing.span("attn_self", path="cross_attention"):
                    o = attn_ops.cross_attention(qu, ku, v, scale)
            if capture.qk and aux is not None:
                aux.setdefault("self_qk", {})[name] = (q, k)
        o = o.transpose(1, 2).reshape(B, S, -1)
        if not gathered:
            o = whole(o, 2)
        return self.to_out[0](o)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")  # flax nn.gelu default


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # diffusers' layout: net.0 = GEGLU, net.1 = dropout, net.2 = out
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, kv_dim: int, layer_name: str):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads, layer_name=f"{layer_name}.attn1")
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, heads, kv_dim,
                               layer_name=f"{layer_name}.attn2")
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, context, controls, capture, aux):
        x = x + self.attn1(self.norm1(x), None, controls, capture, aux)
        x = x + self.attn2(self.norm2(x), context, controls, capture, aux)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, cfg: UNetConfig, heads: int, dim: int, depth: int,
                 layer_name: str):
        super().__init__()
        self.linear = cfg.use_linear_projection
        self.norm = nn.GroupNorm(cfg.norm_num_groups, dim, eps=1e-6)
        if self.linear:
            self.proj_in = nn.Linear(dim, dim)
            self.proj_out = nn.Linear(dim, dim)
        else:
            self.proj_in = nn.Conv2d(dim, dim, 1)
            self.proj_out = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(dim, heads, cfg.cross_attention_dim,
                                  f"{layer_name}.transformer_blocks.{i}")
            for i in range(depth)])

    def forward(self, x, context, controls, capture, aux):
        B, C, H, W = x.shape
        residual = x
        h = self.norm(x)
        if self.linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context, controls, capture, aux)
        if self.linear:
            h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return h + residual


class DualTransformer2DModel(nn.Module):
    """Two :class:`Transformer2DModel` streams over a concatenated
    condition sequence (``UNetConfig.dual_cross_attention``; diffusers'
    ``DualTransformer2DModel``, the dual-guided Versatile Diffusion block).

    ``context`` is the concatenation of two conditions of lengths
    ``dual_condition_lengths``; condition ``i`` is encoded by stream
    ``dual_transformer_index[i]``, and the two residual deltas are mixed by
    ``dual_mix_ratio``: ``x + mix·d0 + (1 − mix)·d1``. Both streams always
    run, and the capture, injection and font-size controls reach both (their
    layers are named ``<block>.transformers.{j}...``)."""

    def __init__(self, cfg: UNetConfig, heads: int, dim: int, depth: int,
                 layer_name: str):
        super().__init__()
        index = tuple(cfg.dual_transformer_index)
        if tuple(sorted(index)) != (0, 1):
            # both streams hold parameters; a routing that leaves one
            # unused could not load a dual checkpoint
            raise ValueError("transformer_index must be a permutation of "
                             f"(0, 1), got {index}")
        self.transformer_index = index
        self.condition_lengths = tuple(cfg.dual_condition_lengths)
        self.mix_ratio = float(cfg.dual_mix_ratio)
        self.transformers = nn.ModuleList([
            Transformer2DModel(cfg, heads, dim, depth,
                               f"{layer_name}.transformers.{j}")
            for j in range(2)])

    def forward(self, x, context, controls, capture, aux):
        deltas, start = [], 0
        for i, n in enumerate(self.condition_lengths):
            stream = self.transformers[self.transformer_index[i]]
            out = stream(x, context[:, start:start + n], controls, capture,
                         aux)
            deltas.append(out - x)
            start += n
        return (x + deltas[0] * self.mix_ratio
                + deltas[1] * (1.0 - self.mix_ratio))


def _transformer(cfg: UNetConfig, heads: int, dim: int, depth: int,
                 layer_name: str) -> nn.Module:
    """The attention block's transformer: two streams iff the config asks."""
    cls = (DualTransformer2DModel if cfg.dual_cross_attention
           else Transformer2DModel)
    return cls(cfg, heads, dim, depth, layer_name)


# -------------------------------------------------------------------- blocks
class DownBlock(nn.Module):
    """CrossAttnDownBlock2D (``attentions`` set) or DownBlock2D."""

    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int, temb: int,
                 heads: int, depth: int, cross: bool, add_downsample: bool,
                 layer_name: str):
        super().__init__()
        n = cfg.layers_per_block
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, temb,
                          cfg.norm_num_groups, f"{layer_name}.resnets.{i}")
            for i in range(n)])
        self.attentions = nn.ModuleList([
            _transformer(cfg, heads, out_ch, depth,
                         f"{layer_name}.attentions.{i}")
            for i in range(n)]) if cross else None
        self.downsamplers = (nn.ModuleList([_Conv(out_ch, 2)])
                             if add_downsample else None)

    def forward(self, x, temb, context, controls, capture, aux):
        skips = []
        for i, res in enumerate(self.resnets):
            x = res(x, temb, controls, capture, aux)
            if self.attentions is not None:
                x = self.attentions[i](x, context, controls, capture, aux)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UpBlock(nn.Module):
    """CrossAttnUpBlock2D (``attentions`` set) or UpBlock2D."""

    def __init__(self, cfg: UNetConfig, prev_ch: int, out_ch: int,
                 skip_chs: list[int], temb: int, heads: int, depth: int,
                 cross: bool, add_upsample: bool, layer_name: str):
        super().__init__()
        n = cfg.layers_per_block + 1
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev_ch if i == 0 else out_ch) + skip_chs[i],
                          out_ch, temb, cfg.norm_num_groups,
                          f"{layer_name}.resnets.{i}")
            for i in range(n)])
        self.attentions = nn.ModuleList([
            _transformer(cfg, heads, out_ch, depth,
                         f"{layer_name}.attentions.{i}")
            for i in range(n)]) if cross else None
        self.upsamplers = (nn.ModuleList([_Conv(out_ch, 1)])
                           if add_upsample else None)

    def forward(self, x, skips, temb, context, controls, capture, aux):
        for i, res in enumerate(self.resnets):
            x = res(torch.cat([x, skips.pop()], dim=1), temb, controls,
                    capture, aux)
            if self.attentions is not None:
                x = self.attentions[i](x, context, controls, capture, aux)
        if self.upsamplers is not None:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, ch: int, temb: int, heads: int,
                 depth: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, temb, cfg.norm_num_groups,
                          f"mid_block.resnets.{i}") for i in range(2)])
        self.attentions = nn.ModuleList([
            _transformer(cfg, heads, ch, depth, "mid_block.attentions.0")])

    def forward(self, x, temb, context, controls, capture, aux):
        x = self.resnets[0](x, temb, controls, capture, aux)
        x = self.attentions[0](x, context, controls, capture, aux)
        return self.resnets[1](x, temb, controls, capture, aux)


# ---------------------------------------------------------------------- UNet
class UNet2DCondition(nn.Module):
    """SD-1.5-topology UNet split into ``embed_time`` / ``encode`` /
    ``decode``, composed exactly by ``forward``.

    ``dtype`` is the compute type (bfloat16 on the card, by the precision
    policy; float32 in the CPU tests): cast the module with ``.to(dtype)``
    after loading weights, as :func:`~..weights.random_init` does.

    On the card, without grad, a call replays piecewise CUDA graphs of the
    stretches between its self-attention modules and the modules its
    controls or capture touch (:mod:`.unet_graphs`); ``_graphs_on`` False
    keeps every call eager (a mesh sets it; tests compare with it).
    """

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        if cfg.addition_embed_type not in (None, "text_time"):
            raise NotImplementedError(
                f"addition_embed_type {cfg.addition_embed_type!r}: only SDXL's "
                "text_time is ported")
        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        temb = cfg.time_embed_dim
        self.time_embedding = TimestepEmbedding(ch0, temb)
        if cfg.addition_embed_type == "text_time":
            self.add_time_proj = Timesteps(cfg.addition_time_embed_dim,
                                           cfg.flip_sin_to_cos, cfg.freq_shift)
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        heads = cfg.heads_per_level
        depth = cfg.transformer_layers_per_block
        L = len(cfg.block_out_channels)

        down, skip_chs, prev = [], [ch0], ch0
        for lvl, btype in enumerate(cfg.down_block_types):
            ch = cfg.block_out_channels[lvl]
            last = lvl == L - 1
            down.append(DownBlock(
                cfg, prev, ch, temb, heads[lvl], depth[lvl],
                btype == "CrossAttnDownBlock2D", not last, f"down_blocks.{lvl}"))
            skip_chs += [ch] * cfg.layers_per_block + ([ch] if not last else [])
            prev = ch
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = MidBlock(cfg, prev, temb, heads[-1], depth[-1])

        rev_ch = list(reversed(cfg.block_out_channels))
        rev_heads = list(reversed(heads))
        rev_depth = list(reversed(depth))
        up = []
        for lvl, btype in enumerate(cfg.up_block_types):
            ch = rev_ch[lvl]
            n = cfg.layers_per_block + 1
            mine = [skip_chs.pop() for _ in range(n)]
            up.append(UpBlock(
                cfg, prev, ch, mine, temb, rev_heads[lvl], rev_depth[lvl],
                btype == "CrossAttnUpBlock2D", lvl != L - 1, f"up_blocks.{lvl}"))
            prev = ch
        self.up_blocks = nn.ModuleList(up)
        # each top-level block runs inside a span of this name (utils/tracing)
        for part, blocks in (("down", down), ("up", up)):
            for i, blk in enumerate(blocks):
                blk.span_name = f"unet.{part}.{i}"
        self.mid_block.span_name = "unet.mid"
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, prev, eps=1e-5)
        self.conv_out = nn.Conv2d(prev, cfg.out_channels, 3, padding=1)
        self._graphs_on = True
        self._graphs = unet_graphs.UNetGraphs()
        self._layer_names = None

    def _apply(self, fn, recurse=True):
        # .to() and the like may move the parameters: the graphs' addresses
        # go stale
        self._graphs.drop()
        return super()._apply(fn, recurse)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def embed_time(self, timesteps, batch: int,
                   added_cond: dict | None = None) -> torch.Tensor:
        """The time embedding [B, time_embed_dim]; with SDXL's text_time
        conditioning plus ``add_embedding`` of [pooled text row, embedded
        time ids], from ``added_cond = {"text_embeds": [B, P], "time_ids":
        [B, 6] or [1, 6]}``."""
        dev = self.conv_in.weight.device
        t = torch.as_tensor(timesteps, device=dev)
        if t.dim() == 0:
            t = t.expand(batch)
        cfg = self.cfg
        emb = timestep_embedding(t, cfg.block_out_channels[0],
                                 cfg.flip_sin_to_cos, cfg.freq_shift)
        emb = self.time_embedding(emb.to(self.dtype))
        if cfg.addition_embed_type == "text_time":
            if added_cond is None:
                raise ValueError("a text_time UNet needs added_cond = "
                                 "{'text_embeds', 'time_ids'}")
            ids = torch.as_tensor(added_cond["time_ids"], device=dev)
            te = self.add_time_proj(
                ids.expand(batch, ids.shape[-1]).reshape(-1)).reshape(batch, -1)
            pooled = torch.as_tensor(added_cond["text_embeds"], device=dev)
            emb = emb + self.add_embedding(
                torch.cat([pooled.to(self.dtype), te.to(self.dtype)], dim=-1))
        return emb

    def encode(self, sample, emb, encoder_hidden_states,
               controls: UNetControls | None = None,
               capture: CaptureSpec = EMPTY_CAPTURE) -> dict:
        """sample: NHWC latents -> {"x", "skips", "aux"} (NCHW inside)."""
        aux: dict = {}
        context = encoder_hidden_states.to(self.dtype)
        x = self.conv_in(sample.to(self.dtype).permute(0, 3, 1, 2))
        skips = [x]
        for blk in self.down_blocks:
            with tracing.span(blk.span_name):
                x, s = blk(x, emb, context, controls, capture, aux)
            skips += s
        return {"x": x, "skips": tuple(skips), "aux": aux}

    def decode(self, enc: dict, emb, encoder_hidden_states,
               controls: UNetControls | None = None,
               capture: CaptureSpec = EMPTY_CAPTURE):
        """encode()'s output -> (eps NHWC, aux)."""
        aux = {k: dict(v) for k, v in enc["aux"].items()}
        context = encoder_hidden_states.to(self.dtype)
        skips = list(enc["skips"])
        with tracing.span(self.mid_block.span_name):
            x = self.mid_block(enc["x"], emb, context, controls, capture, aux)
        for blk in self.up_blocks:
            with tracing.span(blk.span_name):
                x = blk(x, skips, emb, context, controls, capture, aux)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1), aux

    def forward(self, sample, timesteps, encoder_hidden_states,
                controls: UNetControls | None = None,
                capture: CaptureSpec = EMPTY_CAPTURE,
                added_cond: dict | None = None):
        if controls is not None:
            controls.check_supported()
        eps, aux, _ = self._call(sample, timesteps, encoder_hidden_states,
                                 controls, capture, added_cond)
        return eps, aux

    def forward_cached(self, sample, timesteps, encoder_hidden_states,
                       controls: UNetControls | None, capture: CaptureSpec,
                       added_cond: dict | None, cache: dict, name: str,
                       key: bool):
        """:meth:`forward` under encoder reuse (arXiv 2312.09608 §4): on a
        key step ``encode`` runs and its output is kept in
        ``cache[name]``; ``decode`` always runs, on ``cache[name]``, with
        this step's time embedding."""
        if controls is not None:
            controls.check_supported()
        eps, aux, enc = self._call(sample, timesteps, encoder_hidden_states,
                                   controls, capture, added_cond,
                                   None if key else cache[name], key)
        if key:
            cache[name] = enc
        return eps, aux

    def _call(self, sample, timesteps, ehs, controls, capture, added_cond,
              enc=None, keep=False):
        """(eps, aux, encode()'s output) by the graphs where they apply,
        else eagerly."""
        touched = unet_graphs.touched_layers(controls, capture,
                                             INJECT_RESNET_NAME)
        key = unet_graphs.signature(self, sample, timesteps, ehs, added_cond,
                                    enc, keep, touched)
        if key is not None:
            return self._graphs.call(self, key, sample, timesteps, ehs,
                                     controls, capture, added_cond, enc)
        if tracing.enabled():
            tracing.count("unet_graph",
                          self._graph_units(touched, enc is not None),
                          how="eager")
        return self._run(sample, timesteps, ehs, controls, capture,
                         added_cond, enc)

    def _run(self, sample, timesteps, ehs, controls, capture, added_cond,
             enc=None):
        """The eager forward; ``encode`` only where ``enc`` is None."""
        emb = (self.embed_time(timesteps, sample.shape[0]) if added_cond is None
               else self.embed_time(timesteps, sample.shape[0], added_cond))
        if enc is None:
            enc = self.encode(sample, emb, ehs, controls, capture)
        eps, aux = self.decode(enc, emb, ehs, controls, capture)
        return eps, aux, enc

    def _graph_units(self, touched, decode_only: bool) -> int:
        """The graphable units of a call: the stretches between its eager
        islands (:func:`~.unet_graphs.is_island`)."""
        if self._layer_names is None:
            self._layer_names = [
                m.layer_name for m in self.modules()
                if isinstance(m, (Attention, ResnetBlock2D))]
        return 1 + sum(unet_graphs.is_island(n, touched)
                       and not (decode_only and n.startswith("down_blocks"))
                       for n in self._layer_names)
