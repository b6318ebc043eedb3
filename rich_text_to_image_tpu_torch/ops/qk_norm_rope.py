"""FLUX.1's q/k prologue of a joint attention: the RMS norm of each head
row of q and k with its weight, RoPE, and the text and image rows in one
joint sequence, through one hand-written Hopper kernel.

The kernel (``csrc/qk_norm_rope.cu``) replaces no kernel of the JAX
package, which has no FLUX.1; it takes q and k as the projections leave
them and writes the joint [B, S, H, D] rows that the attention kernel
reads, with every rounding of the eager chain (``qk_norm_rope_plain``
beside it: ``rms_norm``, a ``torch.cat`` of the sources, ``apply_rope``).
The wrapper takes the plain version only for a tensor on the CPU; on a
CUDA tensor it launches the kernel or raises, and it raises under autograd
(an input requiring a gradient with grad mode on): the kernel has no
backward pass.
"""

from __future__ import annotations

import torch

from ..utils import tracing
from .build import refuse_autograd

HEAD_DIM = 128  # the head dim the kernel is written for (FLUX.1's)

# one per kernel launch, added by the wrapper right where it launches
LAUNCHES = 0


def rms_norm(x, weight, eps: float):
    """diffusers' ``RMSNorm`` with a weight: float32 statistics over the last
    dim, cast to the weight's dtype before the scale."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return x32.to(weight.dtype) * weight


def apply_rope(x, cos, sin):
    """diffusers' ``apply_rotary_emb`` (interleaved pairs) on x [B, S, H,
    D] with cos, sin [S, D], in float32, back in x's dtype."""
    xr, xi = x.float().unflatten(-1, (-1, 2)).unbind(-1)
    rot = torch.stack([-xi, xr], dim=-1).flatten(-2)
    c, s = cos[None, :, None], sin[None, :, None]
    return (x.float() * c + rot * s).to(x.dtype)


def qk_norm_rope_plain(parts, cos, sin, eps: float):
    """``parts``: one or two (q, k, q weight, k weight), q and k [B, S_i, H,
    D] in the order of the joint sequence; cos, sin [sum S_i, D] float32.
    Each q and k normed with its weight, the sources concatenated, RoPE:
    (q, k) [B, sum S_i, H, D]."""
    qs = [rms_norm(q, wq, eps) for q, _, wq, _ in parts]
    ks = [rms_norm(k, wk, eps) for _, k, _, wk in parts]
    q, k = (t[0] if len(t) == 1 else torch.cat(t, dim=1) for t in (qs, ks))
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _check(parts, cos, sin):
    if len(parts) not in (1, 2):
        raise ValueError(f"qk_norm_rope: one or two sources, got {len(parts)}")
    q0 = parts[0][0]
    B, _, H, D = q0.shape
    if D != HEAD_DIM:
        raise ValueError(f"qk_norm_rope: the kernel takes head dim "
                         f"{HEAD_DIM}, got {D}")
    S = sum(q.shape[1] for q, *_ in parts)
    for q, k, wq, wk in parts:
        for name, t in (("q", q), ("k", k), ("a q weight", wq),
                        ("a k weight", wk)):
            if t.dtype != torch.bfloat16:
                raise TypeError(f"qk_norm_rope: the kernel takes bfloat16, "
                                f"{name} is {t.dtype}")
        if q.shape != k.shape or q.shape[0] != B or q.shape[2:] != (H, D):
            raise ValueError(f"qk_norm_rope: q {tuple(q.shape)} and k "
                             f"{tuple(k.shape)} against [{B}, S, {H}, {D}]")
        if wq.shape != (D,) or wk.shape != (D,):
            raise ValueError(f"qk_norm_rope: weights {tuple(wq.shape)}, "
                             f"{tuple(wk.shape)} for head dim {D}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.shape != (S, D):
            raise ValueError(f"qk_norm_rope: {name} {t.dtype} "
                             f"{tuple(t.shape)}, want float32 [{S}, {D}]")
    for t in (cos, sin, *(t for p in parts for t in p)):
        if t.device != q0.device:
            raise ValueError("qk_norm_rope: tensors on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("qk_norm_rope: every tensor must be contiguous "
                             "and 16-byte aligned")
    if B > 65535:
        raise ValueError(f"qk_norm_rope: batch {B} above the kernel's grid")
    return B, S, H, D


def qk_norm_rope(parts, cos, sin, eps: float = 1e-6):
    """``qk_norm_rope_plain``'s function; on a CUDA tensor one launch of the
    kernel, which writes q and k [B, S, H, D] (viewed by the attention as
    [B, H, S, D]) with each source's rows at its own token offset."""
    global LAUNCHES
    if parts[0][0].device.type == "cpu":
        tracing.count("qk_norm_rope", path="plain")
        return qk_norm_rope_plain(parts, cos, sin, eps)
    refuse_autograd("qk_norm_rope", cos, sin,
                    *(t for p in parts for t in p))
    B, S, H, D = _check(parts, cos, sin)
    from .build import library

    first, second = parts if len(parts) == 2 else (parts[0], parts[0])
    split = first[0].shape[1] if len(parts) == 2 else 0
    q_out = torch.empty((B, S, H, D), dtype=torch.bfloat16, device=cos.device)
    k_out = torch.empty_like(q_out)
    err = library().rtt_qk_norm_rope(
        *(t.data_ptr() for t in first), *(t.data_ptr() for t in second),
        split, B, S, H, cos.data_ptr(), sin.data_ptr(), float(eps),
        q_out.data_ptr(), k_out.data_ptr(),
        torch.cuda.current_stream(cos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qk_norm_rope: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES += 1
    tracing.count("qk_norm_rope", path="kernel")
    return q_out, k_out
