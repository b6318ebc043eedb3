"""Attention ops: hand-written Hopper kernels for self-attention, plain
PyTorch for cross-attention.

Counterpart of ``rich_text_to_image_tpu/ops/attention.py``. Each kernel
wrapper has a plain PyTorch version beside it that computes the same
function (einsum, softmax and einsum with fp32 statistics). A wrapper takes
the plain version only for a tensor that lies on the CPU; for a CUDA tensor
it launches its kernel (``csrc/attention.cu``) or raises.

  * ``flash_attention`` — softmax(Q·Kᵀ·scale)·V over latent tokens. One
    CUDA kernel serves both of the JAX package's full-row buckets: the
    classic ``_full_kernel`` (SD 64², d=40) and the transposed
    ``_full_kernel_t`` (d=80, S≤1024, SD 32²). The JAX bucket rule is kept
    only to count launches per bucket.
  * ``flash_attention_avg_probs`` — the same output plus head-averaged
    probabilities [B,Sq,Skv] fp32 (``_full_kernel_avgp``), for the capture
    layers, without per-head probabilities in device memory.
  * ``attention_with_probs`` / ``cross_attention`` — plain paths: explicit
    probabilities, and text cross-attention (77 keys) with the font-size
    reweighting as a log-bias plus a sign mask.

All functions take [B, H, S, D] and return [B, H, S, D].
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

_LOG2E = 1.4426950408889634

# Launch counts: one per kernel launch, added by the wrapper right where it
# launches (never by the plain versions). "full" and "full_t" are the two
# JAX buckets served by the same kernel.
LAUNCHES = {"full": 0, "full_t": 0, "avgp": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_PLAIN = False


@contextlib.contextmanager
def plain_attention():
    """Route the UNet's self-attention through the plain versions, on any
    device, for as long as the context is open. A comparison switch for
    ``chip_smoke.py`` and the tests, read by ``models/unet.py``'s dispatch;
    the wrappers themselves never fall back."""
    global _PLAIN
    old, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = old


def plain_forced() -> bool:
    return _PLAIN


def _bucket(d: int, skv: int) -> str:
    # the JAX dispatch (ops/attention.py _flash_impl): transposed kernel for
    # d == 80 and Skv <= 1024, classic elsewhere
    return "full_t" if d == 80 and skv <= 1024 else "full"


# ------------------------------------------------------------ plain versions
def flash_attention_plain(q, k, v, scale: float | None = None):
    """softmax(Q·Kᵀ·scale)·V with fp32 scores and statistics."""
    return attention_with_probs(q, k, v, scale)[0]


def flash_attention_avg_probs_plain(q, k, v, scale: float | None = None):
    """(out, head-averaged probs [B,Sq,Skv] fp32), explicit probs + mean."""
    out, p = attention_with_probs(q, k, v, scale)
    return out, p.mean(dim=1)


# ---------------------------------------------------------------- kernels
def _check(name, *ts):
    q = ts[0]
    for t in ts:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name}: want [B,H,S,D] with a contiguous last "
                             f"dim, got {tuple(t.shape)} {t.stride()}")
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name}: rows must be 16-byte aligned")
    d = q.shape[-1]
    if d % 8 or d > 96:
        raise ValueError(f"{name}: head dim {d} not supported by the kernel "
                         "(a multiple of 8, at most 96)")


def _strides(t):
    return [int(s) for s in t.stride()[:3]]


def _out_like(q):
    # [B,S,H,D] storage viewed as [B,H,S,D]: the caller's merge of the heads
    # back into [B,S,C] is then a view
    b, h, s, d = q.shape
    return torch.empty((b, s, h, d), dtype=q.dtype,
                       device=q.device).permute(0, 2, 1, 3)


def _raise_if(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def flash_attention(q, k, v, scale: float | None = None):
    """softmax(Q·Kᵀ·scale)·V. q: [B,H,Sq,D]; k, v: [B,H,Skv,D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check("flash_attention", q, k, v)
    from .build import library

    b, h, sq, d = q.shape
    skv = k.shape[2]
    out = _out_like(q)
    err = library().rtt_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, sq, skv, d,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        float(scale * _LOG2E), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_if(err, "flash_attention")
    LAUNCHES[_bucket(d, skv)] += 1
    return out


def avg_probs_kernel_fits(sq: int, skv: int, d: int) -> bool:
    """Shape gate of the capture kernel (the JAX package's gate of the same
    name, models/unet.py): True where ``flash_attention_avg_probs`` takes
    these shapes. On Hopper the kernel streams K/V, so the KV length sets no
    limit; the head dim must be a multiple of 8 up to 96, and the [Sq, Skv]
    fp32 head average of one batch row must be indexable by the kernel's
    32-bit row offsets. The type is not a shape: a CUDA tensor that is not
    bfloat16 makes the wrapper raise."""
    return d % 8 == 0 and d <= 96 and sq * skv < 2**31


def flash_attention_avg_probs(q, k, v, scale: float | None = None):
    """(out [B,H,Sq,D], head-averaged probs [B,Sq,Skv] fp32) without
    per-head probabilities in device memory."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_avg_probs_plain(q, k, v, scale)
    _check("flash_attention_avg_probs", q, k, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if not avg_probs_kernel_fits(sq, skv, d):
        raise ValueError(f"capture kernel does not take S={sq}/{skv}, d={d}")
    from .build import library

    out = _out_like(q)
    pavg = torch.empty((b, sq, skv), dtype=torch.float32, device=q.device)
    err = library().rtt_attn_avgp_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        pavg.data_ptr(), b, h, sq, skv, d,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        float(scale * _LOG2E), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_if(err, "flash_attention_avg_probs")
    LAUNCHES["avgp"] += 1
    return out, pavg


# ------------------------------------------------------------- plain paths
def attention_with_probs(q, k, v, scale: float | None = None):
    """Explicit attention returning (out, probs [B,H,Sq,Skv] fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype), p


def cross_attention(q, k, v, scale: float | None = None, token_weights=None,
                    token_signs=None, return_probs: bool = False):
    """Text cross-attention (Skv = 77) with optional font-size reweighting:
    probs = softmax(s + log w) · sign, with dense (Skv,) vectors or, one
    per batch row, (B, Skv)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])

    def over_keys(t):  # (..., Skv) -> (..., 1, 1, Skv), against [B,H,Sq,Skv]
        return t.float().reshape(*t.shape[:-1], 1, 1, t.shape[-1])

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if token_weights is not None:
        s = s + torch.log(over_keys(token_weights))
    p = torch.softmax(s, dim=-1)
    if token_signs is not None:
        p = p * over_keys(token_signs)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(),
                       v.float()).to(q.dtype)
    if return_probs:
        return out, p
    return out


def make_token_weight_vectors(word_pos, font_size, seq_len: int = 77):
    """Dense (|w|, sign) float32 numpy vectors from the sparse
    (word_pos, font_size) spec, or (None, None)."""
    if word_pos is None or font_size is None or len(word_pos) == 0:
        return None, None
    w = np.ones(seq_len, dtype=np.float32)
    s = np.ones(seq_len, dtype=np.float32)
    w[np.asarray(word_pos)] = np.abs(np.asarray(font_size))
    s[np.asarray(word_pos)] = np.sign(np.asarray(font_size))
    return w, s
