"""Attention ops: hand-written Hopper kernels for self-attention, plain
PyTorch for cross-attention.

Counterpart of ``rich_text_to_image_tpu/ops/attention.py``. Each kernel
wrapper has a plain PyTorch version beside it that computes the same
function (einsum, softmax and einsum with fp32 statistics). A wrapper takes
the plain version only for a tensor that lies on the CPU; for a CUDA tensor
it launches its kernel (``csrc/attention.cu``, ``csrc/attention_stream.cu``)
or raises.

  * ``flash_attention`` — softmax(Q·Kᵀ·scale)·V over latent tokens. One
    CUDA kernel serves both of the JAX package's full-row buckets: the
    classic ``_full_kernel`` (SD 64², d=40) and the transposed
    ``_full_kernel_t`` (d=80, S≤1024, SD 32²). Rows too long for the JAX
    package's full-row layout (SD at 768² and above), and calls that name
    ``block_q``, go to the streaming kernel (``_flash_kernel``). The JAX
    dispatch rule is kept so that both packages name the same kernel for
    the same shape, and to count launches per bucket.
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
import functools
import math

import numpy as np
import torch

_LOG2E = 1.4426950408889634

# Launch counts: one per kernel launch, added by the wrapper right where it
# launches (never by the plain versions). "full" and "full_t" are the two
# JAX buckets served by the same kernel, "stream" the streaming kernel.
LAUNCHES = {"full": 0, "full_t": 0, "avgp": 0, "stream": 0}


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


# The JAX package's budget for its full-row layout (ops/attention.py
# _FULL_PATH_VMEM): a TPU core's fast memory, not a property of the card.
_FULL_ROW_BYTES = 14 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _fits_full_row(sq: int, skv: int, d: int, itemsize: int):
    """The JAX package's ``_full_path_layout`` rule at its call in
    ``_flash_impl``: the query block its full-row kernels would take for
    this shape, or None where K+V plus the [blk_q, Skv] row buffers pass
    its budget and it falls to the online kernel. The sizes are the TPU's;
    Hopper's kernels stream K/V at every length. The rule is copied only so
    that the port names the same kernel as the JAX package for the same
    shape."""
    skv_p, dp = _round_up(skv, 128), _round_up(d, 128)
    kv_bytes = 2 * skv_p * dp * itemsize
    for blk_q in (1024, 512, 256, 128):
        if blk_q > _round_up(sq, 8):
            continue
        s_bytes = blk_q * skv_p * (8 + itemsize)
        q_bytes = 2 * 2 * blk_q * dp * itemsize
        if kv_bytes + s_bytes + q_bytes <= _FULL_ROW_BYTES:
            return blk_q
    return None


@functools.lru_cache(maxsize=None)  # on every launch's host path
def _bucket(sq: int, skv: int, d: int, itemsize: int = 2,
            block_q: int | None = None) -> str:
    """The kernel the JAX dispatch (ops/attention.py _flash_impl) takes: the
    online kernel when ``block_q`` is named or the full-row layout does not
    fit, else the transposed kernel for d == 80 and Skv <= 1024, else the
    classic one."""
    if block_q is not None or _fits_full_row(sq, skv, d, itemsize) is None:
        return "stream"
    return "full_t" if d == 80 and skv <= 1024 else "full"


# ------------------------------------------------------------ plain versions
def flash_attention_plain(q, k, v, scale: float | None = None):
    """softmax(Q·Kᵀ·scale)·V with fp32 scores and statistics."""
    return attention_with_probs(q, k, v, scale)[0]


def flash_attention_avg_probs_plain(q, k, v, scale: float | None = None):
    """(out, head-averaged probs [B,Sq,Skv] fp32), explicit probs + mean."""
    out, p = attention_with_probs(q, k, v, scale)
    return out, p.mean(dim=1)


def flash_attention_stream_plain(q, k, v, scale: float | None = None,
                                 block_k: int = 512, block_q: int = 2048):
    """The streaming kernel's computation step by step: an online softmax
    over ``block_k``-key blocks with fp32 statistics (running max m, sum l
    and accumulator, rescaled by exp(m_old - m_new) at every block), the
    probabilities rounded to the input type before the PV product. Query
    rows go ``block_q`` at a time, which only bounds the memory of the
    [block_q, block_k] score block."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    sq, skv = q.shape[2], k.shape[2]
    outs = []
    for q0 in range(0, sq, block_q):
        qb = q[:, :, q0:q0 + block_q].float() * scale
        m = qb.new_full(qb.shape[:3] + (1,), float("-inf"))
        l = qb.new_zeros(qb.shape[:3] + (1,))
        acc = torch.zeros_like(qb)
        for k0 in range(0, skv, block_k):
            kb = k[:, :, k0:k0 + block_k].float()
            vb = v[:, :, k0:k0 + block_k].float()
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kb)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(q.dtype).float(), vb)
            m = m_new
        outs.append((acc / l).to(q.dtype))
    return torch.cat(outs, dim=2)


# ---------------------------------------------------------------- kernels
MAX_HEAD_DIM = 160  # the widest instantiation in csrc/common.cuh


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
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} not supported by the kernel "
                         f"(a multiple of 8, at most {MAX_HEAD_DIM})")


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


_SMS = 132  # streaming multiprocessors of an H100


# What a wave of attn_fwd_kernel's CTAs costs, by query rows a CTA (one, two
# or three warpgroups that multiply), in units of a 64-row CTA's time: more
# warpgroups an SM keep its special-function units (the exponentials) busier,
# so the cost grows slower than the rows. Fitted to the card's times at the
# paths' shapes (PERF.md).
_WAVE_COST = {64: 1.0, 128: 1.65, 192: 2.1}


@functools.lru_cache(maxsize=None)
def _fwd_tile(b: int, h: int, sq: int, d: int) -> tuple[int, int]:
    """(query rows a CTA, keys a K/V tile) of ``attn_fwd_kernel``.

    The CTAs run in waves of one an SM. The rows are those for which the
    waves times a wave's cost (``_WAVE_COST``) are least: 192 or 128 rows at
    the paths' shapes, 64 where that already gives every CTA an SM of its
    own; three warpgroups are not built above head dim 80 (registers). The
    keys a tile are what measured fastest for the padded head dim (48, 80,
    160) and row count; ``csrc/attention.cu launch_fwd`` builds these pairs
    only."""
    def cost(m):
        ctas = -(-sq // m) * b * h
        return -(-ctas // _SMS) * _WAVE_COST[m]

    block_m = min((m for m in _WAVE_COST if m < 192 or d <= 80),
                  key=lambda m: (cost(m), m))
    if d > 80 or block_m == 192:
        return block_m, 64
    if d > 48:
        return block_m, (128 if block_m == 64 else 64)
    return block_m, (64 if block_m == 64 else 128)


def _stream_tile(block_k: int) -> int:
    # the streaming kernel's shared-memory tile: the caller's block_k where
    # it is a multiple of 64, up to the kernel's 128 keys
    return 128 if block_k >= 128 and block_k % 64 == 0 else 64


def flash_attention(q, k, v, scale: float | None = None,
                    block_q: int | None = None, block_k: int = 512):
    """softmax(Q·Kᵀ·scale)·V. q: [B,H,Sq,D]; k, v: [B,H,Skv,D].

    As in the JAX package, a shape whose K/V row is too long for the
    full-row layout (``_fits_full_row``), or a call that names ``block_q``,
    takes the streaming kernel, whose K/V tile is ``block_k`` keys where
    that is a multiple of 64, at most 128; ``block_q`` itself only selects
    the path, since the streaming kernel's query tile is fixed at 128
    rows."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bucket = _bucket(sq, skv, d, q.element_size(), block_q)
    if q.device.type == "cpu":
        if bucket == "stream":
            return flash_attention_stream_plain(q, k, v, scale, block_k)
        return flash_attention_plain(q, k, v, scale)
    _check("flash_attention", q, k, v)
    if bucket != "stream" and not scale > 0:
        raise ValueError("flash_attention: the kernel takes a positive scale")
    from .build import library

    out = _out_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, skv, d,
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            float(scale * _LOG2E))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if bucket == "stream":
        err = library().rtt_attn_stream_fwd(*args, _stream_tile(block_k),
                                            stream)
    else:
        err = library().rtt_attn_fwd(*args, *_fwd_tile(b, h, sq, d), stream)
    _raise_if(err, "flash_attention")
    LAUNCHES[bucket] += 1
    return out


def avg_probs_kernel_fits(sq: int, skv: int, d: int) -> bool:
    """Shape gate of the capture kernel (the JAX package's gate of the same
    name, models/unet.py): True where ``flash_attention_avg_probs`` takes
    these shapes. On Hopper the kernel streams K/V, so the KV length sets no
    limit; the head dim must be a multiple of 8 up to 160, and the [Sq, Skv]
    fp32 head average of one batch row must be indexable by the kernel's
    32-bit row offsets. The type is not a shape: a CUDA tensor that is not
    bfloat16 makes the wrapper raise."""
    return d % 8 == 0 and d <= MAX_HEAD_DIM and sq * skv < 2**31


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
