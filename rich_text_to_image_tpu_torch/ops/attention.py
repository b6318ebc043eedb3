"""Attention ops: hand-written Hopper kernels for self-attention, plain
PyTorch for cross-attention.

Counterpart of ``rich_text_to_image_tpu/ops/attention.py``. Each kernel
wrapper has a plain PyTorch version beside it that computes the same
function (einsum, softmax and einsum with fp32 statistics). A wrapper takes
the plain version only for a tensor that lies on the CPU; for a CUDA tensor
it launches its kernel (``csrc/attention.cu``) or raises.

  * ``flash_attention`` — softmax(Q·Kᵀ·scale)·V over latent tokens. One
    CUDA kernel serves the three buckets of the JAX dispatch: the classic
    ``_full_kernel`` (SD 64², d=40), the transposed ``_full_kernel_t``
    (d=80, S≤1024, SD 32²), and the online ``_flash_kernel`` for rows too
    long for the JAX package's full-row layout (SD at 768² and above) or
    calls that name ``block_q``. The JAX split is about a TPU core's
    memory; on Hopper every bucket streams K/V through the same kernel. The
    dispatch rule is kept so that both packages name the same kernel for
    the same shape, and to count launches per bucket.
  * ``flash_attention_avg_probs`` — the same output plus head-averaged
    probabilities [B,Sq,Skv] fp32 (``_full_kernel_avgp``), for the capture
    layers, without per-head probabilities in device memory. Two launches:
    ``flash_attention_lse`` (the output and each row's log2-sum-exp), then
    ``avg_probs_from_lse`` (the head average from the scores and the
    log2-sum-exp).
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
# launches (never by the plain versions). "full", "full_t" and "stream" are
# the three JAX buckets served by the same kernel; "avgp" counts the capture,
# one per ``flash_attention_avg_probs`` call, where its head-average kernel
# launches (its forward launch is part of it and counts under no bucket).
LAUNCHES = {"full": 0, "full_t": 0, "avgp": 0, "stream": 0}
# the same launches by (bucket, B, H, Sq, Skv, padded head dim): which
# instantiation ran, at which shape
LAUNCHES_BY_SHAPE: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()


def launches_by_dim() -> dict:
    """``LAUNCHES_BY_SHAPE`` summed over the shapes: {(bucket, padded head
    dim): launches}."""
    out = {}
    for (bucket, *_, d), n in LAUNCHES_BY_SHAPE.items():
        out[bucket, d] = out.get((bucket, d), 0) + n
    return out


def _count(bucket: str, q, k) -> None:
    LAUNCHES[bucket] += 1
    b, h, sq, d = q.shape
    key = (bucket, b, h, sq, k.shape[2], _padded(d))
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


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


def flash_attention_lse_plain(q, k, v, scale: float | None = None):
    """(out, lse): the output, and each row's log2-sum-exp of the scaled
    scores, log2(sum_j 2^(s_j·scale·log2 e)), fp32 [B,H,Sq]: the first
    piece of the capture."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, scale)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1).to(
        q.dtype).float(), v.float()).to(q.dtype)
    return out, torch.logsumexp(s, dim=-1) * _LOG2E


def avg_probs_from_lse_plain(q, k, lse, scale: float | None = None):
    """The head average [B,Sq,Skv] fp32 of p = 2^(s·scale·log2 e − lse):
    the second piece of the capture, given ``flash_attention_lse``'s lse."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, scale * _LOG2E)
    return torch.exp2(s - lse[..., None]).mean(dim=1)


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


def _padded(d: int) -> int:
    # the head dim the kernels are instantiated for (RTT_DISPATCH)
    return 48 if d <= 48 else 64 if d <= 64 else 80 if d <= 80 else 160


# The tiles ``csrc/attention.cu launch_fwd`` builds, by padded head dim:
# {query rows a CTA (one, two or three warpgroups that multiply): keys a
# K/V tile}, the keys being what measured fastest for that row count. Three
# warpgroups are not built above head dim 80 (registers).
_FWD_TILES = {48: {64: 64, 128: 128, 192: 64},
              64: {64: 64, 128: 64, 192: 64},
              80: {64: 128, 128: 64, 192: 64},
              160: {64: 64, 128: 64}}

# What a wave of attn_fwd_kernel's CTAs costs, by query rows a CTA, in units
# of a 64-row CTA's time: more warpgroups an SM keep its special-function
# units (the exponentials) busier, so the cost grows slower than the rows.
# Fitted to the card's times at the paths' shapes (PERF.md).
_WAVE_COST = {64: 1.0, 128: 1.65, 192: 2.1}


@functools.lru_cache(maxsize=None)
def _fwd_tile(b: int, h: int, sq: int, d: int,
              max_keys: int = 128) -> tuple[int, int]:
    """(query rows a CTA, keys a K/V tile) of ``attn_fwd_kernel``, among
    the built tiles (``_FWD_TILES``) of at most ``max_keys`` keys.

    The CTAs run in waves of one an SM. The rows are those for which the
    waves times a wave's cost (``_WAVE_COST``) are least: 192 or 128 rows at
    the paths' shapes, 64 where that already gives every CTA an SM of its
    own."""
    tiles = {m: tk for m, tk in _FWD_TILES[_padded(d)].items()
             if tk <= max_keys}

    def cost(m):
        ctas = -(-sq // m) * b * h
        return -(-ctas // _SMS) * _WAVE_COST[m]

    block_m = min(tiles, key=lambda m: (cost(m), m))
    return block_m, tiles[block_m]


def _stream_tile(block_k: int) -> int:
    """The most keys a K/V tile that the caller's ``block_k`` (the JAX
    online kernel's key block) allows the streaming bucket: ``block_k``
    where it is a multiple of 64, up to the kernel's 128, else 64."""
    return 128 if block_k >= 128 and block_k % 64 == 0 else 64


# What a wave of attn_pavg_kernel's CTAs costs, by query rows a CTA (one or
# two warpgroups that multiply), in units of a 64-row CTA's time. Fitted to
# the card's times (PERF.md).
_PAVG_WAVE_COST = {64: 1.0, 128: 1.5}
_PAVG_KEYS = 128  # keys a CTA of attn_pavg_kernel


@functools.lru_cache(maxsize=None)
def _pavg_tile(b: int, sq: int, skv: int, d: int) -> int:
    """Query rows a CTA of ``attn_pavg_kernel`` (64 or 128): the least waves
    times a wave's cost, the larger on a tie; 64 above head dim 80, where
    two warpgroups are not built (registers)."""
    def cost(m):
        ctas = -(-sq // m) * -(-skv // _PAVG_KEYS) * b
        return -(-ctas // _SMS) * _PAVG_WAVE_COST[m]

    if _padded(d) > 80:
        return 64
    return min(_PAVG_WAVE_COST, key=lambda m: (cost(m), -m))


def flash_attention(q, k, v, scale: float | None = None,
                    block_q: int | None = None, block_k: int = 512):
    """softmax(Q·Kᵀ·scale)·V. q: [B,H,Sq,D]; k, v: [B,H,Skv,D].

    As in the JAX package, a shape whose K/V row is too long for the
    full-row layout (``_fits_full_row``), or a call that names ``block_q``,
    takes the streaming bucket: the same kernel, with K/V tiles of at most
    ``_stream_tile(block_k)`` keys; ``block_q`` itself only selects the
    bucket, since the kernel's query tile is ``_fwd_tile``'s."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bucket = _bucket(sq, skv, d, q.element_size(), block_q)
    if q.device.type == "cpu":
        if bucket == "stream":
            return flash_attention_stream_plain(q, k, v, scale, block_k)
        return flash_attention_plain(q, k, v, scale)
    max_keys = _stream_tile(block_k) if bucket == "stream" else 128
    out = _launch_fwd("flash_attention", q, k, v, scale, None, max_keys)
    _count(bucket, q, k)
    return out


def _launch_fwd(name, q, k, v, scale, lse, max_keys):
    """attn_fwd_kernel on CUDA tensors into a new output; with ``lse`` (fp32
    [B,H,Sq], contiguous) it also stores the rows' log2-sum-exp there."""
    _check(name, q, k, v)
    if not scale > 0:
        raise ValueError(f"{name}: the kernel takes a positive scale")
    from .build import library

    b, h, sq, d = q.shape
    skv = k.shape[2]
    out = _out_like(q)
    err = library().rtt_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, sq, skv, d,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        float(scale * _LOG2E), *_fwd_tile(b, h, sq, d, max_keys),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, name)
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
    per-head probabilities in device memory: ``flash_attention_lse``, then
    ``avg_probs_from_lse``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_avg_probs_plain(q, k, v, scale)
    out, lse = flash_attention_lse(q, k, v, scale)
    return out, avg_probs_from_lse(q, k, lse, scale)


def flash_attention_lse(q, k, v, scale: float | None = None):
    """(out [B,H,Sq,D], lse [B,H,Sq] fp32): ``attn_fwd_kernel`` storing each
    row's log2-sum-exp of the scaled scores. The capture's first launch; it
    is counted with the second, in ``avg_probs_from_lse``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, scale)
    b, h, sq, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    out = _launch_fwd("flash_attention_lse", q, k, v, scale, lse, 128)
    return out, lse


def avg_probs_from_lse(q, k, lse, scale: float | None = None):
    """The head average [B,Sq,Skv] fp32 of 2^(s·scale·log2 e − lse) by
    ``attn_pavg_kernel``, given the rows' log2-sum-exp ``lse`` [B,H,Sq]
    fp32 (``flash_attention_lse``): each entry is written once, by the one
    CTA that owns it, with no atomics."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return avg_probs_from_lse_plain(q, k, lse, scale)
    _check("avg_probs_from_lse", q, k)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, h, sq) or not lse.is_contiguous()):
        raise ValueError("avg_probs_from_lse: want lse fp32 [B,H,Sq], "
                         f"contiguous, on q's device; got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    if not scale > 0:
        raise ValueError("avg_probs_from_lse: the kernel takes a positive "
                         "scale")
    if not avg_probs_kernel_fits(sq, skv, d):
        raise ValueError(f"capture kernel does not take S={sq}/{skv}, d={d}")
    from .build import library

    pavg = torch.empty((b, sq, skv), dtype=torch.float32, device=q.device)
    err = library().rtt_attn_pavg(
        q.data_ptr(), k.data_ptr(), lse.data_ptr(), pavg.data_ptr(),
        b, h, sq, skv, d, *_strides(q), *_strides(k), float(scale * _LOG2E),
        _pavg_tile(b, sq, skv, d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, "avg_probs_from_lse")
    _count("avgp", q, k)
    return pavg


# ------------------------------------------------------------- plain paths
def _scores(q, k, scale: float):
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale


def attention_with_probs(q, k, v, scale: float | None = None):
    """Explicit attention returning (out, probs [B,H,Sq,Skv] fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, scale)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype), p


def cross_attention(q, k, v, scale: float | None = None, token_weights=None,
                    token_signs=None, return_probs: bool = False,
                    blend=None):
    """Text cross-attention (Skv = 77) with optional font-size reweighting:
    probs = softmax(s + log w) · sign, with dense (Skv,) vectors or, one
    per batch row, (B, Skv). ``blend = (base, mapper, mix)`` is the
    prompt-to-prompt edit, applied before the signs: probs = mix · mapped +
    (1 − mix) · probs, where ``mapped`` is the base probabilities [1,H,Sq,
    Skv] re-indexed on the key axis by ``mapper`` (a (Skv,) gather or a
    (Skv, Skv) matrix) and ``mix`` is (Skv,)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])

    def over_keys(t):  # (..., Skv) -> (..., 1, 1, Skv), against [B,H,Sq,Skv]
        return t.float().reshape(*t.shape[:-1], 1, 1, t.shape[-1])

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if token_weights is not None:
        s = s + torch.log(over_keys(token_weights))
    p = torch.softmax(s, dim=-1)
    if blend is not None:
        base, mapper, mix = blend
        base = base.float()
        if mapper.dim() == 2:
            mapped = torch.einsum("bhqw,wn->bhqn", base, mapper.float())
        else:
            mapped = base.index_select(-1, mapper.long())
        mix = over_keys(mix)
        p = mix * mapped + (1.0 - mix) * p
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
