"""3×3 stride-1 pad-1 convolution plus bias through a hand-written Hopper
kernel, behind an opt-in gate.

Counterpart of ``rich_text_to_image_tpu/ops/conv.py``: the same public
layout (x ``[B,H,W,C]`` channels last, w ``[3,3,C,O]``, b ``[O]`` →
``[B,H,W,O]``), the same process-wide gate (off by default; the UNet's 3×3
convolutions read it, ``models/unet.py Conv3x3``) and the same shape rules.
The kernel (``csrc/conv.cu``) is an implicit GEMM over the 9 taps on
Hopper's warpgroup product, with no padded copy of the input, split over K
through an fp32 workspace where the image is small; its tile and the split
are chosen here (``conv_tile``, ``k_splits``); ``conv3x3_plain`` beside it
is the JAX kernel's own formulation in PyTorch. The wrapper takes the plain
version only for a tensor on the CPU; on a CUDA tensor it launches the
kernel or raises, and it raises under autograd (an input requiring a
gradient with grad mode on): the kernel has no backward pass.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .build import refuse_autograd

# one per kernel launch, added by the wrapper right where it launches
LAUNCHES = {"conv3x3": 0}

_KERNEL_CONV = False


def reset_launches() -> None:
    LAUNCHES["conv3x3"] = 0


def enable_kernel_conv(on: bool = True) -> None:
    """Route the UNet's 3×3/stride-1/pad-1 convolutions of supported shapes
    through ``conv3x3`` (process-wide; off by default, as the JAX package's
    ``enable_pallas_conv``).

    Two limits the JAX gate does not have: on the card the kernel takes
    bfloat16 operands only (a float32 UNet raises ``TypeError`` with the
    gate on, where the JAX kernel accepts float32), and it has no backward
    pass, so the forward must run under ``torch.no_grad()``
    (``models/unet.py Conv3x3`` raises otherwise)."""
    global _KERNEL_CONV
    _KERNEL_CONV = bool(on)


def kernel_conv_enabled() -> bool:
    return _KERNEL_CONV


def conv3x3_supported(x_shape, w_shape) -> bool:
    """The shape rules of the JAX package's gate of the same name: a
    ``[3,3,C,O]`` weight, H and W at least 8, C and O multiples of 64. The
    JAX gate also asks whether its tiles fit the TPU's fast memory
    (``_pick_tiles``); that is the TPU's limit and does not carry over: the
    Hopper kernel's tiles fit at every C."""
    if len(w_shape) != 4 or tuple(w_shape[:2]) != (3, 3):
        return False
    _, H, W, C = x_shape
    O = w_shape[3]
    if H < 8 or W < 8:
        return False
    return C % 64 == 0 and O % 64 == 0 and w_shape[2] == C


def conv3x3_plain(x, w, b):
    """The JAX kernel's formulation: nine shifted slices of the zero-padded
    input, each times its tap's ``[C, O]`` matrix, summed in fp32; the bias
    added to the sum, which is rounded to the input type once."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))  # pads W and H of [B,H,W,C]
    acc = torch.zeros((B, H, W, w.shape[3]), dtype=torch.float32,
                      device=x.device)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        xs = xp[:, dy:dy + H, dx:dx + W, :].float()
        acc = acc + xs @ w[dy, dx].float()
    return (acc + b.float()).to(x.dtype)


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """An ``nn.Conv2d`` weight ``[O,C,3,3]`` as the kernel's ``[3,3,C,O]``,
    contiguous."""
    return weight.permute(2, 3, 1, 0).contiguous()


# The kernel's tiles (csrc/conv.cu): 128 or 256 pixels x 160, 128 or 64
# output channels a CTA, 64 input channels a step; an H100 has 132 SMs, and a
# CTA has one to itself.
_TILE_K = 64
_SMS = 132
MAX_SPLITS = 8


@functools.lru_cache(maxsize=None)
def _plan(m: int, c: int, o: int) -> tuple[int, int, int]:
    """(pixels a CTA, output channels a CTA, ranges of steps) for M = B*H*W
    pixels, C inputs and O outputs.

    The N tile is the widest of 160, 128, 64 that divides O: 160 for the
    SD-1.5 widths 320, 640 and 1280. The M tile and the split over K are
    those a cost model rates cheapest, fitted to the card's times at the
    UNet's shapes (within 4% of the best measured choice at each): the CTAs
    run in waves of one an SM; a wave takes a CTA's steps plus 2 for its
    start and end; a 256-pixel tile's step takes 1.9 times a 128-pixel
    tile's (it moves 10 KB out of L2 per MFLOP, not 14); a split costs a
    pass over its fp32 partial sums. Where the tiles alone give every SM a
    CTA there is one range; a range is never empty."""
    tile_n = 160 if o % 160 == 0 else 128 if o % 128 == 0 else 64
    steps = 9 * (c // _TILE_K)
    best = None
    for tile_m in (128, 256) if tile_n > 64 else (128,):
        tiles = -(-m // tile_m) * (o // tile_n)
        for splits in range(1, MAX_SPLITS + 1 if tiles < _SMS else 2):
            per = -(-steps // splits)
            if per * (splits - 1) >= steps:  # a range would be empty
                continue
            waves = -(-tiles * splits // _SMS)
            cost = waves * (per + 2) * (1.9 if tile_m == 256 else 1.0)
            if splits > 1:
                cost += 4.0 * splits * m * o / (128 * 160 * _SMS)
            if best is None or cost < best[0]:
                best = (cost, tile_m, tile_n, splits)
    return best[1:]


def conv_tile(m: int, c: int, o: int) -> tuple[int, int]:
    """The kernel's (pixels, output channels) a CTA; see ``_plan``."""
    return _plan(m, c, o)[:2]


def k_splits(m: int, c: int, o: int) -> int:
    """Into how many ranges the kernel cuts its 9*C/64 steps; see
    ``_plan``."""
    return _plan(m, c, o)[2]


def conv3x3(x, w, b):
    """x ``[B,H,W,C]``, w ``[3,3,C,O]``, b ``[O]`` → ``[B,H,W,O]``."""
    if not conv3x3_supported(x.shape, w.shape):
        raise ValueError(f"conv3x3: shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)} are outside the kernel's rules")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b)
    refuse_autograd("conv3x3", x, w, b)
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError("conv3x3: tensors on different devices")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"conv3x3: the kernel takes bfloat16, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"conv3x3: {name} must be contiguous and "
                             "16-byte aligned")
    B, H, W, C = x.shape
    O = w.shape[3]
    if b.shape != (O,):
        raise ValueError(f"conv3x3: bias {tuple(b.shape)} for {O} channels")
    if B * H * W * max(C, O) >= 2**31 or max(H, W) >= 2**14:
        raise ValueError("conv3x3: tensor too large for the kernel's indices")
    from .build import library

    out = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    tile_m, tile_n, splits = _plan(B * H * W, C, O)
    ws = (torch.empty((splits, B * H * W, O), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    err = library().rtt_conv3x3_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, splits, tile_m, tile_n,
        B, H, W, C, O, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3: CUDA launch failed with error {err}")
    LAUNCHES["conv3x3"] += 1
    return out
