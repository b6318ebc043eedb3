"""3×3 stride-1 pad-1 convolution plus bias through a hand-written Hopper
kernel, behind an opt-in gate.

Counterpart of ``rich_text_to_image_tpu/ops/conv.py``: the same public
layout (x ``[B,H,W,C]`` channels last, w ``[3,3,C,O]``, b ``[O]`` →
``[B,H,W,O]``), the same process-wide gate (off by default; the UNet's 3×3
convolutions read it, ``models/unet.py Conv3x3``) and the same shape rules.
The kernel (``csrc/conv.cu``) is an implicit GEMM over the 9 taps with no
padded copy of the input, split over K through an fp32 workspace where the
image is small; ``conv3x3_plain`` beside it is the JAX kernel's
own formulation in PyTorch. The wrapper takes the plain version only for a
tensor on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    Hopper kernel's tile is fixed and fits at every C."""
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


# The kernel's tile (csrc/conv.cu): 128 pixels x 64 output channels a CTA,
# 64 input channels a step; an H100 has 132 SMs.
_TILE_M, _TILE_N, _TILE_K = 128, 64, 64
_SMS = 132


def k_splits(m: int, c: int, o: int) -> int:
    """Into how many ranges the kernel cuts its 9*C/64 steps. One where the
    tiles alone give every SM a CTA (splitting measured slower there); else
    enough for about two CTAs an SM, at most 8, and never ranges shorter
    than 8 steps."""
    tiles = -(-m // _TILE_M) * (o // _TILE_N)
    if tiles >= _SMS:
        return 1
    steps = 9 * (c // _TILE_K)
    return max(1, min(-(-2 * _SMS // tiles), 8, steps // 8))


def conv3x3(x, w, b):
    """x ``[B,H,W,C]``, w ``[3,3,C,O]``, b ``[O]`` → ``[B,H,W,O]``."""
    if not conv3x3_supported(x.shape, w.shape):
        raise ValueError(f"conv3x3: shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)} are outside the kernel's rules")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b)
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
    if B * H * W * max(C, O) >= 2**31:
        raise ValueError("conv3x3: tensor too large for the kernel's indices")
    from .build import library

    out = torch.empty((B, H, W, O), dtype=x.dtype, device=x.device)
    splits = k_splits(B * H * W, C, O)
    ws = (torch.empty((splits, B * H * W, O), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    err = library().rtt_conv3x3_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, splits,
        B, H, W, C, O, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3: CUDA launch failed with error {err}")
    LAUNCHES["conv3x3"] += 1
    return out
