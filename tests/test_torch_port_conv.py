"""The port's 3x3 convolution op and its gate against the JAX package's.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there). Here ``conv3x3_plain`` (nine shifted slices of the
zero-padded input, summed in float32) is held against the JAX package's
Pallas kernel in interpret mode at the cases of its own tests, and against
``F.conv2d``. Tolerance: float32 1e-4 absolute on outputs of size ~1-10 (up
to 9*256 products per output, summed in another order); bfloat16 inputs
2e-2 of the output's max (one bfloat16 rounding of the sum on each side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.ops import conv as J
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models import unet as TU
from rich_text_to_image_tpu_torch.ops import conv as T
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4


def _inputs(B, H, W, Cin, O, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, Cin).astype(np.float32),
            (rng.randn(3, 3, Cin, O) * 0.05).astype(np.float32),
            rng.randn(O).astype(np.float32))


@pytest.mark.parametrize("B,H,W,Cin,O", [
    (2, 8, 8, 128, 128), (1, 16, 16, 256, 128),  # the JAX tests' cases
    (3, 8, 24, 64, 192),                          # W != H, odd batch
])
def test_plain_matches_jax_kernel(B, H, W, Cin, O):
    x, w, b = _inputs(B, H, W, Cin, O)
    want = np.asarray(J.conv3x3(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), interpret=True))
    got = T.conv3x3_plain(*map(torch.from_numpy, (x, w, b)))
    assert got.shape == (B, H, W, O)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_plain_matches_jax_kernel_bf16():
    x, w, b = _inputs(2, 8, 8, 128, 128, seed=1)
    want = np.asarray(J.conv3x3(
        *(jnp.asarray(t, jnp.bfloat16) for t in (x, w, b)),
        interpret=True).astype(jnp.float32))
    got = T.conv3x3_plain(*(torch.from_numpy(t).bfloat16()
                            for t in (x, w, b)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("B,H,W,Cin,O", [(2, 8, 8, 64, 64), (1, 9, 13, 64, 128)])
def test_plain_matches_torch_conv2d(B, H, W, Cin, O):
    """Against the library convolution, through the weight repack the UNet
    uses: borders and taps in their places."""
    x, w, b = map(torch.from_numpy, _inputs(B, H, W, Cin, O, seed=2))
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    want = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=1)
    torch.testing.assert_close(T.pack_weight(w_oihw), w)
    got = T.conv3x3_plain(x, T.pack_weight(w_oihw), b)
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, rtol=0,
                               atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu_and_checks_shapes():
    x, w, b = map(torch.from_numpy, _inputs(1, 8, 8, 64, 64))
    T.reset_launches()
    torch.testing.assert_close(T.conv3x3(x, w, b), T.conv3x3_plain(x, w, b))
    assert T.LAUNCHES == {"conv3x3": 0}
    with pytest.raises(ValueError):
        T.conv3x3(x[:, :4], w, b)  # H < 8


def test_supported_rule_matches_jax_gate():
    """The shape rules of the JAX gate, wherever its TPU memory fit (which
    does not carry over) is not what decides."""
    cases = [((1, 8, 8, 100), (3, 3, 100, 128)),
             ((1, 8, 8, 128), (5, 5, 128, 128)),
             ((2, 64, 64, 320), (3, 3, 320, 320)),
             ((2, 4, 4, 128), (3, 3, 128, 128)),
             ((2, 8, 4, 128), (3, 3, 128, 128)),
             ((2, 16, 16, 128), (3, 3, 128, 100)),
             ((2, 8, 8, 2560), (3, 3, 2560, 1280)),
             ((3, 32, 32, 1920), (3, 3, 1920, 640)),
             ((1, 8, 8, 4), (3, 3, 4, 320)),
             ((1, 64, 64, 320), (3, 3, 320, 4)),
             ((1, 8, 8, 128), (3, 3, 128))]
    for x_shape, w_shape in cases:
        want = J.conv3x3_supported(x_shape, w_shape)
        if want or len(w_shape) != 4 or J._pick_tiles(
                *x_shape[1:], w_shape[3]) is not None:
            assert T.conv3x3_supported(x_shape, w_shape) == want, (
                x_shape, w_shape)
    assert T.conv3x3_supported((2, 64, 64, 320), (3, 3, 320, 320))


def test_gate_switch():
    assert not T.kernel_conv_enabled()  # off by default, as in the JAX package
    T.enable_kernel_conv()
    try:
        assert T.kernel_conv_enabled()
    finally:
        T.enable_kernel_conv(False)
    assert not T.kernel_conv_enabled()


# A UNet narrow enough for the CPU whose convolutions qualify for the kernel
# (channels in multiples of 64) at a 16^2 latent
WIDE_TINY = C.UNetConfig(
    sample_size=16, block_out_channels=(64, 64, 128, 128),
    attention_head_dim=(2, 2, 2, 2), cross_attention_dim=32,
    norm_num_groups=8)


def test_unet_with_gate_on_equals_gate_off():
    """With the gate on, the qualifying convolutions go through the op (on
    the CPU its plain version, channels last and repacked weights) and the
    UNet's output stays the same. Tolerance 1e-4 of the output's scale."""
    unet = weights.random_init(TU.UNet2DCondition(WIDE_TINY), 0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 32)).astype(np.float32))
    taken = []
    real = T.conv3x3

    def recording(x_, w_, b_):
        taken.append((tuple(x_.shape), w_.shape[3]))
        return real(x_, w_, b_)

    with torch.no_grad():
        off, _ = unet(x, 300, ctx)
        T.enable_kernel_conv()
        T.conv3x3 = recording
        try:
            on, _ = unet(x, 300, ctx)
        finally:
            T.conv3x3 = real
            T.enable_kernel_conv(False)
    # the levels at 16^2 and 8^2 qualify (H >= 8): 2 x 4 convolutions in
    # their down resnets, 2 x 6 in their up resnets, and the two upsamplers
    # that arrive at them; conv_in, conv_out, the stride-2 downsamplers and
    # the 4^2 and 2^2 levels do not
    assert len(taken) == 22 and all(s[1] >= 8 for s, _ in taken)
    assert {s[3] for s, _ in taken} == {64, 128, 192}  # 192 = 128 + a skip
    assert float((on - off).abs().max()) <= 1e-4 * float(off.abs().max())
    assert float((on - off).abs().max()) > 0  # another order of the sums


def test_packed_weight_follows_the_parameter():
    conv = TU.Conv3x3(64, 64)
    first = conv.packed_weight()
    assert conv.packed_weight() is first  # cached
    with torch.no_grad():
        conv.weight.mul_(2.0)
    torch.testing.assert_close(conv.packed_weight(), first * 2.0)
    conv.to(torch.bfloat16)
    assert conv.packed_weight().dtype == torch.bfloat16


def test_gate_on_refuses_a_forward_that_records_a_gradient():
    """The kernel has no backward pass: with the gate on, a qualifying
    convolution raises when autograd would record it, rather than return a
    tensor cut off from the graph; with the gate off, or under no_grad, or
    for a shape that does not qualify, it runs."""
    conv = TU.Conv3x3(64, 64)
    x = torch.zeros((1, 64, 8, 8))
    small = torch.zeros((1, 64, 4, 4))  # H < 8: F.conv2d, gate or not
    assert conv(x).requires_grad
    T.enable_kernel_conv()
    try:
        with pytest.raises(RuntimeError, match="no backward"):
            conv(x)
        assert conv(small).requires_grad
        with torch.no_grad():
            assert conv(x).shape == (1, 64, 8, 8)
    finally:
        T.enable_kernel_conv(False)


def test_only_stride_one_3x3_convolutions_are_conv3x3_modules():
    """conv_in, conv_out and the stride-2 downsamplers can never take the
    kernel and stay plain ``nn.Conv2d``; every Conv3x3 is 3x3, stride 1."""
    unet = TU.UNet2DCondition(WIDE_TINY)
    assert type(unet.conv_in) is torch.nn.Conv2d
    assert type(unet.conv_out) is torch.nn.Conv2d
    mods = [m for m in unet.modules() if isinstance(m, TU.Conv3x3)]
    assert mods and all(m.stride == (1, 1) and m.kernel_size == (3, 3)
                        and m.padding == (1, 1) for m in mods)
    strided = [m for m in unet.modules() if isinstance(m, torch.nn.Conv2d)
               and m.stride == (2, 2)]
    assert strided and not any(isinstance(m, TU.Conv3x3) for m in strided)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On the card: the kernel against its plain version where a 128-pixel
    tile wraps image rows and batch rows (W = 8), bf16 tolerance 2e-2 of
    the output's max (chip_smoke.py's check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the same check")
    x, w, b = (torch.from_numpy(t).cuda().bfloat16()
               for t in _inputs(3, 8, 8, 128, 64))
    ref = T.conv3x3_plain(x, w, b).float()
    T.reset_launches()
    out = T.conv3x3(x, w, b).float()
    assert T.LAUNCHES["conv3x3"] == 1
    assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()
