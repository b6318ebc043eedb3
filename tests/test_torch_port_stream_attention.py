"""The port's streaming attention (the counterpart of the JAX package's
online-softmax kernel) and the rule that chooses it.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there). Here the plain version, a blockwise online softmax
written out in PyTorch, is held against the JAX package's kernel in
interpret mode, entered as its own tests enter it (``block_q=128,
block_k=128``), on the same numpy inputs. Tolerances: float32 1e-5 absolute
(the same recurrence; only the order of the sums differs); bfloat16 2e-2
absolute on outputs of size ~1 (the JAX path rounds Q*scale to bfloat16
before the product, the port scales the float32 scores, and both round the
probabilities and the output to bfloat16: a few 2^-8 steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.ops import attention as J
from rich_text_to_image_tpu_torch.ops import attention as T
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL_F32 = 1e-5
ATOL_BF16 = 2e-2


def _qkv(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d))]


@pytest.mark.parametrize("b,h,sq,skv,d", [
    (1, 2, 256, 256, 64),   # aligned
    (2, 2, 128, 128, 40),   # the 64^2 and 96^2 levels' head dim
    (1, 1, 300, 300, 64),   # ragged Sq and Skv: the masked last block
    (1, 2, 256, 77, 64),    # Skv below one block
    (1, 1, 64, 512, 160),   # the 1280-channel level's head dim
])
def test_stream_plain_matches_jax_online_kernel_f32(b, h, sq, skv, d):
    q, k, v = _qkv(sq + skv + d, b, h, sq, skv, d)
    want = np.asarray(J.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
        block_k=128, interpret=True))
    got = T.flash_attention_stream_plain(
        *map(torch.from_numpy, (q, k, v)), block_k=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_F32)


@pytest.mark.parametrize("b,h,s,d", [(1, 2, 256, 40), (1, 2, 200, 80)])
def test_stream_plain_matches_jax_online_kernel_bf16(b, h, s, d):
    q, k, v = _qkv(s + d, b, h, s, s, d)
    want = np.asarray(J.flash_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), block_q=128,
        block_k=128, interpret=True).astype(jnp.float32))
    got = T.flash_attention_stream_plain(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)), block_k=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=ATOL_BF16)


@pytest.mark.parametrize("block_k", [64, 128, 512])
def test_stream_plain_is_the_same_function_as_the_full_row_plain(block_k):
    """Whatever the block size, and with query rows in several chunks."""
    q, k, v = map(torch.from_numpy, _qkv(9, 1, 2, 300, 333, 40))
    want = T.flash_attention_plain(q, k, v)
    got = T.flash_attention_stream_plain(q, k, v, block_k=block_k,
                                         block_q=128)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL_F32)


def test_fits_full_row_copies_the_jax_rule():
    """The port's copy of the JAX package's full-row fit, over a grid of
    shapes and both item sizes, as ``_flash_impl`` calls it."""
    n = 0
    for itemsize in (2, 4):
        for d in (40, 64, 80, 128, 160):
            for sq in (64, 576, 1024, 2304, 4096, 9216, 16384):
                for skv in (77, 576, 1000, 4096, 9000, 9216, 16384, 40000):
                    want = J._full_path_layout(
                        sq, J._round_up(skv, 128), J._round_up(d, 128),
                        itemsize)
                    assert T._fits_full_row(sq, skv, d, itemsize) == want, (
                        sq, skv, d, itemsize)
                    n += want is None
    assert n > 50  # the grid reaches both sides of the rule


# SD-1.5 self-attention shapes (S, d) at S >= 512, by image size, and the
# kernel the JAX dispatch takes for each in bfloat16
@pytest.mark.parametrize("size,shapes", [
    (512, {(4096, 40): "full", (1024, 80): "full_t"}),
    (768, {(9216, 40): "stream", (2304, 80): "full", (576, 160): "full"}),
    (1024, {(16384, 40): "stream", (4096, 80): "full", (1024, 160): "full"}),
])
def test_dispatch_names_the_jax_kernel(size, shapes, monkeypatch):
    """The bucket the port counts a launch under is the kernel the JAX
    package runs for that shape: ``_flash_impl`` is entered at the shape
    with its ``pallas_call`` replaced by a recorder."""
    for (s, d), want in shapes.items():
        assert s == (size // 8 // {40: 1, 80: 2, 160: 4}[d]) ** 2
        assert T._bucket(s, s, d) == want, (s, d)

        taken = []

        def fake_pallas_call(kernel, **kw):
            fn = getattr(kernel, "func", kernel)
            taken.append(fn.__name__)
            shape = kw["out_shape"]
            return lambda *a: jnp.zeros(shape.shape, shape.dtype)

        monkeypatch.setattr(J.pl, "pallas_call", fake_pallas_call)
        x = jnp.zeros((1, 1, s, d), jnp.bfloat16)
        J._flash_impl(x, x, x, d ** -0.5, None, 512, False)
        names = {"_full_kernel": "full", "_full_kernel_t": "full_t",
                 "_flash_kernel": "stream"}
        assert [names[t] for t in taken] == [want], (s, d, taken)


def test_block_q_forces_the_streaming_path():
    assert T._bucket(1024, 1024, 80) == "full_t"
    assert T._bucket(1024, 1024, 80, block_q=128) == "stream"
    assert T._stream_tile(512) == 128 and T._stream_tile(128) == 128
    assert T._stream_tile(64) == 64 and T._stream_tile(100) == 64


def test_wrapper_takes_the_streaming_plain_version_on_cpu():
    """On CPU tensors ``flash_attention`` with named blocks returns the
    streaming plain version's result and counts no launch."""
    q, k, v = map(torch.from_numpy, _qkv(4, 1, 2, 200, 200, 40))
    T.reset_launches()
    got = T.flash_attention(q, k, v, block_q=128, block_k=128)
    torch.testing.assert_close(
        got, T.flash_attention_stream_plain(q, k, v, block_k=128))
    assert set(T.LAUNCHES.values()) == {0}


@pytest.mark.cuda
def test_stream_kernel_matches_plain_on_card():
    """On the card: the streaming kernel against its plain version at a
    ragged length, bf16 tolerance 2e-2 of max|o| (chip_smoke.py's check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the same check")
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, s, d = 1, 4, 9000, 40
    q, k, v = [torch.randn((b, s, h * d), generator=g, device="cuda",
                           dtype=torch.bfloat16).view(b, s, h, d)
               .transpose(1, 2) for _ in range(3)]
    q.mul_(2.0)
    q[..., 0] = 8.0
    k[..., 0] = -10.0 * d ** 0.5 / 8.0
    ref = T.flash_attention_stream_plain(q, k, v).float()
    T.reset_launches()
    out = T.flash_attention(q, k, v).float()
    assert T.LAUNCHES["stream"] == 1
    assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()
