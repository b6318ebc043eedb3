"""Image sizes other than 512^2 in the port: the head dim 160 that the
1280-channel level brings onto the kernels' path at 768^2 and 1024^2, the
capture layout at other latent sizes, and two trajectories through one PNDM
step.

The fault these tests show: at 768^2 SD-1.5's third level has S = 24^2 =
576 >= 512 tokens at head dim 1280 / 8 = 160. The JAX package runs its
full-row kernel there; the port's kernels took at most 96 and its wrapper
raised, so the CLI died on the card at ``--height 768 --width 768``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models import unet as JU
from rich_text_to_image_tpu.ops import attention as J
from rich_text_to_image_tpu.pipelines.region_sd import (
    RegionDiffusion as JRegion)
from rich_text_to_image_tpu.schedulers.pndm import PNDMScheduler as JPNDM
from rich_text_to_image_tpu_torch.models import unet as TU
from rich_text_to_image_tpu_torch.ops import attention as T
from rich_text_to_image_tpu_torch.pipelines.region_sd import (
    RegionDiffusion as TRegion)
from rich_text_to_image_tpu_torch.schedulers.pndm import (
    PNDMScheduler as TPNDM)
from rich_text_to_image_tpu_torch.utils.registries import (
    attn_layer_resolutions)
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)


def _third_level(size: int):
    """(tokens, head dim) of SD-1.5's third level at a size x size image."""
    cfg = C.SD15_UNET
    side = size // 8 // 4
    return side * side, cfg.block_out_channels[2] // cfg.heads_per_level[2]


@pytest.mark.parametrize("size", [768, 1024])
def test_third_level_takes_the_flash_path_on_both_sides(size):
    s, d = _third_level(size)
    assert (s, d) == ({768: 576, 1024: 1024}[size], 160)
    # the JAX package: flash path from 512 tokens (off the CPU), and its
    # full-row kernel fits at this shape
    JU.force_flash(False)
    assert s >= 512
    assert J._full_path_layout(s, J._round_up(s, 128), 256, 2) is not None
    # the port: the same threshold, the same bucket, and kernels that take it
    assert TU._use_flash(s)
    assert T._bucket(s, s, d) == "full"
    assert T.avg_probs_kernel_fits(s, s, d)
    q = torch.zeros((2, 8, s, d), dtype=torch.bfloat16)
    T._check("flash_attention", q, q, q)  # raised for d > 96 before
    assert T.MAX_HEAD_DIM == 160


def test_full_row_plain_matches_jax_kernel_at_head_dim_160():
    """The function the d = 160 instantiation computes, against the JAX
    full-row kernel in interpret mode (float32, atol 1e-5)."""
    rng = np.random.default_rng(160)
    q, k, v = (rng.standard_normal((1, 2, 576, 160)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(J.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = T.flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _layouts(hw):
    # _capture_layout reads the config only: no weights are needed
    jr, tr = object.__new__(JRegion), object.__new__(TRegion)
    jr.unet_cfg = tr.unet_cfg = C.SD15_UNET
    return jr._capture_layout(hw), tr._capture_layout(hw)


@pytest.mark.parametrize("hw", [(64, 64), (128, 128), (64, 96), (8, 8)])
def test_capture_layout_matches_jax_where_a_level_sits_at_32_rows(hw):
    j, t = _layouts(hw)
    assert t == j
    assert len(t[1]) == 5  # the five layers of the segmentation level


def test_capture_layout_at_768_takes_the_next_finer_level():
    """A 96-row latent has levels at 96, 48, 24 and 12 rows and none at the
    reference's 32. The JAX rule then names no self-attention layer, and
    its self-attention sum stays zero; the port segments at 48 rows."""
    (j_res, j_layers, j_cross), (t_res, t_layers, t_cross) = _layouts((96, 96))
    assert (j_res, j_layers) == (32, ())
    assert t_res == 48 and len(t_layers) == 5
    res = attn_layer_resolutions(C.SD15_UNET, (96, 96))
    assert {res[n] for n in t_layers} == {48}
    assert t_cross == j_cross  # the cross-attention maps are the same


def test_pndm_steps_two_stacked_trajectories_as_jax():
    """The in-batch reference flow sends [rich, reference] through one
    step: a batch of 2 in the state. Against the JAX scheduler on the same
    model outputs, and against two separate batch-1 runs (atol 1e-5)."""
    rng = np.random.default_rng(2)
    shape = (2, 8, 8, 4)
    lat = rng.standard_normal(shape).astype(np.float32)
    eps = rng.standard_normal((13, *shape)).astype(np.float32)
    js, ts = JPNDM(), TPNDM()
    jp, tp = js.plan(12), ts.plan(12)
    jst, tst = js.init_state(shape), ts.init_state(shape, "cpu")
    one = [ts.init_state((1, *shape[1:]), "cpu") for _ in range(2)]
    jl, tl = jnp.asarray(lat), torch.from_numpy(lat)
    ol = [torch.from_numpy(lat[r:r + 1]) for r in range(2)]
    for i in range(13):
        jl, jst = js.step(jp, i, jst, jnp.asarray(eps[i]), jl)
        tl, tst = ts.step(tp, i, tst, torch.from_numpy(eps[i]), tl)
        for r in range(2):
            ol[r], one[r] = ts.step(tp, i, one[r],
                                    torch.from_numpy(eps[i, r:r + 1]), ol[r])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(tl.numpy(), torch.cat(ol).numpy(), rtol=0,
                                   atol=1e-5)
