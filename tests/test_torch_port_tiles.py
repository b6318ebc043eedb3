"""The Python rules that pick the tiles of the port's wgmma kernels.

``attn_fwd_kernel`` and ``conv3x3_kernel`` are built for a few tile shapes;
which one a launch takes is decided in Python (``ops/attention._fwd_tile``,
``ops/conv._plan``) and passed to the C entry, so the rules can be held here,
on the CPU, over the shapes the paths of ``chip_smoke.py`` give the kernels:

  * attention: the query rows a CTA (64, 128 or 192: one to three
    warpgroups) are those with the least waves x cost a wave, 64 only where
    64-row CTAs all run at once; the keys a tile are a pair the CUDA source
    builds, and in the streaming bucket at most what the caller's
    ``block_k`` allows; the capture's head average takes 64 or 128 rows a
    CTA, 128 only up to head dim 80;
  * convolution: the N tile is 160 at the SD-1.5 widths, else 128 or 64,
    and always divides O; the (M tile, N tile) pair is one the CUDA source
    builds; the split over K leaves no range empty, has at most as many
    ranges as steps, and is one range wherever the tiles alone give every
    SM a CTA.
"""

import importlib.util
import os
import re

import pytest

from rich_text_to_image_tpu_torch.ops import attention as A
from rich_text_to_image_tpu_torch.ops import conv as CV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "rich_text_to_image_tpu_torch", "csrc")
SMS = 132


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # imports the standard library only
    return mod


SMOKE = _smoke()
ATTN_SHAPES = sorted({(b, h, s, d) for _, _, b, h, s, d, _, kw
                      in SMOKE.ATTN_CASES if not kw})
PAVG_SHAPES = sorted({(b, h, s, d) for _, kind, b, h, s, d, _, _
                      in SMOKE.ATTN_CASES if kind == "avgp"})
CONV_SHAPES = [(b, r, c, o) for b in (1, 2, 4, 6)
               for r, c, o in SMOKE.SD15_CONV_SHAPES]


def _source(name):
    with open(os.path.join(CSRC, name), encoding="utf-8") as f:
        return f.read()


def _built_keys(dp: int, block_m: int):
    """The keys a tile that ``launch_fwd`` (csrc/attention.cu) builds for a
    padded head dim and a row count (None: not built), read from its
    constants."""
    src = _source("attention.cu")
    assert "constexpr int TK1 = DP == 80 ? 128 : 64;" in src
    assert "constexpr int TK2 = DP == 48 ? 128 : 64;" in src
    assert re.search(r"if constexpr \(DP <= 80\) \{\s*RTT_FWD_TILE\(64, 3\)",
                     src)
    if block_m == 64:
        return 128 if dp == 80 else 64
    if block_m == 128:
        return 128 if dp == 48 else 64
    return 64 if block_m == 192 and dp <= 80 else None


def _waves(b, h, s, block_m):
    return -(-(-(-s // block_m) * b * h) // SMS)


@pytest.mark.parametrize("b,h,s,d", ATTN_SHAPES)
def test_attention_tile_over_the_paths_shapes(b, h, s, d):
    block_m, block_k = A._fwd_tile(b, h, s, d)
    dp = (48 if d <= 48 else 64 if d <= 64 else 80 if d <= 80
          else 128 if d <= 128 else 160)  # RTT_DISPATCH
    assert block_k == _built_keys(dp, block_m)  # a pair that is built
    cost = {m: _waves(b, h, s, m) * c for m, c in A._WAVE_COST.items()
            if _built_keys(dp, m) is not None}
    assert cost[block_m] == min(cost.values())
    if block_m == 64:
        # the smallest CTA only where it gives every CTA an SM of its own,
        # or where the larger ones' extra waves cost more
        assert _waves(b, h, s, 64) == 1 or cost[64] < cost[128]


def test_attention_tile_rule_at_its_edge():
    # 132 CTAs of 64 rows run at once, one an SM: the smallest CTA
    assert A._fwd_tile(1, 4, 33 * 64, 40)[0] == 64
    # the main path's shapes: three warpgroups at 64^2 (352 CTAs in 3 waves
    # against 512 in 4), two at 32^2 (128 CTAs in one wave), and never three
    # above head dim 80
    assert A._fwd_tile(2, 8, 4096, 40) == (192, 64)
    assert A._fwd_tile(2, 8, 1024, 80) == (128, 64)
    assert A._fwd_tile(2, 8, 576, 160) == (128, 64)
    assert all(A._fwd_tile(b, 8, s, 160)[0] < 192
               for b in (1, 2, 4, 6) for s in (576, 1024, 2304, 4096))
    # [4,8,576,160]: 288 CTAs of 64 rows in 3 waves measured faster than 160
    # of 128 rows in 2
    assert A._fwd_tile(4, 8, 576, 160) == (64, 64)


def test_attention_tile_at_the_sdxl_shapes():
    """SDXL's head dim 64 runs at its own instantiation, whose tiles are
    64 keys at every row count. What ``scripts/port_tile_sweep.py
    attention`` measured at the SDXL 1024^2 shapes (PERF.md): the rule's
    tile within 3% of the fastest at each; 128 rows at [2,10,4096,64]
    (640 CTAs in 5 waves), 192 at [4,10,4096,64] and at 32^2 with 20
    heads."""
    assert A._padded(64) == 64 and A._FWD_TILES[64] == {64: 64, 128: 64,
                                                        192: 64}
    assert A._fwd_tile(2, 10, 4096, 64) == (128, 64)
    assert A._fwd_tile(4, 10, 4096, 64) == (192, 64)
    assert A._fwd_tile(6, 10, 4096, 64) == (192, 64)
    assert A._fwd_tile(2, 20, 1024, 64) == (192, 64)
    assert A._fwd_tile(2, 20, 1000, 64) == (192, 64)
    assert A._pavg_tile(2, 1024, 1024, 64) == 128


def test_attention_tile_at_the_flux_shapes():
    """FLUX.1's head dim 128 runs at its own instantiation (two 128-byte
    swizzle rows, no padding), with one or two warpgroups of 64 keys; the
    capture's second kernel one warpgroup, as above head dim 80. At the
    joint attention's [1 / 2, 24, 4608, 128] the 128-row CTA (chip_smoke's
    kernel lines, PERF.md)."""
    assert A._padded(128) == 128 and A._padded(120) == 128
    assert A._padded(136) == 160
    assert A._FWD_TILES[128] == {64: 64, 128: 64}
    assert A._fwd_tile(1, 24, 4608, 128) == (128, 64)
    assert A._fwd_tile(2, 24, 4608, 128) == (128, 64)
    assert A._pavg_tile(1, 4608, 4608, 128) == 64
    assert A._bucket(4608, 4608, 128) == "full"


def test_attention_tile_at_the_long_rows():
    """The streaming bucket's shapes (768^2: S = 9216; 1024^2: S = 16384),
    beyond the S <= 4096 the wave costs were fitted at. What
    ``scripts/port_tile_sweep.py attention`` measured there (PERF.md): the
    192-row CTAs where there are many waves of them, and at [1,2,16384,40],
    where 171 CTAs of 192 rows would take two waves for 1.3 waves' work,
    the 128-row tile of 128 keys."""
    for b in (2, 4):
        assert A._fwd_tile(b, 8, 9216, 40) == (192, 64)
    assert A._fwd_tile(2, 8, 9000, 40) == (192, 64)
    assert A._fwd_tile(2, 8, 16384, 40) == (192, 64)
    assert A._fwd_tile(1, 2, 16384, 40) == (128, 128)


@pytest.mark.parametrize("block_k", [32, 64, 100, 128, 192, 256, 512, 1024])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_stream_key_tile_follows_block_k(block_k, d):
    """The caller's ``block_k`` caps the streaming bucket's key tile: a
    multiple of 64 from 128 up allows 128-key tiles, anything else 64; the
    tile is then the cheapest built pair under the cap."""
    cap = A._stream_tile(block_k)
    assert cap == (128 if block_k >= 128 and block_k % 64 == 0 else 64)
    dp = 48 if d <= 48 else 80 if d <= 80 else 160
    for b, h, s in ((2, 8, 9216), (1, 2, 16384), (2, 8, 1000)):
        block_m, keys = A._fwd_tile(b, h, s, d, cap)
        assert keys <= cap and keys == _built_keys(dp, block_m)
        cost = {m: _waves(b, h, s, m) * c for m, c in A._WAVE_COST.items()
                if _built_keys(dp, m) is not None
                and _built_keys(dp, m) <= cap}
        assert cost[block_m] == min(cost.values())
    # without a cap the streaming bucket takes the full-row tiles
    if cap == 128:
        assert A._fwd_tile(2, 8, 9216, d, cap) == A._fwd_tile(2, 8, 9216, d)


def _pavg_waves(b, sq, skv, rows):
    return -(-(-(-sq // rows) * -(-skv // 128) * b) // SMS)


@pytest.mark.parametrize("b,h,s,d", PAVG_SHAPES + [
    (4, 8, 1024, 80), (1, 8, 1024, 80), (2, 8, 4096, 40), (6, 8, 4096, 40)])
def test_pavg_tile_rule(b, h, s, d):
    """attn_pavg_kernel's rows a CTA: the least waves x cost a wave, 128
    rows only up to head dim 80 (``launch_pavg`` builds two warpgroups
    there only)."""
    src = _source("attention.cu")
    assert re.search(r"if constexpr \(DP <= 80\) \{\s*if \(block_m == 128\)",
                     src)
    rows = A._pavg_tile(b, s, s, d)
    if d > 80:
        assert rows == 64
        return
    cost = {m: _pavg_waves(b, s, s, m) * c
            for m, c in A._PAVG_WAVE_COST.items()}
    assert cost[rows] == min(cost.values())


def test_pavg_tile_follows_the_measured_choices():
    """What ``scripts/port_tile_sweep.py pavg`` measured fastest (PERF.md):
    two warpgroups where their CTAs fill the card, one where only that
    does, and one above head dim 80."""
    assert A._pavg_tile(2, 1024, 1024, 80) == 128
    assert A._pavg_tile(2, 2304, 2304, 80) == 128
    assert A._pavg_tile(1, 1024, 1024, 80) == 64
    assert A._pavg_tile(2, 576, 576, 160) == 64
    assert A._pavg_tile(2, 1024, 1024, 160) == 64


def _built_conv_tiles():
    return {(int(m), int(n)) for m, n in re.findall(
        r"RTT_CONV_TILE\((\d+), (\d+)\)", _source("conv.cu"))}


@pytest.mark.parametrize("b,r,c,o", CONV_SHAPES)
def test_conv_plan_over_the_unets_shapes(b, r, c, o):
    m = b * r * r
    tile_m, tile_n = CV.conv_tile(m, c, o)
    assert tile_n == 160 and o % tile_n == 0  # 320, 640, 1280
    assert (tile_m, tile_n) in _built_conv_tiles()
    splits, steps = CV.k_splits(m, c, o), 9 * c // 64
    assert 1 <= splits <= min(steps, CV.MAX_SPLITS)
    per = -(-steps // splits)
    assert per * (splits - 1) < steps  # no range is empty
    if -(-m // tile_m) * (o // tile_n) >= SMS:
        assert splits == 1


@pytest.mark.parametrize("o,want", [(64, 64), (128, 128), (192, 64),
                                    (256, 128), (384, 128), (448, 64),
                                    (960, 160), (1280, 160)])
def test_conv_n_tile_divides_o(o, want):
    for m, c in ((117, 640), (1536, 64), (8192, 320)):
        tile_m, tile_n = CV.conv_tile(m, c, o)
        assert tile_n == want and o % tile_n == 0
        assert (tile_m, tile_n) in _built_conv_tiles()
        splits, steps = CV.k_splits(m, c, o), 9 * c // 64
        assert 1 <= splits <= steps
        assert -(-steps // splits) * (splits - 1) < steps


def test_conv_plan_follows_the_measured_choices():
    """The choices the cost model was fitted to (PERF.md): one range where a
    128-row tile nearly fills the card, 256-row tiles where M is large, a
    split where the image is small."""
    assert CV._plan(2 * 64 * 64, 320, 320) == (128, 160, 1)
    assert CV._plan(4 * 64 * 64, 320, 320) == (256, 160, 1)
    assert CV._plan(2 * 32 * 32, 1920, 640) == (256, 160, 4)
    assert CV._plan(2 * 8 * 8, 2560, 1280) == (128, 160, 8)
    # a single step cannot be split
    assert CV.k_splits(64, 64, 64) <= 9
