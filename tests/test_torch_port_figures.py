"""The port's segmentation and token-map figures and ``--save_attn`` dumps
against the JAX package's.

Pixels are not compared: the JAX package draws through matplotlib, the port
colours the arrays through tables and writes PNG itself. What is compared
is what the figures are drawn from and what is dumped: with the JAX
package's cluster labels handed over, the foreground maps before the
resize and the masks after it that ``get_token_maps`` hands its figure
functions (atol 1e-6: the same float32 resize matrices), and the
``maps/selfattn_maps.npy`` / ``crossattn_maps.npy`` files (atol 1e-6).
Then the figures themselves: the file names, PNG sizes, the colour tables
against matplotlib's colormaps, and the visualize_token_maps CLI on the
tiny pipeline.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.utils import token_maps as j_tm
from rich_text_to_image_tpu.utils import viz as j_viz
from rich_text_to_image_tpu_torch.cli import visualize_token_maps as t_vis
from rich_text_to_image_tpu_torch.utils import token_maps as t_tm
from rich_text_to_image_tpu_torch.utils import viz as t_viz
from torch_port_pipes import tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

RES = 16


def _aggregates():
    rng = np.random.default_rng(3)
    blocks = [90, 86, 80]
    n = sum(blocks)
    a = rng.random((n, n)).astype(np.float32) * 0.05
    start = 0
    for b in blocks:
        a[start:start + b, start:start + b] += 1.0
        start += b
    a = (a + a.T) / 2
    a = a / a.sum(axis=1, keepdims=True)
    cross = {4: rng.random((16, 77)).astype(np.float32),
             8: rng.random((64, 77)).astype(np.float32),
             16: rng.random((256, 77)).astype(np.float32)}
    return a.astype(np.float32), cross


def _capture(monkeypatch, module):
    """Replace ``module``'s figure functions by recorders of their
    arguments."""
    seen = {}
    monkeypatch.setattr(module, "save_segmentation",
                        lambda clusters, d, k, s: seen.update(
                            clusters=np.asarray(clusters), k=k, seed=s))
    monkeypatch.setattr(module, "plot_attention_maps",
                        lambda lists, toks, d, s, tokens_vis=None: seen.update(
                            lists=[[np.asarray(m) for m in ms]
                                   for ms in lists],
                            tokens_vis=tokens_vis))
    return seen


def test_figure_arrays_and_dumps_match_jax(monkeypatch, tmp_path):
    self_sum, cross = _aggregates()
    tokens = [np.array([2, 3]), np.array([5])]
    vis = ["a</w>", "red</w>", "cat</w>", "on</w>", "mat</w>"]
    jw, tw = _capture(monkeypatch, j_viz), _capture(monkeypatch, t_viz)
    ja = j_tm.AttnAggregates(self_sum=self_sum, self_count=5,
                             cross_sums=cross, cross_layer_count=8)
    j_dir, t_dir = tmp_path / "jax", tmp_path / "port"
    want, clusters = j_tm.get_token_maps(
        ja, tokens, (32, 32), seed=1, num_segments=3, n_init=5,
        return_segments=True, save_dir=str(j_dir), tokens_vis=vis,
        save_attn=True)
    ta = t_tm.AttnAggregates(self_sum=torch.from_numpy(self_sum),
                             self_count=5, cross_sums=cross,
                             cross_layer_count=8)
    got = t_tm.get_token_maps(ta, tokens, (32, 32), seed=1, num_segments=3,
                              clusters=clusters, save_dir=str(t_dir),
                              tokens_vis=vis, save_attn=True)
    np.testing.assert_array_equal(tw["clusters"], jw["clusters"])
    assert (tw["k"], tw["seed"]) == (jw["k"], jw["seed"]) == (3, 1)
    assert tw["tokens_vis"] == jw["tokens_vis"] == vis
    # [foreground maps before the resize], [masks after it]
    assert [len(x) for x in tw["lists"]] == [len(x) for x in jw["lists"]] \
        == [3, 3]
    for tl, jl in zip(tw["lists"], jw["lists"]):
        for t, j in zip(tl, jl):
            assert t.shape == j.shape
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    for name in ("selfattn_maps.npy", "crossattn_maps.npy"):
        t = np.load(t_dir / "maps" / name)
        j = np.load(j_dir / "maps" / name)
        assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_no_dumps_without_save_attn_or_save_dir(tmp_path):
    self_sum, cross = _aggregates()
    ta = t_tm.AttnAggregates(self_sum=torch.from_numpy(self_sum),
                             self_count=5, cross_sums=cross,
                             cross_layer_count=8)
    t_tm.get_token_maps(ta, [np.array([2])], (32, 32), seed=1,
                        num_segments=3, n_init=5, save_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        "average_seed1_attn0.png", "average_seed1_attn1.png",
        "segmentation_k3_seed1.png"]
    t_tm.get_token_maps(ta, [np.array([2])], (32, 32), seed=1,
                        num_segments=3, n_init=5, save_attn=True)
    assert not (tmp_path / "maps").exists()


def _read_png(path):
    """(rows, columns, colour type) and the pixels of an 8-bit PNG written
    without filters."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, _, ctype = hdr[:4]
    ch = 3 if ctype == 2 else 1
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch)
    return raw[:, 1:].reshape(h, w, ch)


def test_figures_are_written_as_png(tmp_path):
    labels = np.repeat(np.arange(4), 64).reshape(16, 16)
    img = t_viz.save_segmentation(labels, str(tmp_path), 4, 7)
    png = _read_png(tmp_path / "segmentation_k4_seed7.png")
    assert png.shape == img.shape == (128, 128, 3)
    np.testing.assert_array_equal(png, img)
    # one colour a label: viridis' ends for the first and the last
    assert tuple(png[0, 0]) == t_viz.VIRIDIS[0]
    assert tuple(png[-1, -1]) == t_viz.VIRIDIS[-1]
    maps = [np.random.default_rng(i).random((1, 8, 8)).astype(np.float32)
            for i in range(3)]
    fig = t_viz.plot_attention_maps([maps, maps[:2]], [], str(tmp_path), 7)
    for i, n in enumerate((3, 2)):
        png = _read_png(tmp_path / f"average_seed7_attn{i}.png")
        want_w = t_viz.GAP + n * (t_viz.CELL + t_viz.GAP) + t_viz.BAR \
            + t_viz.GAP
        assert png.shape == (t_viz.CELL, want_w, 3)
    np.testing.assert_array_equal(png, fig)


def test_colour_tables_follow_matplotlib():
    """OrRd is matplotlib's (ColorBrewer's nine colours, interpolated):
    within 2 uint8 steps, matplotlib reading its maps from 256 samples;
    viridis, held at 17 points, within 6."""
    mpl = pytest.importorskip("matplotlib")
    x = np.linspace(0.0, 1.0, 97)
    for table, name, tol in ((t_viz.ORRD, "OrRd", 2),
                             (t_viz.VIRIDIS, "viridis", 6)):
        want = np.asarray(mpl.colormaps[name](x))[:, :3] * 255
        got = t_viz.colorize(x, table, 0.0, 1.0)
        assert np.abs(got - want).max() <= tol, name
    # constant maps and values outside the scale
    assert t_viz.colorize(np.full((2, 2), 3.0), t_viz.ORRD, 3.0, 3.0).shape \
        == (2, 2, 3)
    assert tuple(t_viz.colorize(np.array(9.0), t_viz.ORRD, 0, 1)) == \
        t_viz.ORRD[-1]


def test_visualize_token_maps_cli_on_cpu(tmp_path):
    _, tp = tiny_pipes()
    args = t_vis.make_parser().parse_args(
        ["--device", "cpu", "--sample_steps", "4", "--height", "16",
         "--width", "16", "--num_segments", "3", "--run_dir", str(tmp_path),
         "--prompt", "a cat riding a scooter", "--words", "cat", "scooter"])
    masks, clusters = t_vis.run(tp, args)
    assert len(masks) == 3 and clusters.shape == (4, 4)
    np.testing.assert_allclose(sum(masks), 1.0, atol=1e-4)
    assert sorted(os.listdir(tmp_path)) == ["average_seed6_attn0.png",
                                            "segmentation_k3_seed6.png"]
    base, ids = t_vis.token_ids_of(tp.tokenizer, "a cat riding a scooter",
                                   ["cat", "scooter"])
    assert [base[i - 1] for i in ids[0]] == tp.tokenizer._tokenize("cat")
