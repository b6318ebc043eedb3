"""The port's evaluation suite against the JAX package's: the data tables,
the metrics, and whole benchmark runs, after ``tests/test_evaluation.py``.

``benchmark_color.run`` on the trained colour fixture and
``benchmark_style.run`` on the tiny model, sequential (1) and batched (2),
each on both packages with the same parameters (the port's bridged from
JAX's), float32 on the CPU. Two things are shared so that both runs see the
same inputs: the per-seed latent (the port's ``draw_latents`` is patched to
return the JAX package's draw) and the token maps (both packages'
``get_token_maps`` are patched to one soft partition from the seed; the
port's token maps are held against JAX's in ``test_torch_port_host.py``).
The style runs take the JAX tiny CLIP scorer and its bridge. Every
statistic of a summary must agree within 1e-3 of its largest: distances
and scores of uint8 images, where a float difference of 1e-4 may flip a
pixel by one step.
"""

import json
import types

import jax
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.evaluation import benchmark_color as JBC
from rich_text_to_image_tpu.evaluation import benchmark_style as JBS
from rich_text_to_image_tpu.evaluation import metrics as JM
from rich_text_to_image_tpu.evaluation import suites as JSU
from rich_text_to_image_tpu.evaluation.fixtures import load_color_fixture
from rich_text_to_image_tpu.models.config import (CLIPTextConfig as JTextCfg,
                                                  CLIPVisionConfig as JVisCfg)
from rich_text_to_image_tpu.utils import clip_score as JS
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.evaluation import benchmark_color as TBC
from rich_text_to_image_tpu_torch.evaluation import benchmark_style as TBS
from rich_text_to_image_tpu_torch.evaluation import metrics as TM
from rich_text_to_image_tpu_torch.evaluation import suites as TSU
from rich_text_to_image_tpu_torch.models.clip import CLIPTextModel
from rich_text_to_image_tpu_torch.models.clip_vision import CLIPVisionModel
from rich_text_to_image_tpu_torch.models.config import (CLIPTextConfig,
                                                        CLIPVisionConfig)
from rich_text_to_image_tpu_torch.pipelines import region_sd as TP
from rich_text_to_image_tpu_torch.utils import clip_score as TS
from torch_port_pipes import port_of, tiny_pipes
from torch_port_ranks import world_of_one  # noqa: F401 (fixture)
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)


def test_suite_tables_equal_jax():
    names = [n for n in dir(JSU) if n.isupper()]
    assert names == [n for n in dir(TSU) if n.isupper()]
    for n in names:
        assert getattr(TSU, n) == getattr(JSU, n), n
    assert len(TSU.COLOR_SUITES["common"]) == 17 and len(TSU.STYLES) == 7


def test_metrics_equal_jax():
    rng = np.random.default_rng(0)
    for i in range(6):
        img = rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)
        mask = rng.uniform(size=(24, 24)) * (rng.uniform(size=(24, 24)) > 0.4)
        target = rng.uniform(size=3)
        name = ("black", "white", "red")[i % 3]
        assert (TM.color_distances(img, mask, target, name)
                == JM.color_distances(img, mask, target, name))
        np.testing.assert_array_equal(TM.compose_region(img, mask),
                                      JM.compose_region(img, mask))
    a, b = TM.RunningStats(), JM.RunningStats()
    for v in rng.uniform(size=5):
        a.add(v)
        b.add(v)
    assert (a.mean, a.std, len(a), a.fmt()) == (b.mean, b.std, len(b),
                                                b.fmt())
    assert np.isnan(TM.RunningStats().mean)


def _jax_draw(shape, seed, device):
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), tuple(shape)))).to(device)


def _share_inputs(monkeypatch, j_mod, t_mod):
    """The port draws the JAX latent, and both packages' token maps are one
    soft partition of the latent from a seed (the tiny models' own maps
    give the object no region, which would leave the scores blind to the
    images)."""
    def maps(agg, obj_tokens, latent_hw, seed, **kw):
        soft = np.random.RandomState(seed + len(obj_tokens)).rand(
            len(obj_tokens) + 1, *latent_hw).astype(np.float32) ** 3
        return list((soft / soft.sum(0, keepdims=True))[:, None])

    monkeypatch.setattr(TP, "draw_latents", _jax_draw)
    monkeypatch.setattr(j_mod, "get_token_maps", maps)
    monkeypatch.setattr(t_mod, "get_token_maps", maps)


def _stats_close(got, want, keys):
    """Every number of ``want[k]`` but the count within 1e-3 of the largest
    of them (a mean of scores that cancel can sit far below its terms)."""
    for k in keys:
        assert got[k]["n"] == want[k]["n"] > 0, k
        nums = {s: v for s, v in want[k].items() if s != "n"}
        tol = 1e-3 * max(max(abs(v) for v in nums.values()), 1e-2)
        for s, v in nums.items():
            assert abs(got[k][s] - v) <= tol, (k, s, got[k], want[k])


@pytest.fixture(scope="module")
def fixture_pipes():
    jp = load_color_fixture()
    return jp, port_of(jp)


@pytest.mark.parametrize("batch", [1, 2])
def test_benchmark_color_summary_matches_jax(fixture_pipes, monkeypatch,
                                             tmp_path, batch):
    jp, tp = fixture_pipes
    _share_inputs(monkeypatch, JBC, TBC)
    argv = ["--limit", "2", "--num_seeds", "1", "--steps", "4",
            "--batch_colors", str(batch)]
    want = JBC.run(JBC.make_parser().parse_args(
        argv + ["--save_path", str(tmp_path / "jax")]), model=jp)
    got = TBC.run(TBC.make_parser().parse_args(
        argv + ["--save_path", str(tmp_path / "port"), "--device", "cpu"]),
        model=tp)
    _stats_close(got, want, ("plain_min", "plain_avg", "ours_min",
                             "ours_avg"))
    assert got["ours_min"]["n"] == 2 and got["p2p_min"]["n"] == 0
    assert got["ours_avg"]["mean"] != got["plain_avg"]["mean"]
    saved = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert saved["config"]["batch_colors"] == batch


def _style_scorers():
    tok = TS.CLIPTokenizer.byte_level()
    tiny_t = dict(vocab_size=1000, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=2,
                  projection_dim=16)
    tiny_v = dict(image_size=32, patch_size=8, hidden_size=32,
                  intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=2, projection_dim=16)
    js = JS.CLIPScorer.random_init(seed=0, text_cfg=JTextCfg(**tiny_t),
                                   vision_cfg=JVisCfg(**tiny_v),
                                   tokenizer=tok)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    ts = TS.CLIPScorer(
        weights.load_flax(CLIPTextModel(CLIPTextConfig(**tiny_t)),
                          np_tree(js.text_params), "text"),
        weights.load_flax(CLIPVisionModel(CLIPVisionConfig(**tiny_v)),
                          np_tree(js.vision_params), "clip_vision"),
        tok, device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def tiny():
    return tiny_pipes()


@pytest.mark.parametrize("batch", [1, 2])
def test_benchmark_style_summary_matches_jax(tiny, monkeypatch, tmp_path,
                                             batch):
    jp, tp = tiny
    _share_inputs(monkeypatch, JBS, TBS)
    js, ts = _style_scorers()
    argv = ["--limit", "2", "--num_seeds", "1", "--steps", "4",
            "--batch_pairs", str(batch)]
    want = JBS.run(JBS.make_parser().parse_args(
        argv + ["--save_path", str(tmp_path / "jax")]), model=jp, scorer=js)
    got = TBS.run(TBS.make_parser().parse_args(
        argv + ["--save_path", str(tmp_path / "port"), "--device", "cpu"]),
        model=tp, scorer=ts)
    assert got["ours"]["n"] == 4 and got["clip_scores_random_weights"] is False
    _stats_close(got, want, ("ours",))


def test_random_scorer_banner(monkeypatch, capsys):
    """Without --clip_dir the scorer has random weights and a banner says
    so; an explicit scorer prints nothing and is not flagged."""
    class DummyScorer:
        def get_clip_score(self, image, text):
            return 0.5

    monkeypatch.setattr(TS.CLIPScorer, "random_init",
                        classmethod(lambda c, **kw: DummyScorer()))
    args = TBS.make_parser().parse_args(["--save_path", "unused"])
    scorer, is_random = TBS._resolve_scorer(
        args, types.SimpleNamespace(tokenizer=None), None)
    assert isinstance(scorer, DummyScorer) and is_random is True
    assert "RANDOM-WEIGHT" in capsys.readouterr().out
    scorer2, is_random2 = TBS._resolve_scorer(args, None, DummyScorer())
    assert is_random2 is False
    assert "RANDOM-WEIGHT" not in capsys.readouterr().out


@pytest.mark.parametrize("mod", [TBC, TBS], ids=["color", "style"])
def test_mesh_exits(mod, tmp_path, world_of_one):
    """``--mesh`` asks for more devices than a world of one process has:
    the ``ValueError`` names both counts, before the model is touched (the
    runs under a mesh are in ``tests/test_torch_port_mesh_pipeline.py``)."""
    args = mod.make_parser().parse_args(
        ["--mesh", "2", "--save_path", str(tmp_path)])
    with pytest.raises(ValueError, match="wants 2 devices .* has 1 "):
        mod.run(args, model=object())


def test_device_defaults_to_the_card():
    for mod in (TBC, TBS):
        assert mod.make_parser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("mod,flag", [(TBC, "--batch_colors"),
                                      (TBS, "--batch_pairs")],
                         ids=["color", "style"])
def test_save_img_then_load_previous(tiny, mod, flag, tmp_path):
    """A run with --save_img writes one PNG an item; --load_previous scores
    those files instead of generating, to the same summary."""
    _, tp = tiny
    argv = ["--limit", "2", "--num_seeds", "1", "--steps", "2",
            "--save_path", str(tmp_path), "--device", "cpu", flag, "2"]
    kw = {}
    if mod is TBS:
        kw["scorer"] = _style_scorers()[1]
    first = mod.run(mod.make_parser().parse_args(argv + ["--save_img"]),
                    model=tp, **kw)
    pngs = sorted(p.name for p in tmp_path.glob("ours_*.png"))
    assert len(pngs) == 2
    again = mod.run(mod.make_parser().parse_args(argv + ["--load_previous"]),
                    model=tp, **kw)
    for k, v in first.items():
        if k != "config":
            np.testing.assert_equal(again[k], v, err_msg=k)
