"""The port's demo (``cli/gradio_app.py``, ``cli/examples.py``,
``cli/share_button.py``, ``cli/editor.html``) against the JAX package's,
after ``tests/test_gradio_app.py`` and ``tests/test_demo_contract.py``.

``run_generate`` runs the same request on the tiny JAX pipeline and on the
port's on the same parameters, float32 on the CPU. Two draws differ by
design and are handed over, as the other pipeline tests do: the port's
``draw_latents`` returns JAX's latent for the seed, and the port's
``get_token_maps`` takes the cluster labels that JAX's spectral clustering
gave (``clusters=``). Tolerances: the plain and rich uint8 images within a
mean of 0.1 and a max of 2 uint8 steps (rounding of float32 results that
agree to ~1e-5); the arrays the figures are drawn from (the cluster labels
and the token maps) within 1e-6. ``build_app`` runs through a recording
gradio stub (this file's own copy of ``tests/test_gradio_app.py``'s), since
gradio is not installed; the copies of the editor page, the examples and
the share button must equal the JAX package's.
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.cli import examples as j_ex
from rich_text_to_image_tpu.cli import gradio_app as j_app
from rich_text_to_image_tpu.cli import share_button as j_share
from rich_text_to_image_tpu.utils import token_maps as j_tm
from rich_text_to_image_tpu.utils import viz as j_viz
from rich_text_to_image_tpu_torch.cli import examples as t_ex
from rich_text_to_image_tpu_torch.cli import gradio_app as t_app
from rich_text_to_image_tpu_torch.cli import share_button as t_share
from rich_text_to_image_tpu_torch.pipelines import region_sd as TP
from rich_text_to_image_tpu_torch.utils import token_maps as t_tm
from rich_text_to_image_tpu_torch.utils import tracing
from rich_text_to_image_tpu_torch.utils import viz as t_viz
from torch_port_pipes import tiny_pipes
from torch_port_ranks import world_of_one  # noqa: F401 (fixture)
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PX, STEPS = 16, 4  # the tiny VAE halves the size: an 8^2 latent
# a footnote, a coloured span and a font size, as the demo's examples
RICH_JSON = json.dumps({"ops": [
    {"insert": "a "},
    {"attributes": {"color": "#ff0000"}, "insert": "red"},
    {"insert": " rose in a "},
    {"attributes": {"link": "a lush green summer garden"}, "insert": "garden"},
    {"insert": ", "},
    {"attributes": {"size": "50px"}, "insert": "detailed"},
    {"insert": "\n"},
]})


class _DemoError(Exception):
    pass


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipes(agg_start_step=2)


def _jax_draw(shape, seed, device):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(seed), tuple(shape)))).to(device)


def _record_figures(monkeypatch, module, seen):
    """Record what ``module``'s figure functions are handed (the JAX
    package's draw through matplotlib; nothing of it is compared)."""
    def seg(clusters, d, k, s):
        seen["clusters"] = np.asarray(clusters)
        return None

    def maps(lists, toks, d, s, tokens_vis=None):
        seen["maps"] = [np.asarray(m) for m in lists[0]]
        return None

    monkeypatch.setattr(module, "save_segmentation", seg)
    monkeypatch.setattr(module, "plot_attention_maps", maps)


def _run(app, model, tmp_path, knobs, **kw):
    return app.run_generate(
        model, PX, RICH_JSON, "", 3, STEPS, 7.5, 0.5, knobs[0], knobs[1],
        0.3, 4, ref_precompute=knobs[2], error_cls=_DemoError,
        vis_dir=str(tmp_path), **kw)


@pytest.mark.parametrize("knobs", [(0.0, 0.3, True), (0.3, 0.3, False)],
                         ids=["sd-defaults-refpre", "inject-in-batch"])
def test_run_generate_matches_jax(pipes, tmp_path, monkeypatch, knobs):
    """(inject_selfattn, inject_background, ref_precompute): the demo's SD
    defaults through the refer-precompute flow, and self-attention plus
    background injection through the in-batch flow."""
    jp, tp = pipes
    clusters = []
    j_get = j_tm.get_token_maps

    def jax_maps(*a, return_segments=False, **kw):
        masks, labels = j_get(*a, return_segments=True, **kw)
        clusters.append(labels)
        return (masks, labels) if return_segments else masks

    t_get = t_tm.get_token_maps

    def port_maps(*a, **kw):
        return t_get(*a, clusters=clusters[port_maps.calls.pop(0)], **kw)

    port_maps.calls = [0, 1]
    seen_j, seen_t = {}, {}
    monkeypatch.setattr(j_tm, "get_token_maps", jax_maps)
    monkeypatch.setattr(t_tm, "get_token_maps", port_maps)
    monkeypatch.setattr(TP, "draw_latents", _jax_draw)
    _record_figures(monkeypatch, j_viz, seen_j)
    _record_figures(monkeypatch, t_viz, seen_t)

    want = _run(j_app, jp, tmp_path / "jax", knobs)
    tracing.phase_report()
    got = _run(t_app, tp, tmp_path / "port", knobs)
    assert set(tracing.phase_report()) == {"plain_pass", "token_maps",
                                           "figures", "rich_pass"}
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape == (PX, PX, 3) and g.dtype == np.uint8
        d = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert d.mean() < 0.1 and d.max() <= 2, (d.mean(), d.max())
    assert got[1].std() > 0
    np.testing.assert_array_equal(seen_t["clusters"], seen_j["clusters"])
    assert len(seen_t["maps"]) == len(seen_j["maps"]) == 3  # 2 spans + bg
    for g, w in zip(seen_t["maps"], seen_j["maps"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert (tp.ref_cache is not None) == knobs[2]


def test_run_generate_writes_the_figures(pipes, tmp_path):
    _, tp = pipes
    out = _run(t_app, tp, tmp_path, (0.0, 0.3, True))
    seg, tok = out[2], out[3]
    assert seg.ndim == tok.ndim == 3 and seg.dtype == tok.dtype == np.uint8
    assert sorted(os.listdir(tmp_path)) == ["average_seed3_attn0.png",
                                            "segmentation_k4_seed3.png"]


@pytest.mark.parametrize("app", [j_app, t_app], ids=["jax", "port"])
@pytest.mark.parametrize("text", ["", "{not json"])
def test_error_contract(pipes, app, text):
    jp, tp = pipes
    with pytest.raises(_DemoError):
        app.run_generate(jp if app is j_app else tp, PX, text, "", 1, 2,
                         7.5, 0.5, 0.0, 0.0, 0.3, 4, error_cls=_DemoError)


def test_copies_equal_the_jax_package():
    for name in ("editor.html",):
        with open(os.path.join(ROOT, "rich_text_to_image_tpu", "cli", name),
                  "rb") as a, open(os.path.join(
                      ROOT, "rich_text_to_image_tpu_torch", "cli", name),
                      "rb") as b:
            assert a.read() == b.read()
    assert t_ex.EXAMPLES == j_ex.EXAMPLES
    assert t_ex.EXAMPLE_SUITES == j_ex.EXAMPLE_SUITES
    assert t_ex.APP_DEFAULTS == j_ex.APP_DEFAULTS
    for kind in t_ex.APP_DEFAULTS:
        assert t_ex.example_rows(kind) == j_ex.example_rows(kind)
    assert t_share.COMMUNITY_JS == j_share.COMMUNITY_JS
    assert t_share.SHARE_BUTTON_CSS == j_share.SHARE_BUTTON_CSS
    assert t_app.GET_JS_DATA == j_app.GET_JS_DATA


# ---------------------------------------------------------------------------
# a recording gradio stub (gradio is not installed)
# ---------------------------------------------------------------------------

class _Component:
    def __init__(self, kind, *a, **kw):
        self.kind = kind
        self.args = a
        self.kw = kw
        self.clicks = []

    def click(self, fn=None, inputs=None, outputs=None, js=None, **kw):
        self.clicks.append(dict(fn=fn, inputs=inputs, outputs=outputs, js=js))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _make_stub():
    gr = types.ModuleType("gradio")
    gr._created = []

    def _factory(kind):
        def make(*a, **kw):
            c = _Component(kind, *a, **kw)
            gr._created.append(c)
            return c
        return make

    for kind in ("Blocks", "HTML", "Textbox", "Slider", "Button", "Image",
                 "Row", "Examples", "Checkbox"):
        setattr(gr, kind, _factory(kind))

    class Error(Exception):
        pass

    gr.Error = Error
    gr.utils = types.SimpleNamespace()
    return gr


@pytest.fixture()
def stub_gradio(monkeypatch):
    gr = _make_stub()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    return gr


def _of(gr, kind):
    return [c for c in gr._created if c.kind == kind]


def _slider(gr, label):
    return next(c for c in _of(gr, "Slider") if c.kw.get("label") == label)


@pytest.mark.parametrize("kind", ["SD", "SDXL", "AnimeXL"])
def test_build_app_constructs_and_wires(stub_gradio, pipes, kind):
    _, tp = pipes
    demo = t_app.build_app(kind, model=tp, resolution=PX)
    gr = stub_gradio
    d = t_ex.APP_DEFAULTS[kind]
    assert demo.kind == "Blocks"
    for label, key in (("segment threshold", "segment_threshold"),
                       ("inject background", "inject_background"),
                       ("steps", "steps"), ("seed", "seed")):
        assert _slider(gr, label).kw["value"] == d[key]
    ex = _of(gr, "Examples")
    assert len(ex) == len(t_ex.EXAMPLE_SUITES)
    for e in ex:
        assert len(e.kw["inputs"]) == 10 and e.kw["fn"] is not None
        assert e.kw["examples"] == t_ex.example_rows(kind)[e.kw["label"]]
        assert e.kw["cache_examples"] is False  # no checkpoint_dir
    share = next(b for b in _of(gr, "Button")
                 if b.kw.get("elem_id") == "share-btn")
    assert share.clicks[0]["js"] == t_share.COMMUNITY_JS
    gen = next(b for b in _of(gr, "Button") if b.args == ("Generate",))
    assert gen.clicks[0]["js"] == t_app.GET_JS_DATA
    assert len(gen.clicks[0]["inputs"]) == 13
    assert len(gen.clicks[0]["outputs"]) == 4
    html = _of(gr, "HTML")[0].args[0]
    assert "document.body._data" in html


def test_generate_callback_end_to_end(stub_gradio, pipes, tmp_path,
                                     monkeypatch):
    """The click binding's callback, as a button press would call it: four
    outputs, the figures under ``results/gradio_vis`` of the working
    directory, and ``gr.Error`` on an empty input."""
    _, tp = pipes
    monkeypatch.chdir(tmp_path)
    t_app.build_app("SD", model=tp, resolution=PX)
    gen = next(b for b in _of(stub_gradio, "Button")
               if b.args == ("Generate",))
    fn = gen.clicks[0]["fn"]
    out = fn(json.dumps(t_ex.EXAMPLES["footnote-cat"]), "", 1, 2, 8.5, 0.5,
             0.0, 0.0, 0.3, 4)
    assert len(out) == 4
    assert out[0].shape == out[1].shape == (PX, PX, 3)
    assert os.listdir(tmp_path / "results" / "gradio_vis")
    with pytest.raises(stub_gradio.Error):
        fn("", "", 1, 2, 8.5, 0.5, 0.0, 0.0, 0.3, 4)


def test_build_app_needs_gradio_and_refuses_mesh(monkeypatch, pipes,
                                                 world_of_one):
    """gradio is needed. A mesh of more devices than a world of one
    process has raises the ``ValueError`` that names both counts, before a
    model is built; ``auto`` places the pipeline on a (1, 1) mesh (the
    2-rank demo is in ``tests/test_torch_port_mesh_pipeline.py``)."""
    _, tp = pipes
    monkeypatch.setitem(sys.modules, "gradio", None)  # not importable
    with pytest.raises(ImportError, match="gradio"):
        t_app.build_app("SD", model=tp)
    with pytest.raises(ValueError, match="wants 2 devices .* has 1 "):
        t_app.build_app("SD", model=tp, mesh="2")
    with pytest.raises(ValueError, match="wants 2 devices .* has 1 "):
        t_app.main(["--mesh", "2", "--random_weights"])
    monkeypatch.setitem(sys.modules, "gradio", _make_stub())
    try:
        assert t_app.build_app("SD", model=tp, mesh="auto",
                               resolution=PX).kind == "Blocks"
        assert tp.mesh.shape == {"dp": 1, "tp": 1}
    finally:
        tp.mesh = None
    args = t_app.make_parser().parse_args([])
    assert (args.model, args.device, args.mesh) == ("SD", "cuda", None)
