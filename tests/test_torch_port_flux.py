"""FLUX.1-dev through the port, on the CPU at a tiny size, against the
benchmark's plain reference (``benchmark/reference/flux/``), both in
float32 on the same seeded random weights: 1 double-stream and 2
single-stream blocks of 2 heads of 32 with RoPE axes [8, 12, 12], a
2-layer T5, a 2-level 16-channel VAE.

Tolerances: the port and the reference compute the same equations in
float32 on the CPU, differing in summation order and in the kernels' plain
exp2 versions against an exp softmax: relative 1e-5 on T5 and the VAE. On
the transformer 5e-5: the port takes the sinusoid of 1000 sigma in float32,
the reference in float64, and the phase of its fastest component then
differs by up to 1000 sigma x 2^-24 (1.7e-5 read at sigma 0.61). On the
whole sample the harness's own numbers at 1e-4 (a chain of 12 steps and a
clustering between the passes).

Beside them: the configuration file's published widths, the CLI's
refusals for ``--model FLUX``, the span positions over T5's row, and the
comparison seeing the faults it has to catch: RoPE dropped, the text and
image order swapped in the joint sequence, the VAE's shift factor left
out.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "benchmark" / "tests") not in sys.path:
    sys.path.insert(0, str(ROOT / "benchmark" / "tests"))

from bench_tiny import run_tiny  # noqa: E402
from flux_tiny import CONFIG, LIMITS, tiny_cell, tiny_cfg  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference.flux import check as FC  # noqa: E402
from benchmark.reference.flux import nets as FN  # noqa: E402
from rich_text_to_image_tpu_torch.cli.sample import (  # noqa: E402
    check_args, make_parser)
from rich_text_to_image_tpu_torch.models import flux as PF  # noqa: E402
from rich_text_to_image_tpu_torch.models.t5 import T5ByteTokenizer  # noqa: E402
from rich_text_to_image_tpu_torch.schedulers.flow_match import (  # noqa: E402
    FlowMatchEulerScheduler)
from rich_text_to_image_tpu_torch.utils import richtext  # noqa: E402
from torch_port_threads import one_torch_thread  # noqa: E402,F401

@pytest.fixture(scope="module")
def nets():
    """(config, drawn state, the port's pipeline) at the tiny size."""
    cfg = tiny_cfg()
    fam = harness.family(cfg)
    state = fam.draw_state(cfg, 2 ** 33 + 7, torch.device("cpu"))
    return cfg, state, fam.build_model(cfg, state, torch.device("cpu"))


@pytest.fixture(autouse=True)
def _jax_of_the_tests(monkeypatch):
    # this directory's conftest imports JAX for the JAX package's tests; a
    # run here would refuse itself for it (benchmark/tests holds the run
    # to loading none)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _ref(cfg, state):
    return FC.Reference(cfg, state, "cpu")


def test_t5_matches_the_reference(nets):
    cfg, state, pipe = nets
    ref = _ref(cfg, state)
    tok = T5ByteTokenizer(cfg["pipeline"]["max_sequence_length"])
    text = "A cat wearing sunglasses and a bandana around its neck."
    ids = torch.from_numpy(tok([text]))
    want = FC.t5_ids(ref.tok, text, cfg["pipeline"]["max_sequence_length"])
    assert (ids[0].numpy() == want).all()
    with torch.no_grad():
        got = pipe.text_encoder_2(ids)
    assert _rel(got, ref.t5(ids)) < 1e-5


@pytest.mark.parametrize("rows,capture", [(1, True), (2, False)])
def test_transformer_matches_the_reference(nets, rows, capture):
    cfg, state, pipe = nets
    ref = _ref(cfg, state)
    g = torch.Generator().manual_seed(rows)
    T, gh = 128, 8
    x = torch.randn(1, gh * gh, 64, generator=g)
    ctx = torch.randn(rows, T, 32, generator=g)
    pooled = torch.randn(rows, 32, generator=g)
    cap = PF.JointCapture(T, (gh, gh), "cpu") if capture else None
    pool = FN.Pool(T, gh, gh) if capture else None
    with torch.no_grad():
        got = pipe.transformer(x.expand(rows, -1, -1), 0.61, ctx, pooled,
                               3.5, (gh, gh), cap)
        want = ref.transformer(x.expand(rows, -1, -1), 0.61, ctx, pooled,
                               3.5, (gh, gh), pool)
    assert _rel(got, want) < 5e-5
    if capture:
        assert cap.layers == 1 and cap.self_sum.shape == (16, 16)
        assert _rel(cap.self_sum, pool.self_sum) < 1e-5
        assert _rel(cap.cross_sum, pool.cross) < 1e-5


def test_vae_decodes_with_the_shift_and_no_quant_convs(nets):
    cfg, state, pipe = nets
    assert pipe.vae.quant_conv is None and pipe.vae.post_quant_conv is None
    ref = _ref(cfg, state)
    lat = torch.randn(1, 8, 8, 16, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = pipe._decode_imgs(lat)
    assert got.shape == (1, 16, 16, 3)
    assert _rel(got, ref.images(lat)) < 1e-5


def test_flow_sigmas_and_step():
    plan = FlowMatchEulerScheduler().plan(50, image_seq_len=4096)
    assert plan.mu == pytest.approx(1.15)
    np.testing.assert_array_equal(plan.sigmas, FC.flow_sigmas(50, 4096))
    assert plan.sigmas[0] == 1.0 and plan.sigmas[-1] == 0.0
    assert np.all(np.diff(plan.sigmas) < 0)
    # sigma_1 = e^mu / (e^mu + 1 / (1 - 1/50) - 1)
    e = np.exp(1.15)
    assert plan.sigmas[1] == pytest.approx(e / (e + 1 / 0.98 - 1), rel=1e-6)
    x, v = torch.ones(1, 2, 2, 16), torch.full((1, 2, 2, 16), 2.0)
    nxt, _ = FlowMatchEulerScheduler().step(plan, 3, (), v, x)
    dt = float(plan.sigmas[4] - plan.sigmas[3])
    assert torch.allclose(nxt, 1 + 2 * dt * torch.ones_like(x))


def test_pack_unpack_round_trip():
    lat = torch.randn(2, 8, 12, 16)
    x = PF.pack(lat)
    assert x.shape == (2, 24, 64)
    # diffusers' order: channel, row offset, column offset
    assert x[0, 0, 1] == lat[0, 0, 1, 0] and x[0, 0, 4] == lat[0, 0, 0, 1]
    assert torch.equal(PF.unpack(x, 8, 12), lat)


def test_span_positions_over_t5s_row():
    """Span ids are 1-based over the tokenizer's units; T5 has no start
    token, so id i is position i - 1 of its row (``first_token`` 0), where
    CLIP's is position i."""
    tok = T5ByteTokenizer()
    parsed = richtext.parse_json(json.loads(
        make_parser().parse_args([]).rich_text_json))
    prompts, ids, base = richtext.get_region_diffusion_input(tok._tokenize,
                                                             parsed)
    cat = ids[0]
    row = tok([parsed.base_text_prompt])[0]
    units = tok.units.convert_tokens_to_ids(list("ca") + ["t</w>"])
    assert list(row[cat - 1 + tok.first_token]) == [u + 3 for u in units]
    assert prompts[-1] == parsed.base_text_prompt


def test_whole_sample_matches_the_reference():
    rc, res = run_tiny(tiny_cell())
    assert rc == 0 and res is not None
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(LIMITS)
    assert res["checks"]["inputs_max_abs"]["value"] == 0.0


def _no_rope(monkeypatch):
    monkeypatch.setattr(PF, "apply_rope", lambda x, cos, sin: x)


def _swapped(monkeypatch):
    orig = PF.JointAttention.forward

    def forward(self, x, context, rope, capture=None):
        if context is None:
            return orig(self, x, context, rope, capture)
        # [image ; text], read as [text ; image] by RoPE, the capture and
        # the split
        q, k, v = self._qkv(x, self.to_q, self.to_k, self.to_v, self.norm_q,
                            self.norm_k)
        cq, ck, cv = self._qkv(context, self.add_q_proj, self.add_k_proj,
                               self.add_v_proj, self.norm_added_q,
                               self.norm_added_k)
        q, k, v = (torch.cat([a, b], dim=1)
                   for a, b in ((q, cq), (k, ck), (v, cv)))
        o = self.core(PF.apply_rope(q, *rope), PF.apply_rope(k, *rope), v,
                      capture)
        T = context.shape[1]
        return self.to_out[0](o[:, T:]), self.to_add_out(o[:, :T])
    monkeypatch.setattr(PF.JointAttention, "forward", forward)


def _no_shift(monkeypatch):
    from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL

    monkeypatch.setattr(AutoencoderKL, "unscale",
                        lambda self, z: z / self.cfg.scaling_factor)


@pytest.mark.parametrize("fault,caught_by", [
    (_no_rope, "plain_step_rel"), (_swapped, "plain_step_rel"),
    (_no_shift, "decode_rel")], ids=["rope-dropped", "txt-img-swapped",
                                     "shift-left-out"])
def test_the_comparison_catches(monkeypatch, fault, caught_by):
    fault(monkeypatch)
    rc, res = run_tiny(tiny_cell())
    assert rc == 0 and not res["correct"]
    c = res["checks"][caught_by]
    assert c["value"] > c["limit"], res["checks"]


def test_the_published_widths():
    cfg = json.loads(CONFIG.read_text())
    t, e, v = cfg["transformer"], cfg["text_encoder_2"], cfg["vae"]
    assert (t["num_layers"], t["num_single_layers"]) == (19, 38)
    assert (t["num_attention_heads"], t["attention_head_dim"]) == (24, 128)
    assert t["axes_dims_rope"] == [16, 56, 56] and t["guidance_embeds"]
    assert (t["in_channels"], t["joint_attention_dim"],
            t["pooled_projection_dim"]) == (64, 4096, 768)
    assert (e["d_model"], e["d_ff"], e["d_kv"], e["num_heads"],
            e["num_layers"], e["vocab_size"]) == (4096, 10240, 64, 64, 24,
                                                  32128)
    assert (e["relative_attention_num_buckets"],
            e["relative_attention_max_distance"]) == (32, 128)
    assert (v["latent_channels"], v["scaling_factor"], v["shift_factor"],
            v["use_quant_conv"], v["use_post_quant_conv"]) == (
        16, 0.3611, 0.1159, False, False)
    assert cfg["text_encoder"]["hidden_size"] == 768
    assert cfg["pipeline"]["steps"] == 50
    assert cfg["pipeline"]["max_sequence_length"] == 512
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == [] and "assumed" in cfg
    assert harness.family(cfg).port_configs(cfg)[0].inner_dim == 3072


_COLOR = json.dumps({"ops": [{"insert": "a "}, {"attributes": {
    "color": "#ff0000"}, "insert": "cat"}]})
_SIZE = json.dumps({"ops": [{"insert": "a "}, {"attributes": {
    "size": "60px"}, "insert": "cat"}]})


@pytest.mark.parametrize("extra,what", [
    (["--rich_text_json", _COLOR], "colour spans"),
    (["--rich_text_json", _SIZE], "font-size spans"),
    (["--inject_selfattn", "0.2"], "--inject_selfattn"),
    (["--inject_background", "0.3"], "--inject_background"),
    (["--encoder_reuse", "2"], "--encoder_reuse"),
    (["--negative_prompt", "blurry"], "a negative prompt"),
    (["--mesh", "2"], "--mesh"),
    (["--scheduler", "euler"], "flow_euler"),
])
def test_flux_refuses_what_it_does_not_run(extra, what):
    args = make_parser().parse_args(["--model", "FLUX"] + extra)
    with pytest.raises(SystemExit, match=what.replace("-", r"\-")):
        check_args(args)


def test_flux_defaults_pass():
    args = make_parser().parse_args(["--model", "FLUX",
                                     "--color_guidance_weight", "0.5"])
    check_args(args)
    assert args.guidance_weight == 3.5
    assert make_parser().parse_args([]).guidance_weight == 8.5
    with pytest.raises(SystemExit, match="FLUX"):
        check_args(make_parser().parse_args(["--scheduler", "flow_euler"]))


def test_the_tracers_spans_and_counters_on_a_sample(nets, monkeypatch):
    """``run_sample`` with the tracer on: one ``dit`` span and one
    ``dit_calls`` count a step, 1 row in the plain pass and R + 1 in the
    rich pass, the two block stacks inside each, one ``attn_joint`` span a
    joint attention (``capture`` on the double block from
    ``agg_start_step`` on), one ``text_encode`` a pass; the images are
    those of the tracer off."""
    from rich_text_to_image_tpu_torch.cli.sample import run_sample
    from rich_text_to_image_tpu_torch.utils import tracing

    _, _, pipe = nets
    steps, start = 4, 1
    monkeypatch.setattr(pipe, "agg_start_step", start)
    args = make_parser().parse_args(["--model", "FLUX", "--device", "cpu",
                                     "--num_segments", "3"])
    param = {"text_input": json.loads(args.rich_text_json), "height": 32,
             "width": 32, "guidance_weight": 3.5, "steps": steps,
             "noise_index": 4, "negative_prompt": ""}
    off = run_sample(pipe, args, param, save=False)
    with tracing.collect():
        on = run_sample(pipe, args, param, save=False)
        rep = tracing.report()
    assert np.array_equal(off[0], on[0]) and np.array_equal(off[1], on[1])
    by = {}
    for s in rep["spans"]:
        by.setdefault(s["name"], []).append(s)
    assert len(by["dit"]) == 2 * steps
    assert sorted(s["attrs"]["rows"] for s in by["dit"]) == [1] * steps + [
        2] * steps
    assert {s["attrs"]["pass"] for s in by["dit"]} == {"plain", "rich"}
    assert len(by["dit.double"]) == len(by["dit.single"]) == 2 * steps
    paths = [s["attrs"]["path"] for s in by["attn_joint"]]
    assert len(paths) == 2 * steps * 3
    assert paths.count("capture") == steps - start
    assert len(by["text_encode"]) == 2
    assert rep["counters"]["dit_calls"] == {"rows=1": steps, "rows=2": steps}
    assert rep["counters"]["joint_capture"] == {"layers=1": steps - start}
    # the spans scripts/port_trace_cell.py reads in the cell of this family
    from benchmark import harness

    assert all(by[n] for n in harness.family({"family": "flux"}).PROGRAM_SPANS)


def test_the_cli_runs_flux(monkeypatch, tmp_path):
    """``cli.sample.main`` with ``--model FLUX --random_weights``: the plain
    pass, the token maps and the rich pass through ``run_sample``, the
    images and figures written (the tiny configs in place of the
    published)."""
    from rich_text_to_image_tpu_torch.cli import sample as cli
    from rich_text_to_image_tpu_torch.models import config as C
    from rich_text_to_image_tpu_torch.pipelines.region_flux import RegionFlux

    orig = RegionFlux.random_init.__func__

    def tiny(cls, seed=0, **kw):
        kw.update(flux_cfg=C.TINY_FLUX, vae_cfg=C.TINY_FLUX_VAE,
                  text_cfg=C.TINY_FLUX_CLIP, t5_cfg=C.TINY_T5,
                  dtype=torch.float32)
        return orig(cls, seed, **kw)

    monkeypatch.setattr(RegionFlux, "random_init", classmethod(tiny))
    cli.main(["--model", "FLUX", "--random_weights", "--device", "cpu",
              "--height", "32", "--width", "32", "--sample_steps", "3",
              "--num_segments", "3", "--run_dir", str(tmp_path)])
    names = {p.name for p in tmp_path.iterdir()}
    assert {"seed6_plain.png", "seed6_rich.png"} <= names
    assert any(n.startswith("segmentation") for n in names)
