"""Piecewise CUDA graphs of the UNet (``models/unet_graphs.py``).

On the CPU: which calls may take the graphs (a CUDA input, no grad, no
mesh, the bfloat16 compute type, the convolution kernel's gate off, inputs
on the input's device), what keys a plan (the shape, and the resnets the
controls or capture touch, not the capture spec), which modules run between
the graphs (every attention module and the touched resnets, with the
forward's result unchanged), the ``unet_graph`` counter's keys, the
non-owning views and when the plans are dropped.

On the card (``-m cuda``; skipped without one): a graphed forward against
the eager one, call by call (eager first call, capture, replays), at SD-1.5
widths with rows 2 and 3 and at a two-level SDXL, over the capture specs and
controls of both passes and encoder reuse; an output that outlives a call;
the plans dropped after a parameter replacement and kept by an in-place
load; and the benchmark's ``attn1_core`` spans under the graphs.
"""

import dataclasses
import os
import sys
import time
import types

import pytest
import torch

from rich_text_to_image_tpu_torch.models import config as C
from rich_text_to_image_tpu_torch.models import unet as U
from rich_text_to_image_tpu_torch.models import unet_graphs as G
from rich_text_to_image_tpu_torch.ops import conv as conv_ops
from rich_text_to_image_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = U.INJECT_RESNET_NAME


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    return U.UNet2DCondition(C.TINY_UNET).eval().requires_grad_(False)


def _inputs(rows=2, hw=8, ctx=32, seed=1, dev="cpu", dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((rows, hw, hw, 4), generator=g, device=dev, dtype=dtype)
    e = torch.randn((rows, 77, ctx), generator=g, device=dev, dtype=dtype)
    return x, e


def _fake_cuda(x):
    """``x`` as the signature reads a card's tensor."""
    return types.SimpleNamespace(is_cuda=True, device=x.device,
                                 shape=x.shape, stride=x.stride,
                                 dtype=x.dtype)


def _names(unet, cls):
    return [m.layer_name for m in unet.modules() if isinstance(m, cls)]


# ----------------------------------------------------------------- the CPU
def test_touched_layers_and_islands():
    empty, every = U.EMPTY_CAPTURE, G.EVERY_CROSS
    a2 = "up_blocks.1.attentions.0.transformer_blocks.0.attn2"
    assert G.touched_layers(None, empty, RES) == set()
    assert G.touched_layers(U.UNetControls(inject_gate=True), empty,
                            RES) == set()
    for ctl in (U.UNetControls(token_weights=torch.ones(77)),
                U.UNetControls(token_signs=torch.ones(77))):
        assert G.touched_layers(ctl, empty, RES) == {every}
    assert G.touched_layers(None, U.CaptureSpec(cross_full=True),
                            RES) == {every}
    assert G.touched_layers(None, U.CaptureSpec(
        resnet=frozenset({"a"}), cross_probs=frozenset({a2}),
        self_probs=frozenset({"s.attn1"}), qk=True), RES) == {"a", a2}
    assert G.touched_layers(U.UNetControls(inject_resnet={"b": None},
                                           inject_cross={a2: None}),
                            empty, RES) == {"b", a2}
    assert G.touched_layers(U.UNetControls(inject_src=0, inject_dst=(1, 2)),
                            empty, RES) == {RES}
    # every attn1 is an island; attn2 layers and resnets where touched
    assert G.is_island("x.attn1", set())
    assert not G.is_island(a2, set()) and not G.is_island(RES, set())
    assert G.is_island(a2, {a2}) and G.is_island(a2, {every})
    assert G.is_island(RES, {RES}) and not G.is_island(RES, {every})


def test_signature_admits_only_graphable_calls(tiny):
    bf = U.UNet2DCondition(C.TINY_UNET).to(torch.bfloat16)
    x, e = _inputs(dtype=torch.bfloat16)
    fx = _fake_cuda(x)

    def sig(unet=bf, sample=fx, t=7, ehs=e, added=None, enc=None, keep=False,
            touched=()):
        return G.signature(unet, sample, t, ehs, added, enc, keep,
                           set(touched))

    with torch.no_grad():
        base = sig()
        assert base is not None and base[0] == "forward"
        assert sig() == base  # a seen signature is found again
        assert sig(sample=x) is None  # a CPU input
        assert sig(unet=tiny) is None  # float32 compute
        bf._graphs_on = False  # a mesh, or a test's eager reference
        assert sig() is None
        bf._graphs_on = True
        conv_ops.enable_kernel_conv()
        try:
            assert sig() is None
        finally:
            conv_ops.enable_kernel_conv(False)
        assert sig(ehs=e.to("meta")) is None  # an input on another device
        assert sig(t=[7]) is None
        assert sig(t=torch.tensor(7.0)) is None  # only a host scalar
        assert sig(t=1.5) != base  # another dtype of the timestep
        assert sig(keep=True)[0] == "key"
        enc = {"x": x, "skips": (x,), "aux": {}}
        assert sig(enc=enc)[0] == "decode"
        assert sig(touched={RES}) != base
        assert sig(sample=_fake_cuda(torch.cat([x, x[:1]]))) != base
    assert sig() is None  # grad mode on


def test_islands_are_self_attention_and_touched_layers(tiny, monkeypatch):
    """Under a recording every attn1 and the touched attn2 layers and
    resnet hand over to it, in call order, and nothing else does; run
    eagerly there, they give the forward's result."""
    x, e = _inputs()
    attn = _names(tiny, U.Attention)
    cross = frozenset(attn[1::6])
    ctl = U.UNetControls(inject_src=0, inject_dst=(1, 2), inject_gate=True)
    cap = U.CaptureSpec(qk=True, resnet=frozenset({RES}), cross_probs=cross)
    with torch.no_grad():
        want, want_aux = tiny(x, 3, e, ctl, cap)

    class Rec:
        touched = G.touched_layers(ctl, cap, RES)

        def __init__(self):
            self.names = []

        def island(self, module, args, controls, capture, aux):
            self.names.append(module.layer_name)
            monkeypatch.setattr(G, "_REC", None)
            try:
                return type(module).forward(module, *args, controls,
                                            capture, aux)
            finally:
                monkeypatch.setattr(G, "_REC", self)

    rec = Rec()
    monkeypatch.setattr(G, "_REC", rec)
    with torch.no_grad():
        got, got_aux = tiny(x, 3, e, ctl, cap)
    monkeypatch.setattr(G, "_REC", None)
    assert [n for n in rec.names if n != RES] == [
        n for n in attn if n.endswith(".attn1") or n in cross]
    assert rec.names.count(RES) == 1
    assert rec.names[rec.names.index(RES) - 1] == (
        "up_blocks.1.attentions.0.transformer_blocks.0.attn1")
    assert len(rec.names) + 1 == tiny._graph_units(Rec.touched, False)
    assert torch.equal(got, want)
    assert set(got_aux) == set(want_aux) == {"self_qk", "resnet_hidden",
                                             "cross_probs"}
    for k in want_aux:
        assert set(got_aux[k]) == set(want_aux[k])


def test_unet_graph_counter_counts_eager_units(tiny):
    x, e = _inputs()
    attn = _names(tiny, U.Attention)
    n1 = sum(n.endswith(".attn1") for n in attn)
    n_dec1 = sum(n.endswith(".attn1") and not n.startswith("down_blocks")
                 for n in attn)
    tracing.report()
    with torch.no_grad(), tracing.collect():
        tiny(x, 3, e)
        tiny(x, 3, e, capture=U.CaptureSpec(resnet=frozenset({RES})))
        tiny(x, 3, e, U.UNetControls(token_weights=torch.ones(77)))
        cache = {}
        tiny.forward_cached(x, 3, e, None, U.EMPTY_CAPTURE, None, cache,
                            "a", True)
        tiny.forward_cached(x, 2, e, None, U.EMPTY_CAPTURE, None, cache,
                            "a", False)
    rep = tracing.report()
    assert rep["counters"]["unet_graph"] == {"how=eager": (
        (1 + n1) + (2 + n1) + (1 + len(attn)) + (1 + n1) + (1 + n_dec1))}
    with torch.no_grad():
        tiny(x, 3, e)
    assert tracing.report()["counters"] == {}


def test_forward_cached_is_encode_then_decode(tiny):
    x, e = _inputs()
    with torch.no_grad():
        cache = {}
        k_eps, _ = tiny.forward_cached(x, 5, e, None, U.EMPTY_CAPTURE, None,
                                       cache, "n", True)
        d_eps, _ = tiny.forward_cached(x * 0.5, 3, e, None, U.EMPTY_CAPTURE,
                                       None, cache, "n", False)
        emb = tiny.embed_time(5, 2)
        enc = tiny.encode(x, emb, e)
        want_k, _ = tiny.decode(enc, emb, e)
        want_d, _ = tiny.decode(enc, tiny.embed_time(3, 2), e)
    assert torch.equal(k_eps, want_k) and torch.equal(d_eps, want_d)
    assert torch.equal(cache["n"]["x"], enc["x"])


def test_view_aliases_without_owning():
    x = torch.arange(24.0).reshape(4, 6)
    part = x[1:, 2:5]
    v = G._view(G._meta(part))
    assert torch.equal(v, part) and v.stride() == part.stride()
    v.fill_(-1.0)
    assert (x[1:, 2:5] == -1.0).all() and x[0, 0] == 0.0


def test_plans_dropped_when_parameters_are_replaced():
    unet = U.UNet2DCondition(C.TINY_UNET)
    other = torch.nn.Linear(2, 2)
    g = unet._graphs

    def planted():
        g.plans["k"], g.seen = object(), {"k"}

    G._watch(g, unet)
    planted()
    other.weight = torch.nn.Parameter(torch.zeros(2, 2))  # not the UNet's
    assert g.plans and g.seen
    unet.conv_in.weight = torch.nn.Parameter(unet.conv_in.weight.clone())
    assert not g.plans and not g.seen
    planted()
    unet.load_state_dict(unet.state_dict())  # in place: the plans stay
    assert g.plans
    unet.load_state_dict({k: v.clone() for k, v in
                          unet.state_dict().items()}, assign=True)
    assert not g.plans
    planted()
    unet.to(torch.float32)
    assert not g.plans and not g.seen


def test_use_mesh_keeps_the_graphs_off():
    from rich_text_to_image_tpu_torch.pipelines.base import MeshMixin

    pipe = MeshMixin()
    pipe.unet = U.UNet2DCondition(C.TINY_UNET)
    pipe.use_mesh(types.SimpleNamespace(shape={"tp": 1}))
    assert pipe.unet._graphs_on is False
    pipe.use_mesh(None)
    assert pipe.unet._graphs_on is True


# ---------------------------------------------------------------- the card
SDXL_SMALL = dataclasses.replace(C.SDXL_UNET,
                                 transformer_layers_per_block=(0, 1, 2))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_unet(cfg, seed=0):
    torch.manual_seed(seed)
    with torch.device("cuda"):
        unet = U.UNet2DCondition(cfg)
    return unet.to(torch.bfloat16).eval().requires_grad_(False)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _same(got, want, what):
    """To the bit, or within bfloat16's rounding of the output's scale
    (cuBLAS may pick another algorithm under a capture)."""
    fg, fw = list(_flat(got)), list(_flat(want))
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (p, a), (_, b) in zip(fg, fw):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, p)
        if not torch.equal(a, b):
            d = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            assert d <= 2.0 ** -8 * scale, (what, p, d, scale)


class _Case:
    """A UNet on the card and the calls of a pass at one row count."""

    def __init__(self, cfg, rows, hw=64):
        self.unet = _card_unet(cfg)
        self.rows, self.hw, self.cfg = rows, hw, cfg
        self.xl = cfg.addition_embed_type == "text_time"
        self.n = 0
        attn = _names(self.unet, U.Attention)
        self.attn1 = [n for n in attn if n.endswith(".attn1")]
        self.attn2 = [n for n in attn if n.endswith(".attn2")]

    def args(self):
        self.n += 1
        x, e = _inputs(self.rows, self.hw, self.cfg.cross_attention_dim,
                       seed=self.n, dev="cuda")
        added = None
        if self.xl:
            g = torch.Generator(device="cuda").manual_seed(100 + self.n)
            added = {"text_embeds": torch.randn(
                (self.rows, 1280), generator=g, device="cuda"),
                "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]],
                                         device="cuda").expand(self.rows, -1)}
        return x, 999 - 20 * self.n, e, added

    def both(self, controls=None, capture=U.EMPTY_CAPTURE, what=""):
        """The call graphed (counted by the tracer) and eager on the same
        inputs."""
        x, t, e, added = self.args()
        with torch.no_grad():
            with tracing.collect():
                got = self.unet(x, t, e, controls, capture, added_cond=added)
            self.unet._graphs_on = False
            try:
                want = self.unet(x, t, e, controls, capture,
                                 added_cond=added)
            finally:
                self.unet._graphs_on = True
        _same(got, want, what)
        return got

    def thrice(self, controls=None, capture=U.EMPTY_CAPTURE, what=""):
        """Three calls (on a new signature: the eager first call, the
        capture, a replay), each against eager; a plan holds a graph a
        graphable unit."""
        tracing.report()
        outs = [self.both(controls, capture, what) for _ in range(3)]
        hows = tracing.report()["counters"]["unet_graph"]
        units = self.unet._graph_units(
            G.touched_layers(controls, capture, RES), False)
        assert sum(hows.values()) == 3 * units, (what, hows, units)
        assert hows.get("how=replay", 0) >= units, (what, hows)
        return outs


def _specs(case):
    a1, a2 = case.attn1, case.attn2
    return {
        "none": U.EMPTY_CAPTURE,
        "cross": U.CaptureSpec(cross_probs=frozenset(a2[::3])),
        "last": U.CaptureSpec(self_probs=frozenset(a1[-3:]),
                              cross_probs=frozenset(a2[::3])),
        "refer": U.CaptureSpec(qk=True, resnet=frozenset({RES}),
                               cross_probs=frozenset(a2[::3])),
        "full": U.CaptureSpec(cross_full=True),
    }


def _controls(case, ref_aux, full_aux):
    """The rich pass's controls: font-size weights; the refer cache's
    injection with the gate on and off, with and without the weights;
    in-batch injection; a prompt-to-prompt blend at two attn2 layers."""
    r = case.rows
    g = torch.Generator(device="cuda").manual_seed(7)
    tw = 1.0 + torch.rand((r, 77), generator=g, device="cuda")
    ts = torch.ones((r, 77), device="cuda")
    ts[:, 3] = -1.0
    qk = {n: (q[1:2].clone(), k[1:2].clone())
          for n, (q, k) in ref_aux["self_qk"].items()}
    res = {n: f[1:2].clone() for n, f in ref_aux["resnet_hidden"].items()}
    inj = dict(inject_qk=qk, inject_resnet=res, inject_dst=(1, r))
    blend = {n: full_aux["cross_probs_full"][n][0:1].clone()
             for n in case.attn2[1:3]}
    mapper = torch.arange(77, device="cuda").roll(1)
    return {
        "font": U.UNetControls(token_weights=tw, token_signs=ts),
        "refpre-on": U.UNetControls(inject_gate=True, **inj),
        "refpre-off": U.UNetControls(inject_gate=False, **inj),
        "refpre-font": U.UNetControls(token_weights=tw, token_signs=ts,
                                      inject_gate=True, **inj),
        "in-batch": U.UNetControls(token_weights=tw, token_signs=ts,
                                   inject_gate=True, inject_src=0,
                                   inject_dst=(1, r)),
        "p2p": U.UNetControls(inject_cross=blend, cross_mapper=mapper,
                              cross_mix=torch.full((77,), 0.5,
                                                   device="cuda")),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["sd-rows2", "sd-rows3", "sdxl-rows2"])
def test_graphed_forward_matches_eager_on_card(which):
    _card()
    cfg = SDXL_SMALL if which.startswith("sdxl") else C.SD15_UNET
    case = _Case(cfg, 3 if which.endswith("3") else 2)
    auxes = {}
    for name, spec in _specs(case).items():
        auxes[name] = case.thrice(capture=spec,
                                  what=f"{which} capture {name}")[-1][1]
    for name, ctl in _controls(case, auxes["refer"], auxes["full"]).items():
        case.thrice(controls=ctl, what=f"{which} {name}")
    # a plan a touched set: none, the cross capture, it with the refer
    # slot's resnet, every attn2, the resnet, both, the blend's layers
    assert len(case.unet._graphs.plans) == 7


@pytest.mark.cuda
def test_encoder_reuse_and_outputs_that_outlive_a_call_on_card():
    _card()
    case = _Case(C.SD15_UNET, 2)
    unet = case.unet
    graphed, eager, keep = {}, {}, []
    with torch.no_grad():
        for step in range(6):
            key = step % 2 == 0
            x, t, e, _ = case.args()
            got = unet.forward_cached(x, t, e, None, U.EMPTY_CAPTURE, None,
                                      graphed, "n", key)
            unet._graphs_on = False
            want = unet.forward_cached(x, t, e, None, U.EMPTY_CAPTURE, None,
                                       eager, "n", key)
            unet._graphs_on = True
            _same(got, want, f"encoder reuse step {step}")
            _same((graphed["n"]["x"], graphed["n"]["skips"]),
                  (eager["n"]["x"], eager["n"]["skips"]), f"cache {step}")
            keep.append((got[0], got[0].clone()))
        # a plain forward of the same rows between: the cache and every
        # eps returned stay as they were
        x, t, e, _ = case.args()
        for _ in range(3):
            unet(x, t, e)
        cached = [s.clone() for s in graphed["n"]["skips"]]
        unet(x, t, e)
        for a, b in zip(graphed["n"]["skips"], cached):
            assert torch.equal(a, b)
    for eps, copy in keep:
        assert torch.equal(eps, copy)
    kinds = {k[0] for k in unet._graphs.plans}
    assert kinds == {"key", "decode", "forward"}


@pytest.mark.cuda
def test_plans_follow_parameter_replacement_on_card():
    _card()
    case = _Case(C.SD15_UNET, 2)
    unet = case.unet
    case.thrice(what="before")
    assert unet._graphs.plans
    # in place: the plans stay, and replay the new weights
    sd = {k: v * 1.01 for k, v in unet.state_dict().items()}
    unet.load_state_dict(sd)
    assert unet._graphs.plans
    case.both(what="after an in-place load")
    # new storage: the plans go, and are made again
    unet.load_state_dict({k: v.clone() for k, v in sd.items()}, assign=True)
    assert not unet._graphs.plans and not unet._graphs.seen
    case.thrice(what="after a load into new storage")
    unet.to(torch.bfloat16)
    assert not unet._graphs.plans
    case.thrice(what="after .to()")


@pytest.mark.cuda
def test_attn1_core_spans_under_the_graphs_on_card():
    """The benchmark's spans, installed after the capture, open one
    ``attn1_core`` span an attn1 call in a replayed forward, with kernels
    launched inside, as in an eager one."""
    _card()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import trace as T

    case = _Case(C.SD15_UNET, 3)
    unet = case.unet
    x, t, e, _ = case.args()
    with torch.no_grad():
        for _ in range(2):
            unet(x, t, e)
    assert unet._graphs.plans
    reads = {}
    for mode in ("graphed", "eager"):
        unet._graphs_on = mode == "graphed"
        hooks = T.Spans.__new__(T.Spans)
        hooks._undo = []
        hooks._around(unet, unet, "unet_forward")
        for m in unet.modules():
            if getattr(m, "layer_name", "").endswith(".attn1"):
                hooks._around(m.to_v, m.to_out[0], "attn1_core", after=True)

        def run():
            with torch.no_grad():
                unet(x, t, e)

        t0 = time.time_ns()
        _, events = T.profiled(run)
        t1 = time.time_ns()
        hooks.remove()
        reads[mode] = T.read(events, t0, t1)
    unet._graphs_on = True
    assert reads["graphed"]["n_attn_spans"] == len(case.attn1)
    assert reads["eager"]["n_attn_spans"] == len(case.attn1)
    assert reads["graphed"]["attn_core_s"] > 0
