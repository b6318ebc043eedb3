"""The port's attention on each tp rank's own heads, on CPU ``gloo`` groups:
the counterpart of ``tests/test_pallas_sharded.py``.

Under tp the JAX package lets the head sharding of ``to_q``/``to_k``/``to_v``
flow through its attention kernels (``ops/attention.py``'s
``custom_partitioning`` rules), and keeps every head in the capture kernel,
which averages over them. The port does the same with explicit collectives
(``parallel/mesh.heads_local``, ``models/unet.Attention``). Two groups of
spawned ranks (``tests/torch_port_ranks.py``), each started once for the
module, run the tiny SD pipeline (the JAX package's parameters through the
bridge), float32 on the CPU:

  * 2 ranks, tp = 2: the UNet call with every capture, per-row font-size
    weights and the in-batch injection; a 32^2 forward (the flash path,
    the first level's attn1 captured); the gathers of one forward; the
    rich pass's three flows with the refer cache; prompt-to-prompt under
    LocalBlend and under Replace with an equalizer;
  * 4 ranks: the same forwards and gathers at (dp, tp) = (2, 2), and at
    tp = 4, where TINY's 2 heads do not divide and every head stays whole;
    prompt-to-prompt and three train steps at (2, 2).

Each op's q shape is recorded: the kernels' ops (flash, and the plain
path's ``cross_attention``) see ``heads // tp`` heads, the capture's ops
every head. Against the port's single-rank run within 1e-5 of each output's
scale; the UNet call and the rich flows also against the JAX package's
within 1e-4. The 2 x 2 rich flows are held in
``test_torch_port_mesh_pipeline.py`` and the tp = 2 train step against JAX
in ``test_torch_port_train_step.py``.
"""

import numpy as np
import pytest
import torch

from rich_text_to_image_tpu_torch.models import config as TC
from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
from rich_text_to_image_tpu_torch.parallel import mesh as M
from rich_text_to_image_tpu_torch.pipelines.base import ref_qk_bytes_per_slot
from rich_text_to_image_tpu_torch.training import train_step as TS
from torch_port_pipes import close, jax_forward, jax_rich, tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)
import torch_port_ranks as R

SCALE = 1e-5
HEADS = 2  # every level of TINY_UNET
# name: (world, --mesh, tp, whether attention runs on its own heads)
MESHES = {"tp2": (2, "1,2", 2, True), "2x2": (4, "2,2", 2, True),
          "tp4": (4, "1,4", 4, False)}
LR, TRAIN_ROWS, TRAIN_STEPS = 1e-3, 4, 3


def _train_inputs():
    rng = np.random.default_rng(8)
    draws = [(rng.integers(0, 1000, TRAIN_ROWS).astype(np.int64),
              rng.standard_normal((TRAIN_ROWS, R.H, R.H, 4)).astype(
                  np.float32)) for _ in range(TRAIN_STEPS)]
    return {"draws": draws, "lr": LR,
            "latents": rng.standard_normal((TRAIN_ROWS, R.H, R.H, 4)).astype(
                np.float32),
            "ehs": rng.standard_normal((TRAIN_ROWS, 77, 32)).astype(
                np.float32)}


def _one_rank_train(spec):
    """The port's train steps on one rank, as ``R.train_checks`` runs
    them."""
    draws = list(spec["draws"])
    orig = TS.draw_t_noise
    TS.draw_t_noise = lambda gen, shape, device: tuple(
        torch.from_numpy(a) for a in draws.pop(0))
    try:
        init_fn, step = TS.make_train_step(
            spec["unet_cfg"], learning_rate=LR, dtype=torch.float32,
            device="cpu")
        unet = UNet2DCondition(spec["unet_cfg"])
        unet.load_state_dict(spec["unet"])
        state = init_fn(unet=unet)
        losses, grads = [], None
        for _ in range(TRAIN_STEPS):
            state, loss = step(state, spec["latents"], spec["ehs"], None)
            losses.append(float(loss))
            if grads is None:
                grads = {n: p.grad.numpy().copy()
                         for n, p in state.module.named_parameters()}
    finally:
        TS.draw_t_noise = orig
    return {"losses": losses, "grads": grads}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The groups, started first, and while they run the references: the
    JAX package's UNet call and rich flows, the port's single-rank runs."""
    jp, tp = tiny_pipes(agg_start_step=2)
    rng = np.random.default_rng(6)
    soft = rng.random((2, 1, R.H, R.H)).astype(np.float32) + 0.1
    soft /= soft.sum(axis=0, keepdims=True)
    jp.masks = tp.masks = list(soft)
    tmp = tmp_path_factory.mktemp("heads")
    spec = R.sd_spec(tp, 2, tp.masks)
    spec.update(forward=R.forward_inputs(tp.unet_cfg),
                big=R.big_forward_inputs(tp.unet_cfg),
                lat0=rng.standard_normal((1, R.H, R.H, 4)).astype(np.float32),
                **_train_inputs())
    two = dict(spec, meshes={"tp2": "1,2"}, rich=("tp2",), p2p=("tp2",))
    four = dict(spec, meshes={"2x2": "2,2", "tp4": "1,4"}, p2p=("2x2",),
                train_meshes={"2x2": "2,2"})
    groups = {2: R.start(R.sharded_attention_checks, 2, tmp, two),
              4: R.start(R.sharded_attention_checks, 4, tmp, four)}
    big, _ = R.big_forward(tp, spec["big"])
    refs = {"jax_forward": jax_forward(jp, spec["forward"]),
            "jax_rich": jax_rich(jp, spec["lat0"]),
            "forward": R.unet_forward(tp, spec["forward"]),
            "big": big,
            "rich": R.rich_flows(tp, spec["lat0"]),
            "p2p": R.p2p_runs(R.sd_pipe(spec), spec["lat0"]),
            "train": _one_rank_train(spec)}
    yield spec, refs, lambda world: groups[world].results()
    for g in groups.values():  # end a group no test waited for
        try:
            g.results()
        except Exception:  # its failure is a test's to report
            pass


def _close_tree(got, want, rel=SCALE):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close_tree(got[k], want[k], rel)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w, rel)
    else:
        close(got, want, rel)


def _results(ranks, name):
    world, _, tp, local = MESHES[name]
    return [r[name] for r in ranks(world)], tp, local


@pytest.mark.parametrize("name", list(MESHES))
def test_unet_call_matches_one_rank_and_jax(setup, name):
    _, refs, ranks = setup
    res, tp, local = _results(ranks, name)
    for rank, r in enumerate(res):
        want = R.rank_view(refs["forward"], rank % tp, tp if local else 1)
        _close_tree(r["fwd"], want)
        _close_tree(r["big"], refs["big"])
    eps_j, aux_j = refs["jax_forward"]
    got = res[0]["fwd"]
    close(got["eps"], eps_j, 1e-4)
    for kind in ("self_probs", "cross_probs"):
        assert aux_j[kind].keys() == got["aux"][kind].keys()
        for n in aux_j[kind]:
            close(got["aux"][kind][n], aux_j[kind][n], 1e-4)


@pytest.mark.parametrize("name", list(MESHES))
def test_each_rank_attends_with_its_own_heads(setup, name):
    """The kernels' ops (flash and the plain path's ``cross_attention``)
    receive ``heads // tp`` heads where tp divides the heads, every head
    where it does not (tp = 4); the capture's ops every head, always."""
    _, _, ranks = setup
    res, tp, local = _results(ranks, name)
    want = HEADS // tp if local else HEADS
    for r in res:
        seen = r["fwd_seen"] + r["big_seen"]
        ops = {op for op, _ in seen}
        assert ops == set(R.ATTN_OPS), ops
        for op, shape in seen:
            heads = (HEADS if op in ("flash_attention_avg_probs",
                                     "attention_with_probs") else want)
            assert shape[1] == heads, (op, shape)
        # the 32^2 forward: the first level's two attn1 layers captured
        assert sum(op == "flash_attention_avg_probs"
                   for op, _ in r["big_seen"]) == 2


@pytest.mark.parametrize("name", list(MESHES))
def test_gathers_of_one_forward(setup, name):
    """Two gathers a block on its own heads (its output and ``to_out``'s)
    against four with every layer gathered (q, k, v and ``to_out``'s);
    with the head count not divided (tp = 4) nothing changes."""
    _, _, ranks = setup
    res, _, local = _results(ranks, name)
    for r in res:
        g, before = r["gathers"], r["gathers_all_layers"]
        n_attn = g["attention"]
        assert n_attn == 32  # 16 transformer blocks of TINY_UNET
        assert before["local_attention"] == 0
        assert before["calls"] == before["layers"]
        assert g["local_attention"] == (n_attn if local else 0)
        assert g["calls"] == g["layers"] + g["local_attention"]
        assert before["calls"] - g["calls"] == 2 * g["local_attention"]
        if local:
            assert g["elements"] < before["elements"]
        else:
            assert g == before


def test_rich_flows_at_tp2_match_one_rank_and_jax(setup):
    _, refs, ranks = setup
    res, tp, _ = _results(ranks, "tp2")
    for rank, r in enumerate(res):
        _close_tree(r["rich"], R.rank_view(refs["rich"], rank, tp))
    got, want = res[0]["rich"], refs["jax_rich"]
    for flow in R.FLOWS:
        close(got[flow], want[flow], 1e-4)
    close(got["cache"]["traj"],
          want["traj"].reshape(got["cache"]["traj"].shape), 1e-4)
    close(got["agg"]["self_sum"], want["agg_self_sum"], 1e-4)
    # the refer cache holds this rank's heads: half the channels
    for n, (q, _) in got["cache"]["qk"].items():
        assert q.shape[-1] * tp == refs["rich"]["cache"]["qk"][n][0].shape[-1]


@pytest.mark.parametrize("name", ["tp2", "2x2"])
def test_prompt_to_prompt_matches_one_rank(setup, name):
    """The cross maps gathered to every head where captured, narrowed to
    the rank's heads where injected, and LocalBlend's head mean over the
    whole."""
    _, refs, ranks = setup
    res, _, _ = _results(ranks, name)
    for r in res:
        _close_tree(r["p2p"], refs["p2p"])
    for k in ("blend", "replace"):
        got = res[0]["p2p"][k]
        assert np.abs(got[1] - got[0]).max() > 1e-3


def test_train_step_at_2x2_matches_one_rank(setup):
    """Three steps at (dp, tp) = (2, 2): the losses, and every gradient
    (a tp shard's put back in its place) within 1e-5 of the whole
    gradient's scale."""
    _, refs, ranks = setup
    res = [r["train"]["2x2"] for r in ranks(4)]
    want = refs["train"]
    scale = max(np.abs(g).max() for g in want["grads"].values())
    for rank, r in enumerate(res):
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        # this dp rank's two tp ranks, in tp order
        pair = (res[rank & ~1], res[rank | 1])
        for n, g in want["grads"].items():
            got = r["grads"][n]
            if n.rsplit(".", 1)[0] in r["sharded"]:
                got = np.concatenate([q["grads"][n] for q in pair])
            np.testing.assert_allclose(got, g, rtol=0, atol=SCALE * scale,
                                       err_msg=n)


@pytest.mark.parametrize("cfg,tp,want", [
    (TC.SD15_UNET, 2, {8: True}), (TC.SD15_UNET, 4, {8: True}),
    (TC.SDXL_UNET, 2, {10: True, 20: True}),
    (TC.SDXL_UNET, 4, {10: False, 20: True}),
    (TC.TINY_UNET, 2, {2: True}), (TC.TINY_UNET, 4, {2: False})],
    ids=["sd15-tp2", "sd15-tp4", "sdxl-tp2", "sdxl-tp4", "tiny-tp2",
         "tiny-tp4"])
def test_heads_local_rule_and_cache_bytes(cfg, tp, want):
    """Which blocks run on their own heads, by head count, at full width
    on the meta device; a refer-cache slot's bytes on a rank shrink by the
    (Q, K) of the other ranks' heads of those blocks."""
    from rich_text_to_image_tpu_torch.models.unet import Attention
    from rich_text_to_image_tpu_torch.utils.registries import (
        attn_layer_resolutions)

    with torch.device("meta"):
        unet = UNet2DCondition(cfg)
    hw = (cfg.sample_size, cfg.sample_size)
    rows = attn_layer_resolutions(cfg, hw)
    whole = ref_qk_bytes_per_slot(unet, hw)
    mesh = M.Mesh({"dp": 1, "tp": tp}, {"dp": 0, "tp": 0},
                  {"tp": None, "dp": None, "batch": None})
    M.shard_params(unet, mesh)
    seen, saved = {}, 0
    item = torch.empty((), dtype=unet.dtype).element_size()
    for m in unet.modules():
        if isinstance(m, Attention):
            local = m.tp_local() is not None
            assert seen.setdefault(m.heads, local) == local
            assert m.local_heads() == (m.heads // tp if local else m.heads)
            assert all((getattr(x, "tp_local", None) is not None) == local
                       for x in (m.to_q, m.to_k, m.to_v))
            assert getattr(m.to_out[0], "tp_local", None) is None
            if local and m.layer_name.endswith(".attn1"):
                # the other ranks' heads of the (Q, K) of one token row
                saved += (2 * rows[m.layer_name] ** 2 * m.dim * (tp - 1)
                          // tp * item)
    assert seen == want
    assert ref_qk_bytes_per_slot(unet, hw) == whole - saved


@pytest.mark.parametrize("layout", ["stored", "heads"])
def test_injected_qk_of_every_head_is_narrowed_to_the_ranks(layout):
    """A (Q, K) of every head handed to a block on its own heads, in the
    refer cache's [B, S, C] layout or as [B, H, S, hd], is narrowed to the
    rank's heads: each tp rank attends with its block of what one rank
    attends with. (The port's own captures and caches already hold the
    rank's heads.)"""
    from rich_text_to_image_tpu_torch.models.unet import (Attention,
                                                          UNetControls)

    torch.manual_seed(0)
    attn = Attention(32, 4, layer_name="x.attn1")
    q, k = torch.randn(2, 4, 16, 8), torch.randn(2, 4, 16, 8)
    qi, ki = torch.randn(1, 4, 16, 8), torch.randn(1, 4, 16, 8)
    if layout == "stored":
        qi, ki = (t.transpose(1, 2).reshape(1, 16, 32) for t in (qi, ki))
    controls = UNetControls(inject_gate=True, inject_qk={"x.attn1": (qi, ki)},
                            inject_dst=(1, 2))
    whole = attn._injected_qk(q, k, controls)
    for rank in range(2):
        tpl = (rank, 2, None)
        got = attn._injected_qk(q[:, 2 * rank:2 * rank + 2],
                                k[:, 2 * rank:2 * rank + 2], controls, tpl)
        for g, w in zip(got, whole):
            torch.testing.assert_close(g, w[:, 2 * rank:2 * rank + 2],
                                       rtol=0, atol=0)
