"""The port's pipelines under a device mesh, on CPU ``gloo`` groups.

Two groups of spawned ranks (``tests/torch_port_ranks.py``), each started
once for the module, run the tiny SD pipeline (the JAX package's parameters
through the bridge) and the tiny SDXL one, float32 on the CPU:

  * 2 ranks: the UNet call at dp = 2 and tp = 2 (3 rows: uneven over dp, with
    every capture, per-row font-size weights and the in-batch injection from
    row 1 into row 2, which lie in different blocks); ``text_to_images``,
    ``color_bench_batch`` and ``style_bench_batch`` at dp = 2; the SDXL rich
    pass under Euler at dp = 2; the CLI and the colour bench through their
    own ``--mesh 2,1``; the demo's click on rank 0 with rank 1 in its
    request loop, ended by a ``None`` request;
  * 4 ranks: the UNet call at (dp, tp) = (2, 2) and (dcn, dp, tp) =
    (2, 1, 2), and the rich pass in its three flows (no injection;
    in-batch, R + 4 = 5 rows over dp = 2; refer-precompute, with the plain
    pass's aggregates and cache) at (2, 2).

Against the port's single-rank run within 1e-5 of each output's scale (the
mesh changes the batches of the CPU's matrix products, not the maths; under
tp a rank's captured (Q, K) and refer cache hold its own heads, held
against that block of the single-rank ones);
uint8 images within one step where float32 results that agree to ~1e-6
round across .5. Against the JAX package's single-device run (the UNet
call and the three rich flows) within 1e-4 of scale, as the other parity
tests hold the port.
"""

import numpy as np
import pytest

from rich_text_to_image_tpu_torch.cli import gradio_app as t_app
from torch_port_pipes import close, jax_forward, jax_rich, tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)
import torch_port_ranks as R

SCALE = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The groups, started first, and while they run the references: the
    JAX package's UNet call and rich flows, the port's single-rank ones."""
    jp, tp = tiny_pipes(agg_start_step=2)
    rng = np.random.default_rng(5)
    soft = rng.random((2, 1, R.H, R.H)).astype(np.float32) + 0.1
    soft /= soft.sum(axis=0, keepdims=True)
    jp.masks = tp.masks = list(soft)
    tmp = tmp_path_factory.mktemp("mesh")
    spec = R.sd_spec(tp, 2, tp.masks)
    spec.update(forward=R.forward_inputs(tp.unet_cfg), tmp=str(tmp),
                lat0=rng.standard_normal((1, R.H, R.H, 4)).astype(np.float32),
                xl_lat0=rng.standard_normal(
                    (1, R.XL_H, R.XL_H, 4)).astype(np.float32))
    groups = {2: R.start(R.two_rank_checks, 2, tmp, spec),
              4: R.start(R.four_rank_checks, 4, tmp, spec)}
    refs = {"jax_forward": jax_forward(jp, spec["forward"]),
            "jax_rich": jax_rich(jp, spec["lat0"]),
            "forward": R.unet_forward(tp, spec["forward"]),
            "rich": R.rich_flows(tp, spec["lat0"])}
    yield tp, spec, refs, lambda world: groups[world].results()
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


def _images_close(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("world,mesh", [(2, "dp2"), (2, "tp2"), (4, "2x2"),
                                        (4, "2x1x2")])
def test_unet_call_matches_one_rank_and_jax(setup, world, mesh):
    _, _, refs, ranks = setup
    res = ranks(world)
    tp = 1 if mesh == "dp2" else 2
    for rank, r in enumerate(res):  # every rank holds the gathered whole,
        # but its captured (Q, K) of its own heads
        _close_tree(r[f"fwd_{mesh}"],
                    R.rank_view(refs["forward"], rank % tp, tp))
    eps_j, aux_j = refs["jax_forward"]
    got = res[0][f"fwd_{mesh}"]
    close(got["eps"], eps_j, 1e-4)
    for kind in ("self_probs", "cross_probs"):
        assert aux_j[kind].keys() == got["aux"][kind].keys()
        for n in aux_j[kind]:
            close(got["aux"][kind][n], aux_j[kind][n], 1e-4)


def test_rich_flows_match_one_rank_and_jax(setup):
    _, _, refs, ranks = setup
    got = ranks(4)[0]["rich"]
    _close_tree(got, R.rank_view(refs["rich"], 0, 2))  # tp rank 0's heads
    want = refs["jax_rich"]
    for flow in R.FLOWS:
        close(got[flow], want[flow], 1e-4)
    close(got["cache"]["traj"],
          want["traj"].reshape(got["cache"]["traj"].shape), 1e-4)
    close(got["agg"]["self_sum"], want["agg_self_sum"], 1e-4)


def test_rich_rows_do_not_divide():
    """The in-batch flow's R + 4 = 5 rows over dp = 2: blocks of 3 and 2,
    and the injection's source row (3) joins the second block."""
    from rich_text_to_image_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"dp": 2, "tp": 2}, {"dp": 1, "tp": 0}, {})
    assert mesh.row_counts(5) == [3, 2] and mesh.rows(5) == (3, 5)
    assert Mesh({"dcn": 2, "dp": 1, "tp": 2}, {"dcn": 1, "dp": 0, "tp": 1},
                {}).rows(3) == (2, 3)


def test_batched_paths_match_one_rank(setup):
    tp, spec, _, ranks = setup
    got = ranks(2)[0]["batched"]
    want = R.batched_paths(tp, spec["lat0"])
    for k in ("t2i", "color", "style"):
        _images_close(got[k], want[k])
        assert got[k].std() > 0


def test_sdxl_rich_pass_matches_one_rank(setup):
    _, spec, _, ranks = setup
    got = ranks(2)[0]["xl"]
    _images_close(got, R.xl_rich(R.xl_pipe(), spec["xl_lat0"]))


def test_cli_and_colour_bench_take_mesh(setup, tmp_path):
    """Through their own ``--mesh 2,1``: rank 0 writes what the single-rank
    run writes, rank 1 writes nothing, and the summaries agree."""
    _, spec, _, ranks = setup
    res = ranks(2)
    want = R.run_cli(spec, str(tmp_path / "cli"))
    assert set(res[0]["cli"]) == set(want) and res[1]["cli"] == {}
    assert "seed2_rich.png" in want
    for name in want:
        _images_close(res[0]["cli"][name], want[name])
    summary, files = R.run_bench(spec, str(tmp_path / "bench"))
    (s0, f0), (s1, f1) = res[0]["bench"], res[1]["bench"]
    assert f1 == {} and set(f0) == set(files)
    for name in files:
        if name.endswith(".png"):
            _images_close(f0[name], files[name])
    for s in (s0, s1):  # every rank returns the summary
        for k in ("plain_min", "plain_avg", "ours_min", "ours_avg"):
            assert s[k]["n"] == summary[k]["n"] == 2
            np.testing.assert_allclose(s[k]["mean"], summary[k]["mean"],
                                       rtol=0, atol=0.05)


def test_demo_request_loop(setup, tmp_path):
    """Rank 0's click equals the single-rank request; rank 1 ran it beside
    it and left its loop at the ``None`` request."""
    _, spec, _, ranks = setup
    res = ranks(2)
    assert res[1]["demo_served"] == 1
    want = t_app.run_generate(R.sd_pipe(spec), R.PX, *R.DEMO_REQUEST,
                              vis_dir=str(tmp_path))
    got = res[0]["demo"]
    for g, w in zip(got[:2], want[:2]):
        _images_close(g, w)
    assert got[1].std() > 0
