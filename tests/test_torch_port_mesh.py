"""The port's ``parallel/mesh.py`` against the JAX package's: the
``--mesh`` grammar and the sharding rule.

  * ``mesh_shape(spec, 8)`` equals the shape of JAX's ``mesh_from_spec``
    on its 8-device CPU mesh for every form of the grammar, and raises
    ``ValueError`` where JAX's does (a size below 1, four parts) and where
    the world has fewer processes than the flag asks for (naming both
    counts);
  * ``param_spec`` shards a parameter of the TINY and of the full SD-1.5
    UNet, in torch's layout, exactly when JAX's ``param_spec`` shards the
    same leaf in flax's (matched through ``weights.map_flax_tree``), at
    tp = 2 and 4, and always on the output dimension;
  * ``shard_params`` keeps each sharded layer's block and leaves the rest;
    ``batch_spec`` is the batch axes' group.
"""

import types

import jax
import jax.numpy as jnp
import pytest
import torch

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models.unet import UNet2DCondition as JUNet
from rich_text_to_image_tpu.parallel import mesh as JM
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
from rich_text_to_image_tpu_torch.parallel import mesh as TM
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

SPECS = ["auto", "8", "2,4", "4x2", "2,2,2", "1,8", "8,1", "4", "2", "1"]


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_shape_matches_jax(spec):
    want = dict(JM.mesh_from_spec(spec).shape)
    got = TM.mesh_shape(spec, 8)
    assert got == want
    assert list(got) == list(want)  # outermost axis first


@pytest.mark.parametrize("spec", ["0", "2,0", "1,2,2,2", "-1"])
def test_mesh_shape_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError):
        JM.mesh_from_spec(spec)
    with pytest.raises(ValueError):
        TM.mesh_shape(spec, 8)


@pytest.mark.parametrize("spec,n", [("2", 2), ("2,4", 8), ("16", 16),
                                    ("2,2,2", 8)])
def test_more_devices_than_the_world_names_both(spec, n):
    with pytest.raises(ValueError, match=f"wants {n} devices .* has 1 "):
        TM.mesh_shape(spec, 1)
    assert TM.mesh_shape(None, 1) is None and TM.mesh_shape("", 4) is None
    assert TM.mesh_shape("auto", 1) == {"dp": 1, "tp": 1}


def _flax_unet_shapes(cfg):
    h = cfg.sample_size
    return jax.eval_shape(lambda: JUNet(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, h, cfg.in_channels)),
        jnp.int32(0), jnp.zeros((1, 77, cfg.cross_attention_dim))))


@pytest.mark.parametrize("cfg", [C.TINY_UNET, C.SD15_UNET],
                         ids=["tiny", "sd15"])
@pytest.mark.parametrize("tp", [2, 4])
def test_param_spec_matches_jax(cfg, tp):
    jmesh = types.SimpleNamespace(shape={"dp": 8 // tp, "tp": tp})
    mapped = weights.map_flax_tree(_flax_unet_shapes(cfg), "unet")
    n_sharded = 0
    for name, (path, leaf) in mapped.items():
        want = JM.param_spec(leaf.shape, jmesh)
        shape = weights.torch_shape(path, leaf.shape)
        got = TM.param_spec(shape, jmesh)
        assert (got is not None) == (want != JM.P()), (name, shape)
        if got is not None:
            assert got == 0 and shape[0] == leaf.shape[-1]
            n_sharded += 1
    assert n_sharded > 10


def test_shard_params_keeps_each_block():
    """``shard_params`` on a rank's view of a (dp, tp) = (1, 2) mesh: the
    weights the rule shards keep rank 1's block of output rows (and of the
    bias), the others stay whole. The gathers need a process group and run
    in ``tests/test_torch_port_mesh_pipeline.py``."""
    torch.manual_seed(0)
    unet = UNet2DCondition(C.TINY_UNET)
    whole = {k: v.clone() for k, v in unet.state_dict().items()}
    mesh = TM.Mesh({"dp": 1, "tp": 2}, {"dp": 0, "tp": 1},
                   {"tp": None, "dp": None, "batch": None})
    TM.shard_params(unet, mesh)
    n = 0
    for name, p in unet.state_dict().items():
        mod = unet.get_submodule(name.rsplit(".", 1)[0])
        if getattr(mod, "tp_shard", None) is not None:
            half = whole[name].shape[0] // 2
            assert torch.equal(p, whole[name][half:])
            n += name.endswith("weight")
        else:
            assert torch.equal(p, whole[name])
    assert n > 10
    assert TM.batch_spec(TM.Mesh({}, {}, {"batch": "the group"})) == (
        "the group")
