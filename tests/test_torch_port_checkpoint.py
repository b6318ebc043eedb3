"""The port's checkpoints (``models/checkpoint.py``) against the JAX
package's, after ``tests/test_checkpoint_and_rng.py::
test_checkpoint_roundtrip``.

Save then load must give back every tensor exactly, in its dtype, and the
result must load strictly into the modules. Against the JAX package: its
``save_pipeline`` (orbax) and ``load_params`` of the tiny pipeline, mapped
by ``weights.from_flax``, equal the port's ``load_params`` of the port's
``save_pipeline`` of the same pipeline exactly (both float32; the bridge
only transposes). The safetensors writer is also held against the format
as the reader and the ``safetensors`` package read it.
"""

import copy
import json
import os
import struct
import types

import jax
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models import checkpoint as TK
from torch_port_pipes import tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipes()


def _modules(tp):
    return {"unet": tp.unet, "vae": tp.vae, "text": tp.text_encoder}


def test_save_load_round_trips_exactly(pipes, tmp_path):
    """Every tensor back exactly and in its dtype: the UNet as the card
    holds it, in bfloat16, the VAE and the text tower in float32."""
    _, tp = pipes
    pipe = types.SimpleNamespace(unet=copy.deepcopy(tp.unet).to(
        torch.bfloat16), vae=tp.vae, text_encoder=tp.text_encoder)
    nbytes = TK.save_pipeline(str(tmp_path / "ckpt"), pipe)
    got = TK.load_params(str(tmp_path / "ckpt"), device="cpu")
    assert set(got) == {"unet", "vae", "text"}
    files = os.listdir(tmp_path / "ckpt" / "params")
    assert sorted(files) == ["text.safetensors", "unet.safetensors",
                             "vae.safetensors"]
    assert nbytes == sum(os.path.getsize(tmp_path / "ckpt" / "params" / f)
                         for f in files)
    for tree, mod in _modules(pipe).items():
        want = mod.state_dict()
        assert list(got[tree]) == list(want)
        for k, v in want.items():
            assert got[tree][k].dtype == v.dtype, (tree, k)
            assert torch.equal(got[tree][k], v), (tree, k)
        mod.load_state_dict(got[tree], strict=True)


def test_load_params_equals_jax_checkpoint_through_the_bridge(pipes,
                                                              tmp_path):
    """The JAX package's orbax checkpoint of the tiny pipeline, restored and
    bridged, is the port's checkpoint of the same pipeline."""
    pytest.importorskip("orbax.checkpoint")
    from rich_text_to_image_tpu.models import checkpoint as JK

    jp, tp = pipes
    JK.save_pipeline(str(tmp_path / "jax"), jp)
    restored = JK.load_params(str(tmp_path / "jax"))
    assert set(restored) == {"unet", "vae", "text"}
    TK.save_pipeline(str(tmp_path / "port"), tp)
    got = TK.load_params(str(tmp_path / "port"), device="cpu")
    for tree in ("unet", "vae", "text"):
        want = weights.from_flax(jax.tree.map(np.asarray, restored[tree]),
                                 tree)
        assert set(got[tree]) == set(want)
        for k, v in want.items():
            assert torch.equal(got[tree][k], v), (tree, k)


def test_load_params_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TK.load_params(str(tmp_path), device="cpu")


def test_safetensors_writer_keeps_dtypes_and_the_format(tmp_path):
    tensors = {
        "f32": torch.randn(3, 5),
        "bf16": torch.randn(4, 2).to(torch.bfloat16),
        "f16": torch.randn(7).to(torch.float16),
        "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
        "strided": torch.randn(4, 6)[:, ::2],
    }
    path = str(tmp_path / "t.safetensors")
    n = weights.save_safetensors(path, tensors)
    assert n == os.path.getsize(path)
    with open(path, "rb") as f:
        (hn,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hn))
    assert (8 + hn) % 8 == 0
    assert header["bf16"]["dtype"] == "BF16"
    assert header["scalar"]["shape"] == []
    back = weights.read_safetensors(path)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    # the float32 directory reader of from_pretrained reads it too
    flat = weights.load_safetensors_dir(str(tmp_path))
    assert torch.equal(flat["bf16"], tensors["bf16"].float())
    st = pytest.importorskip("safetensors.torch")
    ref = st.load_file(path)
    for k, v in tensors.items():
        assert ref[k].dtype == v.dtype and torch.equal(ref[k], v), k
