"""The port's CLIP vision tower, image preprocessing and CLIP scorer
against the JAX package's, on bridged parameters (``weights.from_flax``
with the ``clip_vision`` and ``text`` rules, their coverage checked), and
``CLIPScorer.from_pretrained`` on a checkpoint written in the test.

Both sides float32 on the CPU. Tolerance: 1e-4 relative to each output's
scale (two or twelve transformer layers, sums in another order); the
preprocessing's bicubic resize within 1e-5 absolute.
"""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.models import clip_vision as JV
from rich_text_to_image_tpu.models.config import (CLIPTextConfig as JTextCfg,
                                                  CLIPVisionConfig as JVisCfg)
from rich_text_to_image_tpu.utils import clip_score as JS
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models import clip_vision as TV
from rich_text_to_image_tpu_torch.models.clip import CLIPTextModel
from rich_text_to_image_tpu_torch.models.config import (CLIPTextConfig,
                                                        CLIPVisionConfig)
from rich_text_to_image_tpu_torch.models.tokenizer import CLIPTokenizer
from rich_text_to_image_tpu_torch.utils import clip_score as TS
from torch_port_pipes import close
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(image_size=32, patch_size=8, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2, projection_dim=16)
TINY_TXT = dict(vocab_size=1000, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=2, projection_dim=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_vision_tower_matches_jax():
    jm = JV.CLIPVisionModel(JVisCfg(**TINY))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    tm = weights.load_flax(TV.CLIPVisionModel(CLIPVisionConfig(**TINY)),
                           _np(params), "clip_vision")
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for k in ("pooled", "projected"):
        assert got[k].shape == want[k].shape
        close(got[k].numpy(), want[k])


@pytest.mark.parametrize("shape", [(2, 64, 48, 3), (1, 32, 32, 3),
                                   (1, 16, 16, 3)])
def test_preprocess_images_matches_jax(shape):
    imgs = np.random.RandomState(1).randint(0, 255, shape).astype(np.uint8)
    for size in (32, 224):
        want = np.asarray(JV.preprocess_images(imgs, size))
        got = TV.preprocess_images(imgs, size).numpy()
        assert got.shape == want.shape == (shape[0], size, size, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    floats = imgs.astype(np.float32) / 255.0  # <= 2: taken as 0..1
    np.testing.assert_allclose(TV.preprocess_images(floats, 32).numpy(),
                               np.asarray(JV.preprocess_images(floats, 32)),
                               rtol=0, atol=1e-5)


def _scorers():
    tok = CLIPTokenizer.byte_level()
    js = JS.CLIPScorer.random_init(seed=0, text_cfg=JTextCfg(**TINY_TXT),
                                   vision_cfg=JVisCfg(**TINY), tokenizer=tok)
    text = weights.load_flax(CLIPTextModel(CLIPTextConfig(**TINY_TXT)),
                             _np(js.text_params), "text")
    vision = weights.load_flax(TV.CLIPVisionModel(CLIPVisionConfig(**TINY)),
                               _np(js.vision_params), "clip_vision")
    return js, TS.CLIPScorer(text, vision, tok, device="cpu")


def test_clip_score_matches_jax():
    js, ts = _scorers()
    rng = np.random.RandomState(3)
    for img, text in ((rng.randint(0, 255, (48, 48, 3)).astype(np.uint8),
                       "a cat in the style of monet"),
                      (rng.randint(0, 255, (2, 32, 32, 3)).astype(np.uint8),
                       "a dog"),
                      (rng.rand(32, 32, 3).astype(np.float32), "a tree")):
        want = js.get_clip_score(img, text)
        got = ts.get_clip_score(img, text)
        assert abs(got - want) <= 1e-4 * max(abs(want), 1e-2), (got, want)


def _write_safetensors(path, sd):
    """A float16 .safetensors file of ``sd`` (the format: an 8-byte
    little-endian header length, a JSON header, the raw tensors)."""
    header, blobs, off = {}, [], 0
    for name, t in sd.items():
        raw = t.detach().numpy().astype(np.float16).tobytes()
        header[name] = {"dtype": "F16", "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def test_from_pretrained_reads_an_hf_layout_checkpoint(tmp_path):
    """A ViT-B/32 CLIP checkpoint in HF names (both towers, their
    projections, the position-id buffers and logit_scale, as
    clip-vit-base-patch32's model.safetensors holds them), written from
    the port's own modules in float16, and the tokenizer files: the loaded
    scorer scores like the modules it was written from."""
    tok = CLIPTokenizer.byte_level()
    text = weights.random_init(CLIPTextModel(TS.CLIP_VIT_B32_TEXT), 3)
    vision = weights.random_init(TV.CLIPVisionModel(CLIPVisionConfig()), 4)
    for m in (text, vision):  # the float16 file's numbers
        for p in m.parameters():
            p.data = p.data.half().float()
    sd = {**text.state_dict(), **vision.state_dict(),
          "logit_scale": torch.tensor(2.6592),
          "text_model.embeddings.position_ids": torch.arange(77)[None],
          "vision_model.embeddings.position_ids": torch.arange(50)[None]}
    _write_safetensors(tmp_path / "model.safetensors", sd)
    (tmp_path / "vocab.json").write_text(json.dumps(tok.encoder))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    loaded = TS.CLIPScorer.from_pretrained(str(tmp_path), device="cpu")
    ref = TS.CLIPScorer(text, vision, tok, device="cpu")
    img = np.random.RandomState(0).randint(0, 255, (64, 64, 3)).astype(
        np.uint8)
    assert loaded.get_clip_score(img, "a red car") == pytest.approx(
        ref.get_clip_score(img, "a red car"), abs=1e-6)
    for a, b in ((loaded.text_model, text), (loaded.vision_model, vision)):
        for (n, p), (_, q) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
            torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)


def test_random_scorer_has_the_jax_default_sizes():
    s = TS.CLIPScorer.random_init(
        seed=0, device="cpu",
        vision_cfg=CLIPVisionConfig(**dict(TINY, projection_dim=512)))
    assert s.text_model.cfg.projection_dim == 512
    assert s.text_model.cfg.hidden_size == 768
    assert s.image_size == 32
    assert np.isfinite(s.get_clip_score(np.zeros((32, 32, 3), np.uint8),
                                        "a cat"))


@pytest.mark.parametrize("which", ["clip_vision", "text"])
def test_bridge_covers_the_full_scorer(which):
    """At CLIP ViT-B/32's sizes (JAX ``eval_shape``, torch on the meta
    device) every flax leaf of the vision tower, and of the scorer's
    projected text tower, maps to one port parameter of its shape, and
    every parameter to one leaf."""
    from rich_text_to_image_tpu.models.clip import CLIPTextModel as JClip
    from rich_text_to_image_tpu.models.config import CLIP_VIT_B32_VISION

    if which == "clip_vision":
        shapes = jax.eval_shape(lambda: JV.CLIPVisionModel(
            CLIP_VIT_B32_VISION).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 224, 224, 3))))
        ctor = lambda: TV.CLIPVisionModel(CLIPVisionConfig())
    else:
        c = TS.CLIP_VIT_B32_TEXT
        jcfg = JTextCfg(hidden_size=c.hidden_size,
                        intermediate_size=c.intermediate_size,
                        num_hidden_layers=c.num_hidden_layers,
                        num_attention_heads=c.num_attention_heads,
                        projection_dim=c.projection_dim)
        shapes = jax.eval_shape(lambda: JClip(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)))
        ctor = lambda: CLIPTextModel(c)
    with torch.device("meta"):
        module = ctor()
    mapped = weights.map_flax_tree(shapes, which)
    weights.check_coverage(mapped, module)
    assert len(mapped) == len(module.state_dict())
