"""The port's host-side modules against the JAX package's: tokenizer,
rich-text front end, PNDM scheduler, bicubic resize, spectral clustering,
k-means, token maps and the PNG writer.

Inputs are made with numpy from a seed and handed to both sides. Float
tolerances are stated where they are used.
"""

import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.cli.examples import EXAMPLES
from rich_text_to_image_tpu.models.tokenizer import CLIPTokenizer as JTok
from rich_text_to_image_tpu.ops.resize import resize_bicubic as j_resize
from rich_text_to_image_tpu.ops.spectral import spectral_cluster as j_spectral
from rich_text_to_image_tpu.schedulers.pndm import PNDMScheduler as JPNDM
from rich_text_to_image_tpu.utils import richtext as j_rt
from rich_text_to_image_tpu.utils import token_maps as j_tm
from rich_text_to_image_tpu_torch.models.tokenizer import CLIPTokenizer as TTok
from rich_text_to_image_tpu_torch.ops.kmeans import kmeans as t_kmeans
from rich_text_to_image_tpu_torch.ops.resize import resize_bicubic as t_resize
from rich_text_to_image_tpu_torch.ops.spectral import spectral_cluster as t_spectral
from rich_text_to_image_tpu_torch.schedulers.pndm import PNDMScheduler as TPNDM
from rich_text_to_image_tpu_torch.utils import richtext as t_rt
from rich_text_to_image_tpu_torch.utils import token_maps as t_tm
from rich_text_to_image_tpu_torch.utils.png import encode_png
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

EXTRA_TEXT = [
    "A close-up 4k dslr photo, 1920x1080 -- it's a 'test' of the re rewrite!",
    "café naïve Œuvre ßtraße 東京タワー αβγ 12345 under_score a.b,c;d",
    "emoji 🙂 and tabs\tand\nnewlines   collapsed",
]


def _texts():
    out = list(EXTRA_TEXT)
    for doc in EXAMPLES.values():
        parsed = j_rt.parse_json(doc)
        tok = JTok.byte_level()._tokenize
        prompts, _, _ = j_rt.get_region_diffusion_input(tok, parsed)
        out += [parsed.base_text_prompt, *prompts]
    return out


def test_tokenizer_ids_match_jax():
    """The stdlib-``re`` rewrite of the CLIP pattern splits every example
    prompt (and some harder text) as the JAX tokenizer's ``regex`` does."""
    j, t = JTok.byte_level(), TTok.byte_level()
    texts = _texts()
    for text in texts:
        assert t._tokenize(text) == j._tokenize(text), text
    np.testing.assert_array_equal(t(texts), j(texts))


def _plain(x):
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.tolist())
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("key", sorted(EXAMPLES))
def test_richtext_matches_jax(key):
    doc = EXAMPLES[key]
    tok = JTok.byte_level()._tokenize
    outs = []
    for rt in (j_rt, t_rt):
        parsed = rt.parse_json(doc)
        region = rt.get_region_diffusion_input(tok, parsed)
        fmt = rt.get_attention_control_input(tok, region[2], parsed)
        fmt, color_ids = rt.get_gradient_guidance_input(
            tok, region[2], parsed, fmt, color_guidance_weight=0.5)
        outs.append(_plain([parsed.base_text_prompt, parsed.use_grad_guidance,
                            region, fmt, color_ids]))
    assert outs[0] == outs[1]


def test_pndm_matches_jax_over_12_steps():
    """Plan arrays equal; latents over 12 steps (13 plan steps) with the
    same model outputs agree to float32 rounding (atol 1e-5)."""
    jp, tp = JPNDM().plan(12), TPNDM().plan(12)
    for f in ("timesteps", "alpha_prod_t", "alpha_prod_t_prev", "ets_coeffs",
              "mo_coeff", "append_ets", "use_cur_sample", "store_cur_sample"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    assert tp.num_steps == jp.num_steps == 13
    rng = np.random.default_rng(0)
    shape = (1, 8, 8, 4)
    lat = rng.standard_normal(shape).astype(np.float32)
    eps = rng.standard_normal((13, *shape)).astype(np.float32)
    js, jst = JPNDM(), JPNDM().init_state(shape)
    ts, tst = TPNDM(), TPNDM().init_state(shape, "cpu")
    jl, tl = jnp.asarray(lat), torch.from_numpy(lat)
    for i in range(13):
        jl, jst = js.step(jp, i, jst, jnp.asarray(eps[i]), jl)
        tl, tst = ts.step(tp, i, tst, torch.from_numpy(eps[i]), tl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("shape,out", [((3, 32, 32), (64, 64)),
                                       ((2, 64, 48), (16, 20)),
                                       ((1, 8, 8), (512, 512))])
def test_resize_matches_jax(antialias, shape, out):
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), out, antialias=antialias))
    got = t_resize(torch.from_numpy(x), out, antialias=antialias).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _block_affinity(rng, sizes):
    n = sum(sizes)
    A = rng.random((n, n)) * 0.05
    start = 0
    for s in sizes:
        A[start:start + s, start:start + s] += 1.0
        start += s
    A += rng.random((n, n)) * 0.01
    A = A / A.sum(-1, keepdims=True) * 32  # step-summed attention rows
    return A.astype(np.float32)


def _rand_index(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return ((a[:, None] == a[None, :]) == (b[:, None] == b[None, :])).mean()


@pytest.mark.parametrize("method", ["eigh", "subspace"])
def test_spectral_labels_match_jax(method):
    """Labels agree with the JAX package's up to a permutation (Rand index
    >= 0.98, as the JAX package holds against sklearn); the random draws
    differ (torch.Generator vs jax.random)."""
    A = _block_affinity(np.random.default_rng(2), [100, 80, 76])
    want = np.asarray(j_spectral(jax.random.PRNGKey(0), jnp.asarray(A), 3,
                                 n_init=10, method=method))
    got = t_spectral(torch.from_numpy(A), 3, n_init=10, method=method,
                     generator=torch.Generator().manual_seed(0)).numpy()
    assert _rand_index(got, want) >= 0.98


def test_kmeans_separates_blobs():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal((50, 2)) * 0.1 + c
                        for c in ([0, 0], [5, 5], [0, 5])]).astype(np.float32)
    labels = t_kmeans(torch.from_numpy(x), 3, n_init=10,
                      generator=torch.Generator().manual_seed(0)).numpy()
    assert _rand_index(labels, np.repeat([0, 1, 2], 50)) == 1.0


def test_token_maps_match_jax_given_clusters():
    """With the JAX package's cluster labels handed over, the port's masks
    equal the JAX masks (atol 1e-6: the same float32 resize matrices)."""
    rng = np.random.default_rng(3)
    res = 16
    self_sum = _block_affinity(rng, [90, 86, 80])
    cross = {4: rng.random((16, 77)).astype(np.float32),
             8: rng.random((64, 77)).astype(np.float32),
             16: rng.random((256, 77)).astype(np.float32)}
    tokens = [np.array([2, 3]), np.array([5])]
    ja = j_tm.AttnAggregates(self_sum=self_sum, self_count=5,
                             cross_sums=cross, cross_layer_count=8)
    want, clusters = j_tm.get_token_maps(ja, tokens, (32, 32), seed=1,
                                         num_segments=3, n_init=5,
                                         return_segments=True)
    ta = t_tm.AttnAggregates(self_sum=torch.from_numpy(self_sum),
                             self_count=5, cross_sums=cross,
                             cross_layer_count=8)
    got = t_tm.get_token_maps(ta, tokens, (32, 32), seed=1, num_segments=3,
                              clusters=clusters)
    assert clusters.shape == (res, res) and len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    # and with its own clustering the masks still partition unity
    own = t_tm.get_token_maps(ta, tokens, (32, 32), seed=1, num_segments=3,
                              n_init=5)
    np.testing.assert_allclose(sum(own), 1.0, atol=1e-4)


def _decode_png(data: bytes) -> np.ndarray:
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunks.setdefault(tag, b"")
        chunks[tag] += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    ch = 3 if ctype == 2 else 1
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + w * ch)
    assert (rows[:, 0] == 0).all() and depth == 8
    return rows[:, 1:].reshape(h, w, ch) if ch == 3 else rows[:, 1:]


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6)])
def test_png_roundtrip(shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(_decode_png(encode_png(img)), img)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))
