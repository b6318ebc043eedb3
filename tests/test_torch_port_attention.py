"""The port's attention ops against the JAX package's.

The port's kernels are CUDA C++ and run only on the card; here, on CPU
tensors, every wrapper runs its plain PyTorch version. These tests hold the
plain versions against the JAX package's Pallas kernels run in interpret
mode (as tests/test_attention.py runs them), both sides in float32 on the
same numpy inputs. Tolerance: atol 1e-5 — the same function in float32,
differing only in summation order and exp2-with-folded-scale versus exp.
The kernel itself is compared with its plain version by ``chip_smoke.py``
and by the ``cuda``-marked test below, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.ops import attention as J
from rich_text_to_image_tpu_torch.ops import attention as T
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _qkv(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d))]


@pytest.mark.parametrize("fullrow", ["classic", "transposed"])
@pytest.mark.parametrize("b,h,s,d", [
    (2, 2, 200, 40),   # SD 64^2 head dim, ragged S
    (1, 3, 130, 80),   # SD 32^2 head dim, ragged S
    (2, 2, 256, 80),
])
def test_flash_plain_matches_jax(fullrow, b, h, s, d):
    q, k, v = _qkv(s + d, b, h, s, s, d)
    want = np.asarray(J.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
        _fullrow=fullrow))
    got = T.flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("b,h,s,d", [(2, 4, 160, 80), (1, 8, 136, 40)])
def test_avg_probs_plain_matches_jax(b, h, s, d):
    q, k, v = _qkv(7 + s, b, h, s, s, d)
    o_j, p_j = J.flash_attention_avg_probs(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    o_t, p_t = T.flash_attention_avg_probs_plain(
        *map(torch.from_numpy, (q, k, v)))
    assert p_t.shape == (b, s, s) and p_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=ATOL)


def _log2_sum_exp(q, k, scale):
    """float64 log2-sum-exp of each row's scaled scores, in log2 units."""
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale / np.log(2)
    m = s.max(axis=-1, keepdims=True)
    return (m + np.log2(np.exp2(s - m).sum(axis=-1, keepdims=True)))[..., 0], s


@pytest.mark.parametrize("b,h,s,d", [(2, 2, 130, 40), (1, 3, 77, 80),
                                     (1, 2, 64, 160)])
def test_lse_plain_is_the_log2_sum_exp_of_the_jax_scores(b, h, s, d):
    """``flash_attention_lse_plain``: its output is the JAX package's
    ``attention_with_probs`` output (atol 1e-5), its lse the float64
    log2-sum-exp of the same scaled scores (atol 1e-5 in log2 units, the
    float32 rounding of scores of size ~10), and 2^(s·scale·log2 e − lse)
    gives back the JAX package's probabilities (atol 1e-6)."""
    q, k, v = _qkv(31 + s + d, b, h, s, s, d)
    o_j, p_j = J.attention_with_probs(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v))
    o_t, lse = T.flash_attention_lse_plain(*map(torch.from_numpy, (q, k, v)))
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    want, s2 = _log2_sum_exp(q, k, d ** -0.5)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.exp2(s2 - lse.numpy()[..., None]),
                               np.asarray(p_j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("b,h,s,d", [
    (2, 2, 200, 40),   # the 64^2 level's head dim, ragged S
    (1, 3, 136, 80),   # the capture layers' head dim, ragged S
    (1, 2, 136, 160),  # the 1280-channel level's head dim
])
def test_capture_pieces_compose_to_the_jax_capture_kernel(b, h, s, d):
    """The capture's two pieces, ``flash_attention_lse_plain`` then
    ``avg_probs_from_lse_plain``, against the JAX package's
    ``flash_attention_avg_probs`` in interpret mode, float32 on the same
    inputs: atol 1e-5 on the output and on the head average (exp2 with the
    folded scale against exp, summation order)."""
    q, k, v = _qkv(17 + s + d, b, h, s, s, d)
    o_j, p_j = J.flash_attention_avg_probs(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    o_t, lse = T.flash_attention_lse_plain(qt, kt, vt)
    p_t = T.avg_probs_from_lse_plain(qt, kt, lse)
    assert p_t.shape == (b, s, s) and p_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=ATOL)


def test_capture_pieces_take_their_plain_versions_on_cpu():
    """On CPU tensors the capture's pieces return their plain versions'
    results, compose to ``flash_attention_avg_probs``, and count no launch;
    a scale other than d^-0.5 reaches both."""
    q, k, v = map(torch.from_numpy, _qkv(8, 2, 3, 70, 90, 40))
    T.reset_launches()
    o, lse = T.flash_attention_lse(q, k, v, 0.3)
    o2, lse2 = T.flash_attention_lse_plain(q, k, v, 0.3)
    torch.testing.assert_close(o, o2)
    torch.testing.assert_close(lse, lse2)
    p = T.avg_probs_from_lse(q, k, lse, 0.3)
    torch.testing.assert_close(p, T.avg_probs_from_lse_plain(q, k, lse, 0.3))
    o3, p3 = T.flash_attention_avg_probs(q, k, v, 0.3)
    torch.testing.assert_close(o, o3)
    torch.testing.assert_close(p, p3, rtol=0, atol=1e-6)
    assert set(T.LAUNCHES.values()) == {0}


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers return their plain versions' results and
    count no launch."""
    q, k, v = map(torch.from_numpy, _qkv(3, 2, 2, 64, 64, 40))
    T.reset_launches()
    torch.testing.assert_close(T.flash_attention(q, k, v),
                               T.flash_attention_plain(q, k, v))
    o, p = T.flash_attention_avg_probs(q, k, v)
    o2, p2 = T.flash_attention_avg_probs_plain(q, k, v)
    torch.testing.assert_close(o, o2)
    torch.testing.assert_close(p, p2)
    assert T.LAUNCHES == {"full": 0, "full_t": 0, "avgp": 0, "stream": 0}


def test_kernel_argument_checks():
    q = torch.zeros((1, 2, 64, 40), dtype=torch.bfloat16)
    T._check("t", q, q, q)  # accepted
    with pytest.raises(TypeError):
        T._check("t", q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        qt = torch.zeros((1, 2, 40, 64), dtype=torch.bfloat16).transpose(2, 3)
        T._check("t", qt, qt, qt)
    with pytest.raises(ValueError):
        q2 = torch.zeros((1, 2, 64, 100), dtype=torch.bfloat16)
        T._check("t", q2, q2, q2)  # not a multiple of 8
    with pytest.raises(ValueError):
        q3 = torch.zeros((1, 2, 64, 168), dtype=torch.bfloat16)
        T._check("t", q3, q3, q3)  # above the widest instantiation


def test_bucket_rule_matches_jax_dispatch():
    # the JAX dispatch: transposed kernel for d == 80 and Skv <= 1024
    assert T._bucket(1024, 1024, 80) == "full_t"
    assert T._bucket(1025, 1025, 80) == "full"
    assert T._bucket(4096, 4096, 40) == "full"
    assert T._bucket(1024, 1024, 40) == "full"


@pytest.mark.parametrize("with_weights", [False, True])
def test_cross_attention_matches_jax(with_weights):
    q, k, v = _qkv(11, 2, 2, 64, 77, 40)
    tw = ts = None
    if with_weights:
        tw, ts = J.make_token_weight_vectors([3, 5, 9], [2.0, -1.5, 0.5])
        tw, ts = np.array(tw), np.array(ts)  # writable copies for torch
        tw_t, ts_t = T.make_token_weight_vectors([3, 5, 9], [2.0, -1.5, 0.5])
        np.testing.assert_array_equal(tw_t, tw)
        np.testing.assert_array_equal(ts_t, ts)
    o_j, p_j = J.cross_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        token_weights=None if tw is None else jnp.asarray(tw),
        token_signs=None if ts is None else jnp.asarray(ts),
        return_probs=True)
    o_t, p_t = T.cross_attention(
        *map(torch.from_numpy, (q, k, v)),
        token_weights=None if tw is None else torch.from_numpy(tw),
        token_signs=None if ts is None else torch.from_numpy(ts),
        return_probs=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=ATOL)


def test_attention_with_probs_matches_jax():
    q, k, v = _qkv(5, 1, 2, 100, 100, 40)
    o_j, p_j = J.attention_with_probs(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v))
    o_t, p_t = T.attention_with_probs(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=ATOL)


def test_make_token_weight_vectors_empty():
    assert T.make_token_weight_vectors(None, None) == (None, None)
    assert T.make_token_weight_vectors([], []) == (None, None)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On the card: each kernel against its plain version at bf16 tolerance
    (2e-2 of max|o| on outputs, 1e-3 of the max on head-averaged probs).
    The scores are peaked, and every real key's is lowered by 10 through
    the first channel, so that unmasked zero-filled keys past the ragged
    end (S=1000) would dominate each row (chip_smoke.py's _qkv)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the same check")
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, h, s, d in [(2, 8, 1000, 40), (2, 8, 1000, 80)]:
        q, k, v = [torch.randn((b, s, h * d), generator=g, device="cuda",
                               dtype=torch.bfloat16).view(b, s, h, d)
                   .transpose(1, 2) for _ in range(3)]
        q.mul_(2.0)
        q[..., 0] = 8.0
        k[..., 0] = -10.0 * d ** 0.5 / 8.0
        o_ref = T.flash_attention_plain(q, k, v).float()
        tol = 2e-2 * o_ref.abs().max()
        assert (T.flash_attention(q, k, v).float() - o_ref).abs().max() <= tol
        o, p = T.flash_attention_avg_probs(q, k, v)
        o2, p2 = T.flash_attention_avg_probs_plain(q, k, v)
        assert (o.float() - o2.float()).abs().max() <= tol
        assert (p - p2).abs().max() <= 1e-3 * p2.abs().max()
