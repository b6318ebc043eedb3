"""The port's colour-fixture trainer (``training/color_fixture.py``) against
the JAX script ``scripts/train_color_fixture.py``, float32 on the CPU.

  * ``make_batch`` gives the JAX script's arrays for the same
    ``RandomState`` (the script loaded with ``importlib``), exactly;
  * ``AutoencoderKL.encode_moments`` on the committed VAE against JAX's,
    within 1e-5 of scale;
  * one VAE step (reconstruction plus 1e-4·KL, optax ``adam(2e-3)``) and
    one UNet step (DSM, ``adam(1e-3)``) from the committed fixture, both
    packages on the same batch and draws (JAX's reparameterisation noise,
    ``t`` and noise for the script's keys): losses within 1e-5 relative,
    gradients within 1e-4 of scale, parameters after the step within 2·lr
    plus 1e-4 of scale (the rule of ``test_torch_port_train_step.py``: Adam
    moves a parameter by about lr whatever its gradient's size);
  * a 3 + 3-step run of the trainer at batch 4 writes files that both
    packages' ``load_color_fixture`` read into equal UNets and VAEs (atol
    0), and a meta with the JAX script's keys;
  * ``weights.to_flax`` is the inverse of ``from_flax`` to the bit, and
    gives the flax module's own tree (paths and shapes).
"""

import copy
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rich_text_to_image_tpu.evaluation.fixtures import (
    load_color_fixture as jax_load_fixture)
from rich_text_to_image_tpu.models import config as JC
from rich_text_to_image_tpu.models.unet import UNet2DCondition as JUNet
from rich_text_to_image_tpu.models.vae import AutoencoderKL as JVae
from rich_text_to_image_tpu.schedulers.common import make_alphas_cumprod
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.evaluation import fixtures as TF
from rich_text_to_image_tpu_torch.models import config as C
from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL
from rich_text_to_image_tpu_torch.training import color_fixture as CF
from torch_port_pipes import close
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4


def _script():
    spec = importlib.util.spec_from_file_location(
        "train_color_fixture",
        os.path.join(ROOT, "scripts", "train_color_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pair():
    jp = jax_load_fixture()
    tp = TF.load_color_fixture(device="cpu")
    px = tp.unet_cfg.sample_size * tp.vae_scale_factor
    imgs, names, _ = CF.make_batch(np.random.RandomState(0), B, px)
    return jp, tp, imgs, names


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def test_make_batch_equals_the_jax_script():
    script = _script()
    for n, px in ((3, 16), (5, 24)):
        want = script.make_batch(np.random.RandomState(7), n, px)
        got = CF.make_batch(np.random.RandomState(7), n, px)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])


def test_encode_moments_matches_jax(pair):
    jp, tp, imgs, _ = pair
    mean_j, logvar_j = jp.vae.apply(jp.vae_params, jnp.asarray(imgs),
                                    method=jp.vae.encode_moments)
    with torch.no_grad():
        mean, logvar = tp.vae.encode_moments(torch.from_numpy(imgs))
    assert mean.shape == mean_j.shape == logvar.shape
    close(mean.numpy(), np.asarray(mean_j), 1e-5)
    close(logvar.numpy(), np.asarray(logvar_j), 1e-5)
    # the mean is what encode scales
    with torch.no_grad():
        z = tp.vae.encode(torch.from_numpy(imgs))
    torch.testing.assert_close(z, mean * tp.vae_cfg.scaling_factor,
                               rtol=0, atol=0)


def _adam_step_close(module, which, before, after, grads, lr):
    """The port's module after one step against JAX's tree after it, and
    its gradients against JAX's."""
    want = weights.from_flax(_np_tree(after), which)
    want_g = weights.from_flax(_np_tree(grads), which)
    got = dict(module.named_parameters())
    assert set(got) == set(want)
    scale = max(float(g.abs().max()) for g in want_g.values())
    for n, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=n)
        w = want[n].numpy()
        atol = 2 * lr + 1e-4 * max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=atol,
                                   err_msg=n)
    # the step moved the parameters by about lr
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in got.items())
    assert lr / 2 < moved < 2 * lr, moved


def test_vae_step_matches_jax(pair):
    """scripts/train_color_fixture.py:108-121 with the noise its first key
    draws."""
    jp, tp, imgs, _ = pair
    vae, vp = jp.vae, jp.vae_params
    _, k = jax.random.split(jax.random.PRNGKey(0))
    h = tp.unet_cfg.sample_size
    eps = jax.random.normal(k, (B, h, h, 4))

    def loss_fn(vp):
        mean, logvar = vae.apply(vp, jnp.asarray(imgs),
                                 method=vae.encode_moments)
        z = mean + jnp.exp(0.5 * logvar) * eps
        rec = vae.apply(vp, z, method=vae.decode)
        kl = 0.5 * jnp.mean(mean**2 + jnp.exp(logvar) - 1.0 - logvar)
        return jnp.mean((rec - jnp.asarray(imgs)) ** 2) + 1e-4 * kl

    tx = optax.adam(2e-3)
    loss_j, g = jax.jit(jax.value_and_grad(loss_fn))(vp)
    up, _ = tx.update(g, tx.init(vp), vp)
    after = optax.apply_updates(vp, up)

    m = copy.deepcopy(tp.vae).requires_grad_(True)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    loss = CF.step(CF.adam(m.parameters(), CF.VAE_LR),
                   CF.vae_loss(m, torch.from_numpy(imgs),
                               torch.from_numpy(np.array(eps))))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    _adam_step_close(m, "vae", before, after, g, CF.VAE_LR)


def test_unet_step_matches_jax(pair):
    """scripts/train_color_fixture.py:156-178 with the t and noise its
    second key draws, on the trained VAE's latents of the batch and one
    set of text rows for both."""
    jp, tp, imgs, _ = pair
    unet = jp.unet
    lat = jp.vae.apply(jp.vae_params, jnp.asarray(imgs),
                       method=jp.vae.encode)
    ehs = np.random.default_rng(3).standard_normal(
        (B, 77, 32)).astype(np.float32)
    key, _ = jax.random.split(jax.random.PRNGKey(0))
    _, k = jax.random.split(key)
    rt, rn = jax.random.split(k)
    t = jax.random.randint(rt, (B,), 0, 1000)
    noise = jax.random.normal(rn, lat.shape, dtype=lat.dtype)
    alphas = jnp.asarray(make_alphas_cumprod(), jnp.float32)

    def loss_fn(up):
        a = alphas[t][:, None, None, None]
        x_t = jnp.sqrt(a) * lat + jnp.sqrt(1.0 - a) * noise
        eps, _ = unet.apply(up, x_t, t, jnp.asarray(ehs))
        return jnp.mean((eps - noise) ** 2)

    tx = optax.adam(1e-3)
    loss_j, g = jax.jit(jax.value_and_grad(loss_fn))(jp.unet_params)
    up, _ = tx.update(g, tx.init(jp.unet_params), jp.unet_params)
    after = optax.apply_updates(jp.unet_params, up)

    with torch.no_grad():
        lat_t = tp.vae.encode(torch.from_numpy(imgs))
    close(lat_t.numpy(), np.asarray(lat), 1e-5)
    m = copy.deepcopy(tp.unet).requires_grad_(True)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    alphas_t = torch.from_numpy(np.array(alphas))
    loss = CF.step(CF.adam(m.parameters(), CF.UNET_LR), CF.dsm_loss(
        m, alphas_t, lat_t, torch.from_numpy(ehs),
        torch.from_numpy(np.asarray(t).astype(np.int64)),
        torch.from_numpy(np.array(noise))))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    _adam_step_close(m, "unet", before, after, g, CF.UNET_LR)


def test_trainer_writes_a_fixture_both_packages_load(tmp_path):
    res = CF.train(vae_steps=3, unet_steps=3, batch=B, out_dir=str(tmp_path),
                   device="cpu")
    with open(os.path.join(ROOT, "tests", "fixtures", "color_fixture",
                           "fixture_meta.json")) as f:
        jax_meta = json.load(f)
    meta = TF.fixture_meta(str(tmp_path))
    assert meta == res["meta"]
    assert set(meta) == set(jax_meta)
    assert set(meta["configs"]) == set(jax_meta["configs"])
    assert meta["prompt_bank"] == jax_meta["prompt_bank"]
    assert (meta["vae_steps"], meta["unet_steps"], meta["batch"]) == (3, 3, B)
    assert np.isfinite([res["vae_loss"], res["dsm_loss"]]).all()
    for name in ("unet_params.npz", "vae_params.npz"):
        with np.load(tmp_path / name) as z:
            assert all(z[k].dtype == np.float16 for k in z.files)
    tp = TF.load_color_fixture(str(tmp_path), device="cpu")
    jp = jax_load_fixture(str(tmp_path))
    for mod, params, which in ((tp.unet, jp.unet_params, "unet"),
                               (tp.vae, jp.vae_params, "vae")):
        want = weights.from_flax(_np_tree(params), which, mod)
        got = mod.state_dict()
        assert set(got) == set(want)
        for n, t in want.items():
            torch.testing.assert_close(got[n], t, rtol=0, atol=0, msg=n)
    # the trained modules, rounded to float16 as stored
    for mod, trained in ((tp.unet, res["model"].unet),
                         (tp.vae, res["model"].vae)):
        for n, t in trained.state_dict().items():
            torch.testing.assert_close(mod.state_dict()[n],
                                       t.half().float(), rtol=0, atol=0,
                                       msg=n)


@pytest.mark.parametrize("which,cfg", [
    ("unet", "FIXTURE_UNET"), ("vae", "TINY_VAE"), ("unet", "TINY_XL_UNET"),
])
def test_to_flax_inverts_from_flax(which, cfg):
    ctor = UNet2DCondition if which == "unet" else AutoencoderKL
    m = weights.random_init(ctor(getattr(C, cfg)), 5)
    tree = weights.to_flax(m, which)
    back = weights.from_flax(tree, which, m)
    for n, t in m.state_dict().items():
        torch.testing.assert_close(back[n], t, rtol=0, atol=0, msg=n)
    if cfg == "TINY_XL_UNET":
        return
    # the JAX module's own tree: the same paths, the same shapes
    jcfg = getattr(JC, cfg)
    if which == "unet":
        s = jcfg.sample_size
        shapes = jax.eval_shape(lambda: JUNet(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, s, s, 4)), jnp.int32(0),
            jnp.zeros((1, 77, jcfg.cross_attention_dim))))
    else:
        shapes = jax.eval_shape(lambda: JVae(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    want = {k: tuple(v.shape) for k, v in weights._flatten(shapes).items()}
    got = {k: v.shape for k, v in weights._flatten(tree).items()}
    assert got == want
