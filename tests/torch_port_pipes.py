"""The JAX package's tiny SD pipeline and the port's on the same parameters
(float32, CPU), shared by the ``test_torch_port_*`` files that hold whole
passes against each other."""

import jax
import jax.numpy as jnp
import numpy as np

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.pipelines import region_sd as JP
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models.clip import CLIPTextModel
from rich_text_to_image_tpu_torch.models.tokenizer import CLIPTokenizer
from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL
from rich_text_to_image_tpu_torch.pipelines import region_sd as TP


def port_of(jp, **kw):
    """The port's RegionDiffusion on the JAX pipeline ``jp``'s parameters."""
    tree = lambda p: jax.tree.map(np.asarray, p)
    return TP.RegionDiffusion(
        weights.load_flax(UNet2DCondition(jp.unet_cfg),
                          tree(jp.unet_params), "unet"),
        weights.load_flax(AutoencoderKL(jp.vae_cfg),
                          tree(jp.vae_params), "vae"),
        weights.load_flax(CLIPTextModel(jp.text_encoder.cfg),
                          tree(jp.text_params), "text"),
        CLIPTokenizer.byte_level(), jp.unet_cfg, jp.vae_cfg, device="cpu",
        **kw)


def tiny_pipes(agg_start_step: int = 3):
    """(JAX pipeline, port pipeline) at TINY_UNET / TINY_VAE / TINY_TEXT."""
    jp = JP.RegionDiffusion.random_init(
        seed=0, unet_cfg=C.TINY_UNET, vae_cfg=C.TINY_VAE,
        text_cfg=C.TINY_TEXT, dtype=jnp.float32,
        agg_start_step=agg_start_step)
    return jp, port_of(jp, agg_start_step=agg_start_step)


def close(got, want, rel=1e-4):
    """|got - want| <= rel * max|want| everywhere."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def jax_forward(jp, inp):
    """The JAX package's UNet call of ``torch_port_ranks.forward_inputs``
    (its controls, the self and cross head means captured): (eps, aux)."""
    import torch_port_ranks as R
    from rich_text_to_image_tpu.models import unet as J

    cap = R.forward_capture(jp.unet_cfg)

    def fwd(params, x, ctx, tw, ts):
        return jp.unet.apply(
            params, x, jnp.int32(inp["t"]), ctx,
            controls=J.UNetControls(token_weights=tw, token_signs=ts,
                                    inject_gate=True, inject_src=1,
                                    inject_dst=(2, 3)),
            capture=J.CaptureSpec(self_probs=cap.self_probs,
                                  cross_probs=cap.cross_probs))

    eps, aux = jax.jit(fwd)(jp.unet_params, *(jnp.asarray(inp[k]) for k in
                                                ("x", "ctx", "tw", "ts")))
    return np.asarray(eps), jax.tree.map(np.asarray, aux)


def jax_rich(jp, lat0):
    """The JAX package's rich pass in the three flows of
    ``torch_port_ranks.rich_flows``, with the plain pass's self sum and
    refer trajectory."""
    import torch_port_ranks as R

    out = {}
    lat0 = jnp.asarray(lat0)
    for flow, (selfattn, background) in R.FLOWS.items():
        cache = None
        if flow == "refpre":
            plan = jp.scheduler.plan(R.STEPS)
            _, agg = jp.produce_attn_maps(
                [R.PROMPTS[-1]], [""], height=R.PX, width=R.PX,
                num_inference_steps=R.STEPS, guidance_scale=R.G,
                latents=lat0, ref_capture_steps=tuple(
                    int(s) for s in np.nonzero(plan.timesteps.astype(
                        np.float64) > (1 - selfattn) * 1000)[0]))
            cache = jp.ref_cache
            out["agg_self_sum"] = np.asarray(agg.self_sum)
            out["traj"] = np.asarray(cache["traj"])
        spec = JP.RichControlSpec(guidance_scale=R.G,
                                  inject_selfattn=selfattn,
                                  inject_background=background)
        out[flow] = np.asarray(jp.produce_latents(
            jp.get_text_embeds(R.PROMPTS, [""]), height=R.PX, width=R.PX,
            num_inference_steps=R.STEPS, latents=lat0, spec=spec,
            **({"ref_cache": cache} if cache is not None else {})))
    return out
