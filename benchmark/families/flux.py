"""The model family ``flux``: FLUX.1-dev, a transformer over [T5 text ;
image] tokens with a 16-channel VAE, CLIP-L's pooled row and T5-XXL,
driven by ``pipelines/region_flux.RegionFlux``. The seam's interface is
``families/unet.py``'s; the spans name the FLUX.1 modules under the
benchmark's span names, so that every reader reads alike:

  unet_forward   the transformer's forward
  attn1_core     every joint attention's core (after RoPE, up to the
                 output projections): the double and the single blocks'
  text_encode    CLIP-L's and T5's forwards
  vae_decode     the VAE decoder's forward

The reference is ``reference/flux/`` (float32, the drawn bfloat16 weights
upcast where used); the control rounds both operands of every transformer
and T5 matrix product through fp8 e4m3 and allows TF32 in CLIP-L and the
VAE.
"""

from __future__ import annotations

import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import control as _control
from benchmark import flops as F
from benchmark import trace
from benchmark import weights as W
from benchmark.recorder import Recorder
from benchmark.reference import check as C
from benchmark.reference.flux import check as FC
from benchmark.reference.flux import nets as FN
from benchmark.reference.nets import CLIPText

LIMITS = ("text_rel", "pooled_rel", "plain_step_rel", "maps_rel",
          "rich_step_rel", "decode_rel", "inputs_max_abs")
# the program's spans (``utils/tracing``) of one transformer call and of its
# joint attention, which ``scripts/port_trace_cell.py`` reads
PROGRAM_SPANS = ("dit", "attn_joint")
subject_of = C.subject_of


def compare(sub, outs, rec):
    """``reference/check.compare``, and ``pooled_rel``: CLIP-L's pooled rows
    alone (``text`` is [T5 rows, T5 rows, pooled rows, pooled rows]), which
    in ``text_rel`` weigh about 4e-4 of T5's rows and so leave CLIP-L's
    float32 unchecked there."""
    out = C.compare(sub, outs, rec)
    out["pooled_rel"] = C._rel((a, b, b) for a, b in zip(sub["text"][2:],
                                                         outs["text"][2:]))
    return out


def networks(cfg: dict) -> dict:
    """{state-dict name: reference module on the meta device}."""
    with torch.device("meta"):
        return {"transformer": FN.Transformer(cfg["transformer"]),
                "text_encoder": CLIPText(cfg["text_encoder"]),
                "text_encoder_2": FN.T5(cfg["text_encoder_2"]),
                "vae": FN.VAE(cfg["vae"])}


def draw_state(cfg, seed, device, log=None):
    """The weights by ``benchmark/weights.py``'s rule, each network in the
    dtype the configuration serves it in; RMS norms' weights are ones, as
    the rule makes every other norm's, and T5's query matrices are drawn at
    T5's own initial scale, (d_model d_kv)^-1/2: T5 does not divide its
    scores by sqrt(d_kv), and at the rule's scale their spread of
    sqrt(d_kv) makes every softmax nearly one-hot, so that the encoder's
    rows turn on rounding (bfloat16 against float32 differ by 89% of the
    rows at the published widths)."""
    import time

    prec = cfg["precision"]
    out, took = {}, {}
    for name, mod in networks(cfg).items():
        t = time.perf_counter()
        sd = W.draw(mod, W.derive(seed, f"weights:{name}"), device,
                    getattr(torch, prec[name]))
        for mname, m in mod.named_modules():
            if isinstance(m, FN.Norm):
                sd[f"{mname}.weight"].fill_(1.0)
            elif isinstance(m, FN._T5Attn):
                sd[f"{mname}.q.weight"].mul_(cfg[name]["d_kv"] ** -0.5)
        out[name] = sd
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        took[name] = time.perf_counter() - t
    if log is not None:
        log("weights drawn: " + ", ".join(f"{k} {v:.3f} s"
                                          for k, v in took.items()))
    return out


def port_configs(cfg: dict):
    from rich_text_to_image_tpu_torch.models import config as P

    t = cfg["transformer"]
    flux = P.FluxConfig(
        in_channels=t["in_channels"], num_layers=t["num_layers"],
        num_single_layers=t["num_single_layers"],
        attention_head_dim=t["attention_head_dim"],
        num_attention_heads=t["num_attention_heads"],
        joint_attention_dim=t["joint_attention_dim"],
        pooled_projection_dim=t["pooled_projection_dim"],
        guidance_embeds=t["guidance_embeds"],
        axes_dims_rope=tuple(t["axes_dims_rope"]))
    c = cfg["text_encoder"]
    clip = P.CLIPTextConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        max_position_embeddings=c["max_position_embeddings"],
        hidden_act=c["hidden_act"], layer_norm_eps=c["layer_norm_eps"])
    e = cfg["text_encoder_2"]
    t5 = P.T5EncoderConfig(
        vocab_size=e["vocab_size"], d_model=e["d_model"], d_kv=e["d_kv"],
        d_ff=e["d_ff"], num_layers=e["num_layers"], num_heads=e["num_heads"],
        relative_attention_num_buckets=e["relative_attention_num_buckets"],
        relative_attention_max_distance=e["relative_attention_max_distance"],
        layer_norm_epsilon=e["layer_norm_epsilon"],
        max_length=cfg["pipeline"]["max_sequence_length"])
    v = cfg["vae"]
    vae = P.VAEConfig(
        in_channels=v["in_channels"], out_channels=v["out_channels"],
        latent_channels=v["latent_channels"],
        block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"],
        norm_num_groups=v["norm_num_groups"],
        scaling_factor=v["scaling_factor"], shift_factor=v["shift_factor"],
        use_quant_conv=v["use_quant_conv"],
        use_post_quant_conv=v["use_post_quant_conv"])
    return flux, clip, t5, vae


def build_model(cfg, state, device):
    """The program's pipeline: each network built on the meta device and
    given the drawn tensors by ``load_state_dict(assign=True)`` (built on
    the card, the transformer's float32 init would not fit beside the
    state), CLIP-L on the card (its embedding init on the meta device would
    import torch's compiler stack)."""
    from rich_text_to_image_tpu_torch.cli.sample import make_scheduler
    from rich_text_to_image_tpu_torch.models.clip import CLIPTextModel
    from rich_text_to_image_tpu_torch.models.flux import (
        FluxTransformer2DModel)
    from rich_text_to_image_tpu_torch.models.t5 import (T5ByteTokenizer,
                                                        T5EncoderModel)
    from rich_text_to_image_tpu_torch.models.tokenizer import CLIPTokenizer
    from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL
    from rich_text_to_image_tpu_torch.pipelines.region_flux import RegionFlux

    fcfg, ccfg, tcfg, vcfg = port_configs(cfg)

    def on(make, sd, where):
        with torch.device(where):
            mod = make()
        mod.load_state_dict(sd, strict=True, assign=True)
        return mod

    tr = on(lambda: FluxTransformer2DModel(fcfg), state["transformer"],
            "meta")
    clip = on(lambda: CLIPTextModel(ccfg), state["text_encoder"], device)
    t5 = on(lambda: T5EncoderModel(tcfg), state["text_encoder_2"], "meta")
    vae = on(lambda: AutoencoderKL(vcfg), state["vae"], "meta")
    p = cfg["pipeline"]
    return RegionFlux(tr, vae, clip, t5, T5ByteTokenizer(tcfg.max_length),
                      CLIPTokenizer.byte_level(), vcfg,
                      agg_start_step=p["agg_start_step"],
                      scheduler=make_scheduler(p["sampler"]), device=device)


class FluxRecorder(Recorder):
    """``Recorder`` on ``RegionFlux``: the passes, ``encode_prompt`` (T5
    rows, pooled rows), the decodes and the sampler's steps (latent and
    velocity); no colour-guided step."""

    def __init__(self, model):
        self.model = model
        self.active = False
        self.rec = None
        self._pass = None
        self._step = None
        self._text = {}
        self._wrap(model, "produce_attn_maps", self._plain)
        self._wrap(model, "prompt_to_img", self._rich)
        self._wrap(model, "encode_prompt", self._enc)
        self._wrap(model, "_decode_imgs", self._decode)
        self._wrap(model.scheduler, "step", self._sched)


recorder = FluxRecorder


class Spans(trace.Spans):
    """The benchmark's spans on ``RegionFlux`` (the module's docstring)."""

    def __init__(self, model):
        import rich_text_to_image_tpu_torch.utils.token_maps as tm
        from rich_text_to_image_tpu_torch.models.flux import AttentionCore

        self._undo = []
        self._wrap(model, "produce_attn_maps", "plain_pass")
        self._wrap(model, "prompt_to_img", "rich_pass")
        self._wrap(tm, "get_token_maps", "token_maps")
        for t in (model.text_encoder, model.text_encoder_2):
            self._around(t, t, "text_encode")
        self._around(model.transformer, model.transformer, "unet_forward")
        self._around(model.vae.decoder, model.vae.decoder, "vae_decode")
        for m in model.transformer.modules():
            if isinstance(m, AttentionCore):
                self._around(m, m, "attn1_core")


spans = Spans


def _plan(cfg, traffic):
    """(pipeline settings, latent rows and columns, rich rows R + 1)."""
    p = cfg["pipeline"]
    s = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    rows = (None if traffic is None
            else len(FC.sample_inputs(traffic)["region_prompts"]))
    return p, p["height"] // s, p["width"] // s, rows


def _counts(cfg):
    """FLOPs of (the transformer at one row, T5, CLIP-L, the decoder) over
    the reference's modules on the meta device."""
    _, h, w, _ = _plan(cfg, None)
    p, t = cfg["pipeline"], cfg["transformer"]
    nets = networks(cfg)
    T = p["max_sequence_length"]

    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    runs = (
        lambda: nets["transformer"](
            meta(1, (h // 2) * (w // 2), t["in_channels"]), 0.5,
            meta(1, T, t["joint_attention_dim"]),
            meta(1, t["pooled_projection_dim"]),
            float(p["guidance_scale"]), (h // 2, w // 2)),
        lambda: nets["text_encoder_2"](meta(1, T, dtype=torch.long)),
        lambda: nets["text_encoder"](meta(1, 77, dtype=torch.long), 2),
        lambda: nets["vae"].decoder(
            meta(1, cfg["vae"]["latent_channels"], h, w)))
    out = []
    for run in runs:
        with FlopCounterMode(display=False) as c:
            run()
        out.append(float(c.get_total_flops()))
    return out


def attn_calls(cfg, traffic):
    """(count, B, H, S, d, capture) of the sample's joint attention calls:
    the plain pass's row with its double blocks captured from
    ``agg_start_step`` on, the rich pass's R + 1 rows."""
    p, h, w, rows = _plan(cfg, traffic)
    t = cfg["transformer"]
    H, d = t["num_attention_heads"], t["attention_head_dim"]
    S = p["max_sequence_length"] + (h // 2) * (w // 2)
    n2, n1 = t["num_layers"], t["num_single_layers"]
    steps, cap = p["steps"], p["steps"] - p["agg_start_step"]
    calls = {(1, H, S, d, True): cap * n2,
             (1, H, S, d, False): steps * (n1 + n2) - cap * n2,
             (rows, H, S, d, False): steps * (n1 + n2)}
    return [(n, *k) for k, n in sorted(calls.items()) if n]


def work(cfg, traffic):
    p, _, _, rows = _plan(cfg, traffic)
    dit, t5, clip, dec = _counts(cfg)
    fl = p["steps"] * (1 + rows) * dit + (1 + rows) * (t5 + clip) + 2 * dec
    calls = attn_calls(cfg, traffic)
    bound = 0.0
    for n, B, H, S, d, cap in calls:
        by = 4.0 * B * H * S * d * 2 + (B * S * S * 4 if cap else 0)
        bound += n * max(4.0 * B * H * S * S * d / F.PEAK_FLOPS,
                         by / F.PEAK_BYTES)
    return fl, bound, calls


def checked(rec, traffic, limits, seed):
    """The steps of both passes the comparison checks, drawn from the
    run's seed."""
    S = len(rec["plain"]["lat"]) - 1
    return C.check_steps(traffic, S, W.derive(seed, "steps"),
                         limits["steps_checked"])


def reference(cfg, state, device):
    return FC.Reference(cfg, state, device)


def control(cfg, state, device):
    return FC.Reference(cfg, state, device, round_fn=_control.fp8, tf32=True)


def evaluate(ref, rec, traffic, seed, which):
    return FC.evaluate(ref, rec, traffic, seed, which)
