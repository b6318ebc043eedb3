"""Pieces both rich-text pipelines share: the encoder-reuse key steps, the
refer-precompute cache's validity guard and memory budget, and the mesh
placement with the one UNet call through which every batched forward goes.

Counterpart of ``rich_text_to_image_tpu/pipelines/base.py`` without its jitted
decode (the port decodes with the pipeline's own VAE). Where the JAX package
constrains each batched UNet input to the dp axis and lets GSPMD place the
rows, :meth:`MeshMixin._unet_call` hands each dp rank its contiguous block of
rows, runs the UNet on them and gathers the outputs back into row order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.unet import (EMPTY_CAPTURE, INJECT_RESNET_NAME, Attention,
                           CaptureSpec, ResnetBlock2D, UNetControls)
from ..utils import tracing

# Bytes the refer-precompute cache may take on one rank: the JAX package's
# budget for the (Q, K)/resnet slots, kept so that both packages take the
# same flow for the same request. It is that package's choice, not a
# measurement of the card's memory.
REF_PRECOMPUTE_MAX_BYTES = 6e9


def encoder_key_gates(num_steps: int, stride: int,
                      schedule: str = "early") -> np.ndarray:
    """Key-step gates of the encoder-reuse turbo (arXiv 2312.09608 §4): on
    a key step the UNet's down path runs, between key steps its cached
    output feeds the decoder. ``uniform`` takes every ``stride``-th step;
    ``early`` (the default) takes as many steps on a power curve that is
    denser at high noise. Step 0 is always a key step."""
    S = int(num_steps)
    stride = max(int(stride), 1)
    gates = np.zeros(S, bool)
    if stride == 1:
        gates[:] = True
        return gates
    n = len(range(0, S, stride))
    if schedule == "uniform":
        gates[::stride] = True
        return gates
    if schedule != "early":
        raise ValueError(f"unknown encoder-reuse schedule: {schedule!r}")
    idx = set(np.floor(S * (np.arange(n) / n) ** 1.5).astype(int).tolist())
    # the curve may put two early steps on one index: fill from the front
    # so that the count stays uniform's
    for i in range(S):
        if len(idx) >= n:
            break
        idx.add(i)
    gates[sorted(idx)] = True
    return gates


@torch.no_grad()
def ref_fingerprint(*tensors) -> tuple:
    """(sum, sum of squares) in float32 of each tensor: what a refer cache
    records of the initial latent and of the uncond and base prompt rows,
    so that a rich pass of another seed or prompt does not take it."""
    out = []
    for t in tensors:
        t32 = torch.as_tensor(t).float()
        out += [t32.sum(), (t32 * t32).sum()]
    return tuple(float(v) for v in torch.stack(out).cpu().numpy())


def ref_cache_matches(cache: dict, want_steps, num_steps: int,
                      guidance_scale: float, latent_hw, fp) -> bool:
    """Whether a refer cache fits this rich run: the injection steps, the
    trajectory's length, the guidance scale, the latent size and the
    fingerprint must all match; on any mismatch the caller runs the
    in-batch flow."""
    if tuple(cache.get("steps", ())) != tuple(want_steps):
        return False
    if cache["traj"].shape[0] != num_steps + 1:
        return False
    if cache.get("g") is None or float(cache["g"]) != float(guidance_scale):
        return False
    if tuple(cache.get("hw", ())) != tuple(latent_hw):
        return False
    old = cache.get("fp")
    if old is None or len(old) != len(fp):
        return False
    return bool(np.allclose(np.asarray(old), np.asarray(fp),
                            rtol=1e-4, atol=1e-6))


def _level_size(n: int, downs: int) -> int:
    for _ in range(downs):
        n = (n + 1) // 2  # a stride-2 3x3 convolution with padding 1
    return n


def _downs(cfg, layer_name: str) -> int:
    """How many times the latent was halved where ``layer_name`` runs."""
    L = len(cfg.block_out_channels)
    part, _, rest = layer_name.partition(".")
    if part == "mid_block":
        return L - 1
    lvl = int(rest.split(".")[0])
    return lvl if part == "down_blocks" else L - 1 - lvl


def ref_qk_bytes_per_slot(unet, latent_hw) -> int:
    """Bytes one refer-cache slot holds on this rank: the cond row's (Q, K)
    of every self-attention layer and the feature of
    :data:`INJECT_RESNET_NAME`, at the UNet's dtype, from the modules'
    widths and the latent size alone (no forward runs; a UNet on the meta
    device will do). Under tp a layer on its rank's heads keeps only those
    (``Attention.local_heads``), so the budget that this count is held to
    is a rank's."""
    h, w = latent_hw
    item = torch.empty((), dtype=unet.dtype).element_size()
    total = 0

    def tokens(name):
        k = _downs(unet.cfg, name)
        return _level_size(h, k) * _level_size(w, k)

    for m in unet.modules():
        if isinstance(m, Attention) and m.layer_name.endswith(".attn1"):
            width = m.local_heads() * (m.dim // m.heads)
            total += 2 * tokens(m.layer_name) * width * item
        elif (isinstance(m, ResnetBlock2D)
              and m.layer_name == INJECT_RESNET_NAME):
            # the GroupNorm's width: a tp shard of conv2 holds fewer rows
            total += tokens(m.layer_name) * m.norm2.num_channels * item
    return total


def _local_rows(t, idx, n: int):
    """``t``'s rows ``idx`` where it holds one row per batch row (``n``),
    else ``t`` as it is (a row broadcast over the batch, a scalar gate)."""
    if torch.is_tensor(t) and t.dim() >= 1 and t.shape[0] == n and n > 1:
        return t[idx]
    return t


def _local_range(d0: int, d1: int, lo: int, hi: int):
    """Rows d0:d1 of the batch as local rows of the block lo:hi, or None
    where they miss it."""
    a, b = max(d0, lo), min(d1, hi)
    return (a - lo, b - lo) if a < b else None


def _local_controls(controls, lo: int, hi: int, n: int, idx):
    """``controls`` for the local rows ``idx`` of a batch of ``n``: the
    block lo:hi, then the in-batch source row where it lies outside it.
    Per-row tensors are sliced, the injected row range is clipped to the
    block, and an injection that misses the block is dropped."""
    if controls is None:
        return None
    c = dataclasses.replace(controls)
    for f in ("token_weights", "token_signs", "inject_gate"):
        setattr(c, f, _local_rows(getattr(c, f), idx, n))
    if c.inject_cross is not None:
        c.inject_cross = {k: _local_rows(v, idx, n)
                          for k, v in c.inject_cross.items()}
    if c.inject_dst is None:
        for f in ("inject_qk", "inject_resnet"):
            d = getattr(c, f)
            if d is not None:
                setattr(c, f, {k: (tuple(_local_rows(t, idx, n) for t in v)
                                   if isinstance(v, tuple)
                                   else _local_rows(v, idx, n))
                               for k, v in d.items()})
        return c
    # rows d0:d1 take one row: another row of the batch (in-batch), or an
    # explicit value broadcast over them
    c.inject_dst = _local_range(*c.inject_dst, lo, hi)
    if c.inject_src is not None:
        # the source row is local, or appended after the block
        c.inject_src = (None if c.inject_dst is None
                        else idx.index(c.inject_src))
    elif c.inject_dst is None:
        c.inject_qk = c.inject_resnet = None
    return c


def _map_aux(fn, aux):
    """``fn`` on every tensor of a capture dict (nested dicts, (Q, K)
    pairs)."""
    if isinstance(aux, dict):
        return {k: _map_aux(fn, v) for k, v in aux.items()}
    if isinstance(aux, tuple):
        return tuple(_map_aux(fn, v) for v in aux)
    return fn(aux)


class MeshMixin:
    """Mesh placement of a pipeline with ``unet``; ``mesh`` None is one
    device."""

    mesh = None

    def use_mesh(self, mesh, tp_axis: str = "tp"):
        """Place the pipeline on ``mesh`` (``parallel/mesh.py``): the UNet's
        weights shard over tp by the package's rule, the attention kernels
        see each tp rank's own heads (``parallel/mesh.heads_local``; the
        capture layers and head counts that tp does not divide see every
        head), and every batched UNet call splits its rows over (dcn,) dp.
        Every rank keeps the whole pipeline otherwise: it draws the same
        latents from the same seed and runs the text encoders, the
        colour-guided steps and the decode whole."""
        from ..parallel.mesh import shard_params

        self.mesh = mesh
        # the graphs stay off: a mesh call runs its rows, collectives and
        # sharded parameters eagerly
        self.unet._graphs_on = mesh is None
        if mesh is not None:
            shard_params(self.unet, mesh, tp_axis)
        return self

    def _unet_call(self, x, t, emb, controls: UNetControls | None = None,
                   capture: CaptureSpec = EMPTY_CAPTURE, added_cond=None,
                   enc_cache=None, name: str = "", key: bool = True):
        """The UNet on rows ``x`` -> (eps, aux); with ``enc_cache``
        (encoder reuse) ``encode`` runs on key steps only, stored under
        ``name``, and ``decode`` always with the current time embedding
        (arXiv 2312.09608 §4). Under a mesh each batch rank runs its block
        of rows (:meth:`~..parallel.mesh.Mesh.rows`) and eps and every
        captured output are gathered back into row order; an in-batch
        injection whose source row lies in another block takes that row as
        one more local row, whose outputs are dropped. The call is the
        span ``unet`` (its rows, the pass and flow of the loop that makes
        it, the encoder-reuse key) and counts in ``unet_calls`` by rows."""

        def fwd(x, emb, controls, added):
            if enc_cache is None:
                return self.unet(x, t, emb, controls, capture,
                                 added_cond=added)
            return self.unet.forward_cached(x, t, emb, controls, capture,
                                            added, enc_cache, name, key)

        n = x.shape[0]
        tracing.count("unet_calls", rows=n)
        with tracing.span("unet", device=True, inherit=("pass", "flow"),
                          rows=n, key=key):
            if self.mesh is None:
                return fwd(x, emb, controls, added_cond)
            from ..parallel.mesh import batch_spec, gather_rows

            counts = self.mesh.row_counts(n)
            lo, hi = self.mesh.rows(n)
            idx = list(range(lo, hi))
            src = None if controls is None else controls.inject_src
            if (src is not None and not lo <= src < hi
                    and _local_range(*controls.inject_dst, lo, hi)):
                idx.append(src)
            local = _local_controls(controls, lo, hi, n, idx)
            keep = hi - lo
            if not idx:
                # fewer rows than ranks: run one row, without controls, and
                # drop it; the gathers still need this rank's (empty) block
                idx, local = [n - 1], None
            rows = torch.as_tensor(idx, device=x.device)
            added = (None if added_cond is None else
                     {k: _local_rows(v, rows, n)
                      for k, v in added_cond.items()})
            eps, aux = fwd(x[rows], _local_rows(emb, rows, n), local, added)
            group = batch_spec(self.mesh)
            gather = lambda a: gather_rows(a[:keep], counts, group)
            return gather(eps), _map_aux(gather, aux)
