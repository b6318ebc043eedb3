"""Token maps of the plain reference: which attention layers the plain pass
captures, and the segmentation of their maps into one soft mask per span
(the reference implementation's ``utils/attention_utils.py``): spectral
clustering of the self-attention affinity with k-means++ restarts, each
cluster given to the spans whose min-max-normalised cross-attention it
holds above the threshold, a bicubic resize to the latent, and masks
normalised to sum to one. The clustering runs on the affinity's device
with a generator seeded by the sample's seed, the rest on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SEG_ROWS = 32  # the reference implementation's segmentation grid

SD_SELF = (
    [f"down_blocks.{b}.attentions.{a}.transformer_blocks.0.attn1"
     for b in range(3) for a in range(2)]
    + ["mid_block.attentions.0.transformer_blocks.0.attn1"]
    + [f"up_blocks.{b}.attentions.{a}.transformer_blocks.0.attn1"
       for b in range(1, 4) for a in range(3)])
SD_CROSS = [
    "down_blocks.1.attentions.0.transformer_blocks.0.attn2",
    "down_blocks.2.attentions.0.transformer_blocks.0.attn2",
    "down_blocks.2.attentions.1.transformer_blocks.0.attn2",
    "mid_block.attentions.0.transformer_blocks.0.attn2",
    "up_blocks.1.attentions.0.transformer_blocks.0.attn2",
    "up_blocks.1.attentions.1.transformer_blocks.0.attn2",
    "up_blocks.1.attentions.2.transformer_blocks.0.attn2",
    "up_blocks.2.attentions.1.transformer_blocks.0.attn2",
]
XL_CROSS = (
    [f"down_blocks.2.attentions.1.transformer_blocks.{i}.attn2"
     for i in (3, 4)]
    + [f"mid_block.attentions.0.transformer_blocks.{i}.attn2"
       for i in range(4)]
    + [f"up_blocks.0.attentions.0.transformer_blocks.{i}.attn2"
       for i in range(1, 8)]
    + ["up_blocks.1.attentions.0.transformer_blocks.0.attn2"])


def layer_rows(cfg: dict, latent_rows: int) -> dict:
    """{attn1/attn2 layer name: rows of its level} for a UNet config."""
    from .nets import unet_levels

    L = len(cfg["block_out_channels"])
    _, depth = unet_levels(cfg)
    out = {}

    def add(prefix, n, d, r):
        for a in range(n):
            for t in range(d):
                for w in ("attn1", "attn2"):
                    out[f"{prefix}.attentions.{a}.transformer_blocks.{t}.{w}"] = r

    for lvl, kind in enumerate(cfg["down_block_types"]):
        if kind == "CrossAttnDownBlock2D":
            add(f"down_blocks.{lvl}", cfg["layers_per_block"], depth[lvl],
                latent_rows >> lvl)
    add("mid_block", 1, depth[-1], latent_rows >> (L - 1))
    for lvl, kind in enumerate(cfg["up_block_types"]):
        if kind == "CrossAttnUpBlock2D":
            add(f"up_blocks.{lvl}", cfg["layers_per_block"] + 1,
                depth[L - 1 - lvl], latent_rows >> (L - 1 - lvl))
    return out


def capture_layout(cfg: dict, latent_rows: int, xl: bool):
    """(self layers at the segmentation level, {rows: cross layers}). SD
    captures its registry's attn1 layers at 32 rows at the last step; SDXL
    every attn1 layer there, summed over the steps like the cross maps."""
    rows = layer_rows(cfg, latent_rows)
    want = min(SEG_ROWS, latent_rows // 2)
    names = ([n for n in rows if n.endswith(".attn1")] if xl
             else [n for n in SD_SELF if n in rows])
    # the reference's 32 rows, or the next finer level where there is none
    seg = next((r for r in sorted({rows[n] for n in names}) if r >= want),
               want)
    self_layers = sorted(n for n in names if rows[n] == seg)
    cross = XL_CROSS if xl else SD_CROSS
    by_rows: dict = {}
    for n in cross:
        if n in rows:
            by_rows.setdefault(rows[n], []).append(n)
    return self_layers, by_rows


# ---------------------------------------------------------- segmentation
def kmeans(x, k, n_init=100, iters=50, gen=None):
    """Best of ``n_init`` k-means++ restarts, run as one batch."""
    x = x.float()
    n = x.shape[0]
    first = torch.randint(0, n, (n_init,), generator=gen, device=x.device)
    centers = torch.zeros((n_init, k, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    centers[:, 0] = x[first]
    d2 = ((x[None] - x[first][:, None]) ** 2).sum(-1)
    for i in range(1, k):
        probs = d2 / d2.sum(1, keepdim=True).clamp_min(1e-12)
        idx = torch.multinomial(probs, 1, generator=gen).squeeze(1)
        c = x[idx]
        centers[:, i] = c
        d2 = torch.minimum(d2, ((x[None] - c[:, None]) ** 2).sum(-1))

    def sq(cn):
        return ((x * x).sum(1)[None, :, None]
                - 2 * torch.einsum("nd,ikd->ink", x, cn)
                + (cn * cn).sum(2)[:, None, :])

    for _ in range(iters):
        onehot = torch.nn.functional.one_hot(sq(centers).argmin(2), k).to(
            x.dtype)
        counts = onehot.sum(1)
        sums = torch.einsum("ink,nd->ikd", onehot, x)
        centers = torch.where(counts[..., None] > 0,
                              sums / counts.clamp_min(1)[..., None], centers)
    d2 = sq(centers)
    return d2.argmin(2)[d2.min(2).values.sum(1).argmin()]


def spectral(affinity, k, seed):
    """Cluster labels of a nonnegative affinity (sklearn's precomputed
    spectral clustering: normalised, top-k eigenvectors, D^-1/2 rescaled,
    then k-means)."""
    gen = torch.Generator(device=affinity.device).manual_seed(seed)
    W = affinity.float()
    W = 0.5 * (W + W.T)
    inv = torch.rsqrt(W.sum(1).clamp_min(1e-12))
    M = W * inv[:, None] * inv[None, :]
    vecs = torch.linalg.eigh(M)[1][:, -k:]
    return kmeans(vecs * inv[:, None], k, gen=gen)


def _cubic(x, a):
    x = np.abs(x)
    return np.where(x <= 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a,
                             0.0))


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in, n_out):
    """PIL's antialiased bicubic (A = -0.5) as an [out, in] matrix."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    W = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        c = scale * (i + 0.5)
        lo, hi = max(0, int(c - 2 * fs + 0.5)), min(n_in, int(c + 2 * fs + 0.5))
        w = _cubic((np.arange(lo, hi, dtype=np.float64) - c + 0.5) / fs, -0.5)
        W[i, lo:hi] = w / w.sum() if w.sum() != 0 else w
    return W.astype(np.float32)


def resize(x: np.ndarray, hw) -> np.ndarray:
    """Bicubic resize of the last two axes, accumulated in float32."""
    t = torch.from_numpy(np.ascontiguousarray(x)).float()
    if t.shape[-2] != hw[0]:
        t = torch.einsum("oh,...hw->...ow",
                         torch.from_numpy(_resize_matrix(t.shape[-2], hw[0])), t)
    if t.shape[-1] != hw[1]:
        t = torch.einsum("ow,...hw->...ho",
                         torch.from_numpy(_resize_matrix(t.shape[-1], hw[1])), t)
    return t.numpy()


def token_maps(self_sum, cross_sums: dict, cross_count: int, spans,
               latent_hw, seed, threshold, k, labels=None):
    """(soft masks [R+1, h, w] with the background last, cluster labels)."""
    h, w = latent_hw
    res = int(round(np.sqrt(self_sum.shape[0] * h / w)))
    res_w = res * w // h
    if labels is None:
        labels = spectral(self_sum, k, seed).cpu().numpy().reshape(res, res_w)
    cross = np.zeros((res, res_w, 77), np.float32)
    for r, m in cross_sums.items():
        m = np.asarray(m, np.float32).reshape(r, -1, 77)
        if r != res:
            m = resize(m.transpose(2, 0, 1), (res, res_w)).transpose(1, 2, 0)
        cross += m
    cross /= max(cross_count, 1)
    span_maps = []
    for ids in spans:
        s = cross[:, :, np.asarray(ids)]
        lo = s.min(axis=(0, 1), keepdims=True)
        hi = s.max(axis=(0, 1), keepdims=True)
        span_maps.append((s - np.abs(lo)) / (hi - lo + 1e-12))
    fg = [np.zeros((res, res_w), np.float32) for _ in spans]
    bg = np.zeros((res, res_w), np.float32)
    for c in range(k):
        cm = (labels == c).astype(np.float32)
        n = max(cm.sum(), 1e-12)
        hit = False
        for sm, f in zip(span_maps, fg):
            if ((cm[:, :, None] * sm).sum(axis=(0, 1)) / n).max() > threshold:
                f += cm
                hit = True
        if not hit:
            bg += cm
    out = np.clip(resize(np.stack(fg + [bg]), (h, w)), 0.0, 1.0)
    return out / (out.sum(axis=0, keepdims=True) + 1e-8), labels
