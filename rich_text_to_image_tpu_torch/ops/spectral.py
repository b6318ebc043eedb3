"""Spectral clustering of the self-attention affinity.

Counterpart of ``rich_text_to_image_tpu/ops/spectral.py`` (sklearn's
``SpectralClustering(affinity='precomputed', assign_labels='kmeans')`` of
the reference): symmetrise W, normalise M = D^-1/2 W D^-1/2, take the top-k
eigenvectors of M (dense ``eigh``, or Rayleigh-Ritz subspace iteration),
back-scale by D^-1/2 without row normalisation (sklearn's diffusion-map
recovery), then k-means. Labels are permutation-equivalent to sklearn's.
"""

from __future__ import annotations

import torch

from .kmeans import kmeans


def _topk_eigvecs_subspace(M: torch.Tensor, k: int, gen: torch.Generator,
                           iters: int = 100) -> torch.Tensor:
    """Top-k eigenvectors of symmetric M (spectrum in [-1, 1]) by subspace
    iteration on M + I, then Rayleigh-Ritz."""
    n = M.shape[0]
    p = min(k + max(4, k), n)
    V = torch.randn((n, p), generator=gen, device=M.device, dtype=M.dtype)
    for _ in range(iters):
        V, _ = torch.linalg.qr(M @ V + V)
    T = V.T @ (M @ V)
    _, U = torch.linalg.eigh(0.5 * (T + T.T))
    return (V @ U)[:, -k:]


def spectral_cluster(affinity: torch.Tensor, num_segments: int,
                     n_init: int = 100, iters: int = 50,
                     method: str = "eigh",
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """Cluster labels [N] of a nonnegative [N, N] affinity, computed on the
    affinity's device."""
    gen = generator or torch.Generator(device=affinity.device).manual_seed(0)
    W = affinity.float()
    W = 0.5 * (W + W.T)
    d = W.sum(1).clamp_min(1e-12)
    inv_sqrt_d = torch.rsqrt(d)
    M = W * inv_sqrt_d[:, None] * inv_sqrt_d[None, :]
    if method == "subspace":
        vecs = _topk_eigvecs_subspace(M, num_segments, gen)
    elif method == "eigh":
        vecs = torch.linalg.eigh(M)[1][:, -num_segments:]
    else:
        raise ValueError(f"unknown method {method!r}")
    emb = vecs * inv_sqrt_d[:, None]
    return kmeans(emb, num_segments, n_init=n_init, iters=iters, generator=gen)
