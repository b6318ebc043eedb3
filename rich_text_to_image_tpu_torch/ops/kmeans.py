"""K-means with k-means++ seeding, batched over restarts.

Counterpart of ``rich_text_to_image_tpu/ops/kmeans.py`` (which replaces
sklearn's ``KMeans(n_init=100)`` inside spectral clustering): all ``n_init``
restarts run together as one batch of tensors, Lloyd iterations as a Python
loop, and the restart with the least inertia wins. Randomness comes from an
explicit ``torch.Generator``, so labels are not the JAX package's for the
same seed; they agree up to a permutation where the clusters are clear.
"""

from __future__ import annotations

import torch


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x [N, D], centers [I, k, D] -> squared distances [I, N, k]."""
    return ((x * x).sum(1)[None, :, None]
            - 2 * torch.einsum("nd,ikd->ink", x, centers)
            + (centers * centers).sum(2)[:, None, :])


def _kmeans_pp_init(x: torch.Tensor, k: int, n_init: int,
                    gen: torch.Generator) -> torch.Tensor:
    """k-means++ seeding (d^2 sampling) of ``n_init`` restarts at once."""
    n = x.shape[0]
    first = torch.randint(0, n, (n_init,), generator=gen, device=x.device)
    centers = torch.zeros((n_init, k, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    centers[:, 0] = x[first]
    d2 = ((x[None] - x[first][:, None]) ** 2).sum(-1)  # [I, N]
    for i in range(1, k):
        probs = d2 / d2.sum(1, keepdim=True).clamp_min(1e-12)
        idx = torch.multinomial(probs, 1, generator=gen).squeeze(1)
        c = x[idx]  # [I, D]
        centers[:, i] = c
        d2 = torch.minimum(d2, ((x[None] - c[:, None]) ** 2).sum(-1))
    return centers


def kmeans(x: torch.Tensor, k: int, n_init: int = 100, iters: int = 50,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Best-of-``n_init`` k-means. x: [N, D] -> labels [N] int64."""
    x = x.float()
    gen = generator or torch.Generator(device=x.device).manual_seed(0)
    centers = _kmeans_pp_init(x, k, n_init, gen)
    for _ in range(iters):
        labels = _sq_dists(x, centers).argmin(2)  # [I, N]
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        counts = onehot.sum(1)  # [I, k]
        sums = torch.einsum("ink,nd->ikd", onehot, x)
        centers = torch.where(counts[..., None] > 0,
                              sums / counts.clamp_min(1)[..., None], centers)
    d2 = _sq_dists(x, centers)
    inertia = d2.min(2).values.sum(1)
    return d2.argmin(2)[inertia.argmin()]
