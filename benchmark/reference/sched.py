"""The samplers of the plain reference, as diffusers 0.18 defines them for
SD-1.5 and SDXL: PNDM's PLMS path (``skip_prk_steps``, ``steps_offset``
1, no alpha set to one) and EulerDiscrete (no churn); scaled-linear betas
0.00085 -> 0.012 over 1000 steps.

``step(i, eps, x, history, x_first)`` is one step taken from the latent
``x`` at step ``i`` with the noise prediction ``eps``; a multistep sampler
reads the noise predictions of the earlier steps from ``history`` and, at
PNDM's repeated second step, the first step's latent ``x_first``.
"""

from __future__ import annotations

import numpy as np


def alphas_cumprod(n=1000, start=0.00085, end=0.012) -> np.ndarray:
    betas = np.linspace(start ** 0.5, end ** 0.5, n, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


class PNDM:
    """PLMS. ``timesteps`` has N + 1 entries: the second repeats the first
    interval, stepped from the first latent with the mean of two slopes."""

    def __init__(self, steps: int):
        self.acp = alphas_cumprod()
        self.ratio = 1000 // steps
        base = np.arange(steps) * self.ratio + 1
        t = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1]
        self.timesteps = t.astype(np.int64)
        self.init_sigma = 1.0

    def scale(self, i, x):
        return x

    def alpha(self, i) -> float:
        return float(self.acp[int(self.timesteps[i])])

    def step(self, i, eps, x, history, x_first):
        t = int(self.timesteps[i])
        prev = t - self.ratio
        # the slopes of the earlier steps, the repeated step's left out
        e = [h for j, h in enumerate(history[:i]) if j != 1] + [eps]
        if i == 1:
            prev, t = t, t + self.ratio
            eps, x = (eps + history[0]) / 2, x_first
        elif i == 2:
            eps = (3 * e[-1] - e[-2]) / 2
        elif i == 3:
            eps = (23 * e[-1] - 16 * e[-2] + 5 * e[-3]) / 12
        elif i >= 4:
            eps = (55 * e[-1] - 59 * e[-2] + 37 * e[-3] - 9 * e[-4]) / 24
        a_t = self.acp[t]
        a_p = self.acp[prev] if prev >= 0 else self.acp[0]
        denom = a_t * (1 - a_p) ** 0.5 + (a_t * (1 - a_t) * a_p) ** 0.5
        return float((a_p / a_t) ** 0.5) * x - float((a_p - a_t) / denom) * eps


class Euler:
    def __init__(self, steps: int):
        acp = alphas_cumprod()
        t = np.linspace(0, 999, steps, dtype=np.float64)[::-1]
        s = np.interp(t, np.arange(1000), ((1 - acp) / acp) ** 0.5)
        self.acp = acp
        self.timesteps = t.astype(np.float32)
        self.sigmas = np.concatenate([s, [0.0]])
        self.init_sigma = float((s.max() ** 2 + 1) ** 0.5)

    def scale(self, i, x):
        return x / float((self.sigmas[i] ** 2 + 1) ** 0.5)

    def alpha(self, i) -> float:
        return float(self.acp[int(self.timesteps[i])])

    def step(self, i, eps, x, history=(), x_first=None):
        return x + eps * float(self.sigmas[i + 1] - self.sigmas[i])


SAMPLERS = {"pndm": PNDM, "euler": Euler}
