"""Flow-matching Euler (FLUX.1's ``FlowMatchEulerDiscreteScheduler`` with
dynamic shifting, as ``FluxPipeline`` sets it).

The model predicts a velocity v; a step moves the sample along it,
x <- x + (sigma_{n+1} - sigma_n) v, in float32. The sigmas are
linspace(1, 1/S, S), shifted towards 1 by the image's length in tokens,
sigma <- e^mu / (e^mu + 1/sigma - 1), with mu linear in the token count
between (256, 0.5) and (4096, 1.15) (1.15 at 1024^2), then a trailing 0.
The transformer takes sigma (it multiplies by 1000 itself).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlowPlan:
    sigmas: np.ndarray  # (S+1,) float32, trailing 0.0
    num_steps: int
    mu: float


def flux_mu(image_seq_len: int, base_seq_len: int = 256,
            max_seq_len: int = 4096, base_shift: float = 0.5,
            max_shift: float = 1.15) -> float:
    """``FluxPipeline.calculate_shift``: mu linear in the image tokens."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    return image_seq_len * m + (base_shift - m * base_seq_len)


class FlowMatchEulerScheduler:
    def plan(self, num_inference_steps: int,
             image_seq_len: int = 4096) -> FlowPlan:
        S = int(num_inference_steps)
        mu = flux_mu(image_seq_len)
        sig = np.linspace(1.0, 1.0 / S, S, dtype=np.float64)
        sig = math.exp(mu) / (math.exp(mu) + (1.0 / sig - 1.0))
        sig = np.concatenate([sig, [0.0]]).astype(np.float32)
        return FlowPlan(sigmas=sig, num_steps=S, mu=mu)

    def init_state(self, latent_shape, device="cuda"):
        del latent_shape, device
        return ()

    def step(self, plan: FlowPlan, i: int, state, model_output, sample):
        """One Euler step of the flow from sigma_i to sigma_{i+1}; returns
        (next sample, state)."""
        dt = float(plan.sigmas[i + 1] - plan.sigmas[i])
        return sample.float() + dt * model_output.float(), state
