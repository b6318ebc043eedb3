"""EulerDiscrete scheduler (s_churn=0: deterministic, no state).

Counterpart of ``rich_text_to_image_tpu/schedulers/euler.py``, diffusers
0.18.2 numerics (SDXL's default scheduler): timesteps spaced linearly over
the 1000 train steps, reversed, **as floats** (they reach the UNet
unrounded); sigmas interpolated linearly with a trailing 0. The model input
is scaled by 1/sqrt(sigma^2 + 1), and the first latent by the plan's
``init_noise_sigma``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .common import make_alphas_cumprod


@dataclasses.dataclass(frozen=True)
class EulerPlan:
    timesteps: np.ndarray  # (S,) float32, the t fed to the UNet
    sigmas: np.ndarray  # (S+1,) float32, trailing 0.0
    init_noise_sigma: float
    num_steps: int


class EulerDiscreteScheduler:
    order = 1

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 beta_schedule: str = "scaled_linear"):
        self.num_train_timesteps = num_train_timesteps
        self.alphas_cumprod = make_alphas_cumprod(
            num_train_timesteps, beta_start, beta_end, beta_schedule)

    def plan(self, num_inference_steps: int) -> EulerPlan:
        timesteps = np.linspace(0, self.num_train_timesteps - 1,
                                num_inference_steps, dtype=np.float64)[::-1]
        sigmas_full = ((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5
        sigmas = np.interp(timesteps, np.arange(self.num_train_timesteps),
                           sigmas_full)
        sigmas = np.concatenate([sigmas, [0.0]])
        return EulerPlan(
            timesteps=timesteps.astype(np.float32),
            sigmas=sigmas.astype(np.float32),
            init_noise_sigma=float((sigmas.max() ** 2 + 1) ** 0.5),
            num_steps=num_inference_steps,
        )

    def init_state(self, latent_shape, device="cuda"):
        del latent_shape, device
        return ()

    def scale_model_input(self, plan: EulerPlan, i: int, sample):
        sigma = np.float32(plan.sigmas[i])
        return sample / float(np.sqrt(sigma ** 2 + np.float32(1.0)))

    def step(self, plan: EulerPlan, i: int, state, model_output, sample):
        """Euler step from sigma_i to sigma_{i+1}; returns (prev, state)."""
        sigma = np.float32(plan.sigmas[i])
        sigma_next = np.float32(plan.sigmas[i + 1])
        model_output = model_output.float()
        sample = sample.float()
        denoised = sample - float(sigma) * model_output
        derivative = (sample - denoised) / float(sigma)
        return sample + derivative * float(sigma_next - sigma), state
