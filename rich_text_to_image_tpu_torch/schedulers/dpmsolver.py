"""DPM-Solver++ (2M) scheduler.

Counterpart of ``rich_text_to_image_tpu/schedulers/dpmsolver.py``:
diffusers' ``DPMSolverMultistepScheduler`` defaults (algorithm
dpmsolver++, solver order 2, epsilon prediction, first-order first and
final steps), with timesteps spaced linearly over [0, 999]. The plan holds
each step's coefficients on (sample, x0, previous x0), worked out on the
host in float64; the state is the previous step's x0 prediction, of the
latent's shape (two rows where two trajectories share one step).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import make_alphas_cumprod


@dataclasses.dataclass(frozen=True)
class DPMPlan:
    timesteps: np.ndarray  # (S,) int32, the t fed to the UNet
    alpha_t: np.ndarray  # (S+1,) sqrt(alphas_cumprod) at step boundaries
    sigma_t: np.ndarray  # (S+1,) sqrt(1 - alphas_cumprod)
    lambda_t: np.ndarray  # (S+1,) log(alpha / sigma)
    coeffs: np.ndarray  # (S, 3) on (sample, x0, previous x0)
    num_steps: int


class DPMSolverMultistepScheduler:
    order = 1

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 beta_schedule: str = "scaled_linear"):
        self.num_train_timesteps = num_train_timesteps
        self.alphas_cumprod = make_alphas_cumprod(
            num_train_timesteps, beta_start, beta_end, beta_schedule)

    def plan(self, num_inference_steps: int) -> DPMPlan:
        N = self.num_train_timesteps
        timesteps = np.linspace(0, N - 1, num_inference_steps + 1).round()[
            ::-1][:-1].astype(np.int64)
        S = len(timesteps)
        bounds = np.asarray(list(timesteps) + [0])  # terminal boundary t=0
        alpha_t = np.sqrt(self.alphas_cumprod[bounds])
        sigma_t = np.sqrt(1.0 - self.alphas_cumprod[bounds])
        lambda_t = np.log(alpha_t) - np.log(sigma_t)
        coeffs = np.zeros((S, 3), dtype=np.float64)
        for i in range(S):
            h = lambda_t[i + 1] - lambda_t[i]
            c_sample = sigma_t[i + 1] / sigma_t[i]
            c_x0 = alpha_t[i + 1] * (1.0 - np.exp(-h))
            if i == 0 or i == S - 1:  # first-order: DPM-Solver++(1)
                coeffs[i] = [c_sample, c_x0, 0.0]
            else:  # 2M: D0 + D1/2 with D1 = (x0_i - x0_{i-1}) / r
                r = (lambda_t[i] - lambda_t[i - 1]) / h
                coeffs[i] = [c_sample, c_x0 * (1.0 + 0.5 / r),
                             -c_x0 * 0.5 / r]
        return DPMPlan(
            timesteps=timesteps.astype(np.int32),
            alpha_t=alpha_t.astype(np.float32),
            sigma_t=sigma_t.astype(np.float32),
            lambda_t=lambda_t.astype(np.float32),
            coeffs=coeffs.astype(np.float32),
            num_steps=S,
        )

    def init_state(self, latent_shape, device="cuda") -> torch.Tensor:
        """The previous x0 prediction, zero before the first step."""
        return torch.zeros(latent_shape, dtype=torch.float32, device=device)

    def init_noise_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, plan, i, sample):
        del plan, i
        return sample

    def step(self, plan: DPMPlan, i: int, state, model_output, sample):
        """One 2M update; returns (prev_sample, this step's x0)."""
        model_output = model_output.float()
        sample = sample.float()
        x0 = ((sample - float(plan.sigma_t[i]) * model_output)
              / float(plan.alpha_t[i]))
        c = [float(v) for v in plan.coeffs[i]]
        return c[0] * sample + c[1] * x0 + c[2] * state, x0
