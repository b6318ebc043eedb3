"""DDIM scheduler (eta=0, epsilon prediction).

Counterpart of ``rich_text_to_image_tpu/schedulers/ddim.py``: the same
host-precomputed plan (timesteps and the alpha products at each step and
the one it steps to) and the same update, on float32 tensors. diffusers'
defaults as the JAX package takes them: scaled_linear betas 0.00085 ->
0.012, 1000 train steps, ``steps_offset=1``, ``set_alpha_to_one=False``,
no clipping. For ``num_inference_steps=N`` the plan has N steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .common import make_alphas_cumprod


@dataclasses.dataclass(frozen=True)
class DDIMPlan:
    timesteps: np.ndarray  # (S,) int32
    alpha_prod_t: np.ndarray  # (S,) float32
    alpha_prod_t_prev: np.ndarray  # (S,) float32
    num_steps: int


class DDIMScheduler:
    order = 1

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 beta_schedule: str = "scaled_linear", steps_offset: int = 1,
                 set_alpha_to_one: bool = False, clip_sample: bool = False):
        self.num_train_timesteps = num_train_timesteps
        self.steps_offset = steps_offset
        self.clip_sample = clip_sample
        self.alphas_cumprod = make_alphas_cumprod(
            num_train_timesteps, beta_start, beta_end, beta_schedule)
        self.final_alpha_cumprod = (
            1.0 if set_alpha_to_one else float(self.alphas_cumprod[0]))

    def plan(self, num_inference_steps: int) -> DDIMPlan:
        step_ratio = self.num_train_timesteps // num_inference_steps
        timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[
            ::-1].copy().astype(np.int64) + self.steps_offset
        prev_t = timesteps - step_ratio
        alpha_prev = np.where(
            prev_t >= 0, self.alphas_cumprod[np.clip(prev_t, 0, None)],
            self.final_alpha_cumprod)
        return DDIMPlan(
            timesteps=timesteps.astype(np.int32),
            alpha_prod_t=self.alphas_cumprod[timesteps].astype(np.float32),
            alpha_prod_t_prev=alpha_prev.astype(np.float32),
            num_steps=num_inference_steps,
        )

    def init_state(self, latent_shape, device="cuda"):
        del latent_shape, device
        return ()

    def init_noise_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, plan, i, sample):
        del plan, i
        return sample

    def step(self, plan: DDIMPlan, i: int, state, model_output, sample):
        """One DDIM update at step ``i``; returns (prev_sample, state). The
        scalars are float32, as in the JAX package."""
        a_t = np.float32(plan.alpha_prod_t[i])
        a_p = np.float32(plan.alpha_prod_t_prev[i])
        one, half = np.float32(1.0), np.float32(0.5)
        model_output = model_output.float()
        x0 = ((sample.float() - float((one - a_t) ** half) * model_output)
              / float(a_t ** half))
        if self.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        dir_xt = float((one - a_p) ** half) * model_output
        return float(a_p ** half) * x0 + dir_xt, state
