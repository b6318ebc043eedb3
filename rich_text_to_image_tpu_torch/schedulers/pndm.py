"""PNDM scheduler (PLMS path, skip_prk_steps=True).

Counterpart of ``rich_text_to_image_tpu/schedulers/pndm.py``: the same
host-precomputed plan (per-step timesteps, alpha products and the linear-
multistep coefficients over a 4-deep history ring) and the same update, on
float32 tensors. The pipeline's Python loop indexes the plan with the step
number, so every branch is resolved on the host.

The reference's configuration (diffusers 0.18.2 ``PNDMScheduler``):
scaled_linear betas 0.00085 -> 0.012, 1000 train steps, ``steps_offset=1``,
``set_alpha_to_one=False``. For ``num_inference_steps=N`` the plan has N+1
steps (the second timestep is repeated), as diffusers' ``plms_timesteps``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import make_alphas_cumprod


@dataclasses.dataclass(frozen=True)
class PNDMPlan:
    """Host-side per-step constants, indexed by the step number i."""

    timesteps: np.ndarray  # (S,) int32, the t fed to the UNet
    alpha_prod_t: np.ndarray  # (S,) float32
    alpha_prod_t_prev: np.ndarray  # (S,) float32
    ets_coeffs: np.ndarray  # (S, 4) float32, weights over the history ring
    mo_coeff: np.ndarray  # (S,) float32, weight on the current model output
    append_ets: np.ndarray  # (S,) bool, whether step i pushes into the ring
    use_cur_sample: np.ndarray  # (S,) bool, step 1 re-uses the stored sample
    store_cur_sample: np.ndarray  # (S,) bool, step 0 stores the sample
    num_steps: int


@dataclasses.dataclass
class PNDMState:
    """``ets[k]`` is older for smaller k; ``ets[-1]`` is the newest."""

    ets: torch.Tensor  # (4, *latent_shape)
    cur_sample: torch.Tensor  # latent_shape


class PNDMScheduler:
    order = 1

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 beta_schedule: str = "scaled_linear",
                 skip_prk_steps: bool = True, steps_offset: int = 1,
                 set_alpha_to_one: bool = False):
        if not skip_prk_steps:
            raise NotImplementedError(
                "only the PLMS path (skip_prk_steps=True) is implemented")
        self.num_train_timesteps = num_train_timesteps
        self.steps_offset = steps_offset
        self.alphas_cumprod = make_alphas_cumprod(
            num_train_timesteps, beta_start, beta_end, beta_schedule)
        self.final_alpha_cumprod = (
            1.0 if set_alpha_to_one else float(self.alphas_cumprod[0]))

    def plan(self, num_inference_steps: int) -> PNDMPlan:
        step_ratio = self.num_train_timesteps // num_inference_steps
        base = (np.arange(0, num_inference_steps) * step_ratio).round().astype(
            np.int64) + self.steps_offset
        # plms_timesteps: drop the final t, duplicate the second-to-last,
        # re-append the last, then reverse (diffusers PNDM set_timesteps)
        plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
        S = len(plms)
        alpha_t = np.empty(S, dtype=np.float64)
        alpha_prev = np.empty(S, dtype=np.float64)
        ets_coeffs = np.zeros((S, 4), dtype=np.float64)
        mo_coeff = np.zeros(S, dtype=np.float64)
        append_ets = np.ones(S, dtype=bool)
        use_cur = np.zeros(S, dtype=bool)
        store_cur = np.zeros(S, dtype=bool)
        for i, t in enumerate(plms):
            t_eff = int(t)
            t_prev = t_eff - step_ratio
            if i == 1:
                # counter == 1: redo the first interval with the mean slope
                t_prev = t_eff
                t_eff = t_eff + step_ratio
                append_ets[i] = False
                use_cur[i] = True
                mo_coeff[i] = 0.5
                ets_coeffs[i, 3] = 0.5
            elif i == 0:
                store_cur[i] = True
                mo_coeff[i] = 1.0
            elif i == 2:
                ets_coeffs[i, 3] = 3.0 / 2.0
                ets_coeffs[i, 2] = -1.0 / 2.0
            elif i == 3:
                ets_coeffs[i, 3] = 23.0 / 12.0
                ets_coeffs[i, 2] = -16.0 / 12.0
                ets_coeffs[i, 1] = 5.0 / 12.0
            else:
                ets_coeffs[i, 3] = 55.0 / 24.0
                ets_coeffs[i, 2] = -59.0 / 24.0
                ets_coeffs[i, 1] = 37.0 / 24.0
                ets_coeffs[i, 0] = -9.0 / 24.0
            alpha_t[i] = self.alphas_cumprod[t_eff]
            alpha_prev[i] = (self.alphas_cumprod[t_prev] if t_prev >= 0
                             else self.final_alpha_cumprod)
        return PNDMPlan(
            timesteps=plms.astype(np.int32),
            alpha_prod_t=alpha_t.astype(np.float32),
            alpha_prod_t_prev=alpha_prev.astype(np.float32),
            ets_coeffs=ets_coeffs.astype(np.float32),
            mo_coeff=mo_coeff.astype(np.float32),
            append_ets=append_ets,
            use_cur_sample=use_cur,
            store_cur_sample=store_cur,
            num_steps=S,
        )

    def init_state(self, latent_shape, device="cuda") -> PNDMState:
        return PNDMState(
            ets=torch.zeros((4, *latent_shape), dtype=torch.float32,
                            device=device),
            cur_sample=torch.zeros(latent_shape, dtype=torch.float32,
                                   device=device),
        )

    def init_noise_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, plan, i, sample):
        del plan, i
        return sample

    def step(self, plan: PNDMPlan, i: int, state: PNDMState, model_output,
             sample):
        """One PLMS update at step ``i``; returns (prev_sample, state)."""
        model_output = model_output.float()
        sample = sample.float()
        ets = state.ets
        if plan.append_ets[i]:
            ets = torch.cat([ets[1:], model_output[None]], dim=0)
        c = [float(v) for v in plan.ets_coeffs[i]]
        combined = float(plan.mo_coeff[i]) * model_output
        for k in range(4):
            if c[k] != 0.0:
                combined = combined + c[k] * ets[k]
        cur_sample = sample if plan.store_cur_sample[i] else state.cur_sample
        eff_sample = cur_sample if plan.use_cur_sample[i] else sample
        prev = _get_prev_sample(eff_sample, combined,
                                float(plan.alpha_prod_t[i]),
                                float(plan.alpha_prod_t_prev[i]))
        return prev, PNDMState(ets=ets, cur_sample=cur_sample)


def _get_prev_sample(sample, model_output, alpha_prod_t: float,
                     alpha_prod_t_prev: float):
    """diffusers ``PNDMScheduler._get_prev_sample``, epsilon prediction. The
    scalars are computed in float32, as in the JAX package."""
    a_t = np.float32(alpha_prod_t)
    a_p = np.float32(alpha_prod_t_prev)
    one = np.float32(1.0)
    sample_coeff = (a_p / a_t) ** np.float32(0.5)
    denom = a_t * (one - a_p) ** np.float32(0.5) + (
        a_t * (one - a_t) * a_p) ** np.float32(0.5)
    return (float(sample_coeff) * sample
            - float(a_p - a_t) * model_output / float(denom))
