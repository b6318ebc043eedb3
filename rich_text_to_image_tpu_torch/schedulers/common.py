"""Shared beta/alpha schedule math (host-side, float64 for accuracy)."""

from __future__ import annotations

import numpy as np


def make_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(
                beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64
            )
            ** 2
        )
    raise ValueError(f"unknown beta_schedule: {beta_schedule}")


def make_alphas_cumprod(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
) -> np.ndarray:
    """cumprod(1 - betas); the SD-1.5/SDXL default schedule by default."""
    betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    return np.cumprod(1.0 - betas)
