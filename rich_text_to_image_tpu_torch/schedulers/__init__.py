"""Noise schedulers of the port, as in the JAX package: ``plan(steps)``
precomputes every per-step constant on the host (numpy), ``init_state``
makes the state on a device, ``scale_model_input`` and ``step`` run the
float32 update on tensors. PNDM is SD-1.5's default; DDIM, EulerDiscrete
(float timesteps, ``plan.init_noise_sigma``) and DPM-Solver++ (2M) are the
others the CLI offers; flow-matching Euler is FLUX.1's."""

from .common import make_alphas_cumprod
from .ddim import DDIMScheduler
from .dpmsolver import DPMSolverMultistepScheduler
from .euler import EulerDiscreteScheduler
from .flow_match import FlowMatchEulerScheduler
from .pndm import PNDMScheduler

__all__ = [
    "make_alphas_cumprod",
    "DDIMScheduler",
    "DPMSolverMultistepScheduler",
    "EulerDiscreteScheduler",
    "FlowMatchEulerScheduler",
    "PNDMScheduler",
]
