"""Noise-schedule tables (numpy), copied from ``vap_tpu/ops/schedulers/common.py:17-70``,
and the training-time ``add_noise`` and ``get_velocity`` (:76-88) in PyTorch.

Scaled-linear betas in float64, the SD3-style SNR shift and the optional
zero-terminal-SNR rescale of the reference CogVideoX schedulers.
"""

from __future__ import annotations

import numpy as np
import torch


def make_betas(num_train_timesteps: int, beta_start: float, beta_end: float,
               beta_schedule: str) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float32)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                           dtype=np.float64) ** 2
    raise NotImplementedError(beta_schedule)


def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    abar_sqrt = np.sqrt(alphas_cumprod)
    abar_sqrt_0 = abar_sqrt[0].copy()
    abar_sqrt_T = abar_sqrt[-1].copy()
    abar_sqrt = abar_sqrt - abar_sqrt_T
    abar_sqrt = abar_sqrt * abar_sqrt_0 / (abar_sqrt_0 - abar_sqrt_T)
    return abar_sqrt ** 2


def make_alphas_cumprod(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.0120,
    beta_schedule: str = "scaled_linear",
    snr_shift_scale: float = 3.0,
    rescale_betas_zero_snr: bool = False,
) -> np.ndarray:
    betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    alphas_cumprod = alphas_cumprod / (snr_shift_scale + (1 - snr_shift_scale) * alphas_cumprod)
    if rescale_betas_zero_snr:
        alphas_cumprod = rescale_zero_terminal_snr(alphas_cumprod)
    return alphas_cumprod.astype(np.float32)


def make_timesteps(num_train_timesteps: int, num_inference_steps: int,
                   spacing: str = "trailing", steps_offset: int = 0) -> np.ndarray:
    if spacing == "linspace":
        return np.linspace(0, num_train_timesteps - 1, num_inference_steps).round()[::-1].astype(np.int64)
    if spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        t = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        return t + steps_offset
    if spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        return np.round(np.arange(num_train_timesteps, 0, -step_ratio)).astype(np.int64) - 1
    raise ValueError(spacing)


def _coefficients(alphas_cumprod: torch.Tensor, timesteps: torch.Tensor, like: torch.Tensor):
    """sqrt(a_t) and sqrt(1 - a_t), in ``like``'s dtype, shaped to broadcast
    over ``like``'s trailing dims."""
    a = alphas_cumprod[timesteps].to(like.dtype)
    shape = a.shape + (1,) * (like.ndim - a.ndim)
    return a.sqrt().reshape(shape), (1.0 - a).sqrt().reshape(shape)


def add_noise(alphas_cumprod: torch.Tensor, sample: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """sqrt(a_t) * sample + sqrt(1 - a_t) * noise."""
    sqrt_a, sqrt_1ma = _coefficients(alphas_cumprod, timesteps, sample)
    return sqrt_a * sample + sqrt_1ma * noise


def get_velocity(alphas_cumprod: torch.Tensor, sample: torch.Tensor, noise: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
    """sqrt(a_t) * noise - sqrt(1 - a_t) * sample, with the JAX package's
    argument order. The loss calls it as ``get_velocity(ac, velocity, noisy,
    t)``, which is the x0 prediction sqrt(a_t) * noisy - sqrt(1 - a_t) * v of
    a v-prediction model, not the textbook velocity."""
    sqrt_a, sqrt_1ma = _coefficients(alphas_cumprod, timesteps, sample)
    return sqrt_a * noise - sqrt_1ma * sample
