"""Flow-matching Euler scheduler (the Wan2.1 path).

Port of ``vap_tpu/ops/schedulers/flow_match.py``: diffusers
FlowMatchEulerDiscreteScheduler with a static time shift,
sigma' = shift * sigma / (1 + (shift - 1) * sigma). The model predicts the
flow velocity v = noise - x0 and the Euler update is
x += (sigma_next - sigma) * v, in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerScheduler:
    num_train_timesteps: int = 1000
    shift: float = 3.0

    init_noise_sigma: float = 1.0
    order: int = 1

    # --- copied from vap_tpu/ops/schedulers/flow_match.py (sigmas, timesteps)
    def sigmas(self, num_inference_steps: int) -> np.ndarray:
        """Per-step sigma grid with a terminal 0 (len = steps + 1), float32.

        The reference's two-stage construction: the training sigmas are
        shifted once to give [sigma_max, sigma_min], and the inference
        linspace over that range is shifted again."""
        s_min0 = 1.0 / self.num_train_timesteps
        sigma_min = self.shift * s_min0 / (1 + (self.shift - 1) * s_min0)
        sigma_max = 1.0
        t = np.linspace(sigma_max * self.num_train_timesteps, sigma_min * self.num_train_timesteps,
                        num_inference_steps, dtype=np.float64)
        s = t / self.num_train_timesteps
        s = self.shift * s / (1 + (self.shift - 1) * s)
        return np.concatenate([s, [0.0]]).astype(np.float32)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return (self.sigmas(num_inference_steps)[:-1] * self.num_train_timesteps).astype(np.float32)

    @staticmethod
    def step(model_output: torch.Tensor, sample: torch.Tensor, sigma: np.float32,
             sigma_next: np.float32) -> torch.Tensor:
        """One Euler step in float32, cast back to the sample's dtype; the
        sigma difference is taken in float32, as the JAX step takes it."""
        dt = float(np.float32(sigma_next) - np.float32(sigma))
        x = sample.float() + dt * model_output.float()
        return x.to(sample.dtype)
