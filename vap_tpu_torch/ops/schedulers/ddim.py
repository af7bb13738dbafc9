"""CogVideoX DDIM scheduler (v-prediction) as step functions.

Port of ``vap_tpu/ops/schedulers/ddim.py``: per-step coefficients are
tabled on the host once (``step_coefficients``), and ``step`` is two
multiply-adds on the latents.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .common import make_alphas_cumprod, make_timesteps


@dataclasses.dataclass(frozen=True)
class CogVideoXDDIMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.0120
    beta_schedule: str = "scaled_linear"
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    prediction_type: str = "v_prediction"
    timestep_spacing: str = "trailing"
    rescale_betas_zero_snr: bool = True
    snr_shift_scale: float = 3.0

    init_noise_sigma: float = 1.0

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return make_alphas_cumprod(
            self.num_train_timesteps, self.beta_start, self.beta_end, self.beta_schedule,
            self.snr_shift_scale, self.rescale_betas_zero_snr,
        )

    @property
    def final_alpha_cumprod(self) -> float:
        return 1.0 if self.set_alpha_to_one else float(self.alphas_cumprod[0])

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return make_timesteps(self.num_train_timesteps, num_inference_steps,
                              self.timestep_spacing, self.steps_offset)

    def step_coefficients(self, num_inference_steps: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per inference step (a_t, b_t, alpha_prod_t), float32 (``ddim.py:47-70``)."""
        ac = self.alphas_cumprod
        ts = self.timesteps(num_inference_steps)
        stride = self.num_train_timesteps // num_inference_steps
        a_list, b_list, ap_list = [], [], []
        for t in ts:
            prev_t = t - stride
            alpha_prod_t = ac[t]
            alpha_prod_t_prev = ac[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
            a_t = ((1 - alpha_prod_t_prev) / (1 - alpha_prod_t)) ** 0.5
            b_t = alpha_prod_t_prev ** 0.5 - alpha_prod_t ** 0.5 * a_t
            a_list.append(a_t)
            b_list.append(b_t)
            ap_list.append(alpha_prod_t)
        return (np.asarray(a_list, np.float32), np.asarray(b_list, np.float32),
                np.asarray(ap_list, np.float32))

    def pred_original_sample(self, model_output, sample, alpha_prod_t):
        beta_prod_t = 1.0 - alpha_prod_t
        if self.prediction_type == "epsilon":
            return (sample - beta_prod_t ** 0.5 * model_output) / alpha_prod_t ** 0.5
        if self.prediction_type == "sample":
            return model_output
        if self.prediction_type == "v_prediction":
            return (alpha_prod_t ** 0.5) * sample - (beta_prod_t ** 0.5) * model_output
        raise ValueError(self.prediction_type)

    def step(self, model_output, sample, a_t, b_t, alpha_prod_t):
        """One DDIM update; the scalars are float32 0-d tensors of one step."""
        x0 = self.pred_original_sample(model_output, sample, alpha_prod_t)
        return a_t * sample + b_t * x0
