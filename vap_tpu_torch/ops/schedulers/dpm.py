"""CogVideoX DPM-solver++(2M)-SDE scheduler as step functions.

Port of ``vap_tpu/ops/schedulers/dpm.py`` (CogVideoXDPMScheduler,
scheduling_dpm_cogvideox.py:125-489): per-step coefficients are tabled on
the host once (``step_coefficients``, numpy, copied), and ``step`` carries
the previous step's x0 prediction and injects the caller's noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import make_alphas_cumprod, make_timesteps


@dataclasses.dataclass(frozen=True)
class CogVideoXDPMScheduler:
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
    order: int = 1

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

    # --- copied from vap_tpu/ops/schedulers/dpm.py:47-87 --------------------
    def step_coefficients(self, num_inference_steps: int):
        """Per-step scalars: (alpha_prod_t, mult1, mult2, mult3, mult4,
        mult_noise, use_second_order). Step i uses timestep_back = ts[i-1]."""
        ac = self.alphas_cumprod.astype(np.float64)
        ts = self.timesteps(num_inference_steps)
        stride = self.num_train_timesteps // num_inference_steps
        rows = []
        # numpy float64 scalars: boundary steps divide by zero -> inf, matching
        # the torch reference semantics (exp(-inf)=0, expm1(-inf)=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            for i, t in enumerate(ts):
                prev_t = t - stride
                t_back = ts[i - 1] if i > 0 else None
                ap_t = np.float64(ac[t])
                ap_prev = np.float64(ac[prev_t] if prev_t >= 0 else self.final_alpha_cumprod)
                ap_back = np.float64(ac[t_back]) if t_back is not None else None

                lamb = np.log((ap_t / (1 - ap_t)) ** 0.5)
                lamb_next = np.log((ap_prev / (1 - ap_prev)) ** 0.5)
                h = lamb_next - lamb
                if ap_back is not None:
                    lamb_prev = np.log((ap_back / (1 - ap_back)) ** 0.5)
                    r = (lamb - lamb_prev) / h
                else:
                    r = 1.0

                mult1 = ((1 - ap_prev) / (1 - ap_t)) ** 0.5 * np.exp(-h)
                mult2 = np.expm1(-2 * h) * ap_prev ** 0.5
                mult3 = 1 + 1 / (2 * r)
                mult4 = 1 / (2 * r)
                mult_noise = (1 - ap_prev) ** 0.5 * (1 - np.exp(-2 * h)) ** 0.5
                second = 1.0 if (i > 0 and prev_t >= 0) else 0.0
                rows.append((ap_t, mult1, mult2, mult3, mult4, mult_noise, second))
        out = tuple(np.asarray(c, np.float32) for c in zip(*rows))
        return tuple(np.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0) if i != 0 else c
                     for i, c in enumerate(out))

    def pred_original_sample(self, model_output, sample, alpha_prod_t):
        beta_prod_t = 1.0 - alpha_prod_t
        if self.prediction_type == "epsilon":
            return (sample - beta_prod_t ** 0.5 * model_output) / alpha_prod_t ** 0.5
        if self.prediction_type == "sample":
            return model_output
        if self.prediction_type == "v_prediction":
            return (alpha_prod_t ** 0.5) * sample - (beta_prod_t ** 0.5) * model_output
        raise ValueError(self.prediction_type)

    def step(self, model_output, sample, old_x0, coeffs, noise):
        """One DPM update (``dpm.py:99-109``). ``coeffs``: the seven float32
        0-d tensors of one step; ``old_x0``: the previous step's x0 (zeros at
        step 0). Returns (prev_sample, x0)."""
        ap_t, m1, m2, m3, m4, mn, second = coeffs
        x0 = self.pred_original_sample(model_output, sample, ap_t)
        first = m1 * sample - m2 * x0 + mn * noise
        denoised_d = m3 * x0 - m4 * old_x0
        advanced = m1 * sample - m2 * denoised_d + mn * noise
        return torch.where(second > 0, advanced, first), x0
