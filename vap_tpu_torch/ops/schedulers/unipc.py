"""UniPC multistep scheduler (order 2, bh2, predictor and corrector) over
flow sigmas: the Wan path's second scheduler.

Port of ``vap_tpu/ops/schedulers/unipc.py:32-150`` (diffusers
UniPCMultistepScheduler with solver_order=2, solver_type="bh2",
predict_x0, lower_order_final, the corrector on, flow_prediction and
use_flow_sigmas). As in JAX, every per-step scalar is tabled on the host
(``sigmas``, ``timesteps``, ``step_coefficients``: numpy, copied), and
``step`` carries ``(m_prev, m_prev2, last_sample)``, the last two
x0-converted model outputs and the last sample before its correction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# --- copied from vap_tpu/ops/schedulers/unipc.py:23-28 ------------------------
def _lam(sigma: float) -> float:
    """lambda = log(alpha) - log(sigma) for flow sigmas (alpha = 1 - sigma)."""
    if sigma <= 0.0:
        return 40.0  # effectively +inf: expm1(-40) == -1 to fp32 precision
    return float(np.log(1.0 - sigma) - np.log(sigma))


def _f32(v) -> float:
    """A float32 scalar as the Python float that holds it exactly."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class UniPCScheduler:
    num_train_timesteps: int = 1000
    shift: float = 3.0
    solver_order: int = 2

    init_noise_sigma: float = 1.0
    order: int = 1

    # --- copied from vap_tpu/ops/schedulers/unipc.py:41-126 -------------------
    def sigmas(self, num_inference_steps: int) -> np.ndarray:
        """Flow sigma grid with a terminal 0 (len = steps + 1), float32."""
        alphas = np.linspace(1, 1 / self.num_train_timesteps, num_inference_steps + 1)
        s = 1.0 - alphas
        s = np.flip(self.shift * s / (1 + (self.shift - 1) * s))[:-1].copy()
        return np.concatenate([s, [0.0]]).astype(np.float32)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """int64-truncated timesteps, as the reference feeds the model."""
        s = self.sigmas(num_inference_steps)[:-1]
        return (s * self.num_train_timesteps).astype(np.int64).astype(np.float32)

    def step_coefficients(self, num_inference_steps: int) -> Dict[str, np.ndarray]:
        """Per-step scalars [steps] (float32) of the corrector (``c_*``) and
        the predictor (``p_*``); the tables are built in float64."""
        sig = self.sigmas(num_inference_steps).astype(np.float64)
        n = num_inference_steps
        cols = {k: [] for k in (
            "sigma", "c_ratio", "c_alpha", "c_hphi1", "c_r0", "c_r1", "c_rinv", "c_order",
            "p_ratio", "p_alpha", "p_hphi1", "p_rinv", "p_order",
        )}
        for i in range(n):
            s_i, s_next = sig[i], sig[i + 1]
            lam_i = _lam(s_i)
            cols["sigma"].append(s_i)

            # corrector at step i (corrects last_sample -> sample)
            if i > 0:
                s_im1 = sig[i - 1]
                lam_im1 = _lam(s_im1)
                h_c = lam_i - lam_im1
                hh = -h_c
                hphi1 = np.expm1(hh)
                b_h = hphi1  # bh2
                if i >= 2:
                    lam_im2 = _lam(sig[i - 2])
                    r1 = (lam_im2 - lam_im1) / h_c
                    # solve [[1,1],[r1,1]] x = [b0, b1]
                    hk1 = hphi1 / hh - 1.0
                    b0 = hk1 / b_h
                    hk2 = hk1 / hh - 0.5
                    b1 = hk2 * 2.0 / b_h
                    rc0 = (b0 - b1) / (1.0 - r1)
                    rc1 = b0 - rc0
                    order_c = 2.0
                    rinv_c = 1.0 / r1
                else:
                    rc0, rc1, rinv_c, order_c = 0.0, 0.5, 0.0, 1.0
                cols["c_ratio"].append(s_i / s_im1)
                cols["c_alpha"].append(1.0 - s_i)
                cols["c_hphi1"].append(hphi1)
                cols["c_r0"].append(rc0)
                cols["c_r1"].append(rc1)
                cols["c_rinv"].append(rinv_c)
                cols["c_order"].append(order_c)
            else:
                for k in ("c_ratio", "c_alpha", "c_hphi1", "c_r0", "c_r1", "c_rinv"):
                    cols[k].append(0.0)
                cols["c_order"].append(0.0)

            # predictor at step i (sample -> prev_sample)
            h_p = _lam(s_next) - lam_i
            hh = -h_p
            hphi1_p = np.expm1(hh)
            # this_order = min(solver_order, n - i, lower_order_nums + 1)
            order_p = min(self.solver_order, n - i, i + 1)
            if order_p >= 2:
                lam_im1 = _lam(sig[i - 1])
                r1_p = (lam_im1 - lam_i) / h_p
                rinv_p = 1.0 / r1_p
            else:
                rinv_p = 0.0
            cols["p_ratio"].append(s_next / s_i)
            cols["p_alpha"].append(1.0 - s_next)
            cols["p_hphi1"].append(hphi1_p)
            cols["p_rinv"].append(rinv_p)
            cols["p_order"].append(float(order_p))
        return {k: np.asarray(v, np.float32) for k, v in cols.items()}

    @staticmethod
    def convert_to_x0(model_output: torch.Tensor, sample: torch.Tensor, sigma) -> torch.Tensor:
        """flow_prediction: x0 = x_t - sigma * v."""
        return sample - _f32(sigma) * model_output

    @staticmethod
    def init_carry(sample: torch.Tensor) -> Carry:
        z = torch.zeros_like(sample, dtype=torch.float32)
        return z, z, z

    def step(self, model_output: torch.Tensor, sample: torch.Tensor, carry: Carry,
             c: Dict[str, np.floating]) -> Tuple[torch.Tensor, Carry]:
        """One UniPC step in float32; ``c`` holds this step's scalars (one
        entry of each ``step_coefficients`` column). Returns (prev_sample in
        the sample's dtype, the new carry). The step's orders are host
        scalars, so only the branch they pick runs (JAX selects with
        ``jnp.where``; the values are the same). Scalar products are taken
        in float32, in JAX's order."""
        m_prev, m_prev2, last_sample = carry
        x = sample.float()
        m_t = self.convert_to_x0(model_output.float(), x, c["sigma"])

        # corrector: refine the current sample with this step's model output
        order_c = float(c["c_order"])
        if order_c:
            a_phi = _f32(np.float32(c["c_alpha"]) * np.float32(c["c_hphi1"]))
            base_c = _f32(c["c_ratio"]) * last_sample - a_phi * m_prev
            d1_t = m_t - m_prev
            if order_c == 1.0:
                x = base_c - a_phi * (0.5 * d1_t)  # bh2: B_h == h_phi_1
            else:
                d1_c = (m_prev2 - m_prev) * _f32(c["c_rinv"])
                x = base_c - a_phi * (_f32(c["c_r0"]) * d1_c + _f32(c["c_r1"]) * d1_t)

        # predictor
        p_phi = _f32(np.float32(c["p_alpha"]) * np.float32(c["p_hphi1"]))
        base_p = _f32(c["p_ratio"]) * x - p_phi * m_t
        if float(c["p_order"]) == 1.0:
            prev_sample = base_p
        else:
            d1_p = (m_prev - m_t) * _f32(c["p_rinv"])
            prev_sample = base_p - p_phi * (0.5 * d1_p)
        return prev_sample.to(sample.dtype), (m_t, m_prev, x)
