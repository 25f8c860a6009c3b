"""Spring settings → TGS softness constants (reference SpringSettings.cs:37-57).

For angular frequency ω and twice damping ratio 2ζ over a substep dt:

- ``position_error_to_velocity`` = ω / (ω·dt + 2ζ)
- ``effective_mass_cfm_scale``   = 1 / (1 + extra),   extra = 1 / (ω·dt·(ω·dt + 2ζ))
- ``softness_impulse_scale``     = extra · effective_mass_cfm_scale
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SpringSettings(NamedTuple):
    """``angular_frequency`` = 2π × frequency; ``twice_damping_ratio`` = 2 × damping."""

    angular_frequency: torch.Tensor
    twice_damping_ratio: torch.Tensor

    @staticmethod
    def make(frequency, damping_ratio) -> "SpringSettings":
        return SpringSettings(
            torch.as_tensor(frequency, dtype=torch.float32) * (2.0 * math.pi),
            torch.as_tensor(damping_ratio, dtype=torch.float32) * 2.0,
        )


def compute_springiness(settings: SpringSettings, dt):
    """Returns (position_error_to_velocity, effective_mass_cfm_scale, softness_impulse_scale)."""
    w_dt = settings.angular_frequency * dt
    position_error_to_velocity = settings.angular_frequency / (w_dt + settings.twice_damping_ratio)
    extra = 1.0 / (w_dt * (w_dt + settings.twice_damping_ratio))
    effective_mass_cfm_scale = 1.0 / (1.0 + extra)
    softness_impulse_scale = extra * effective_mass_cfm_scale
    return position_error_to_velocity, effective_mass_cfm_scale, softness_impulse_scale
