"""Proximal maps, projections and Green kernels."""
from pycsou_tpu_torch.math.green import (
    CausalGreenExponential,
    CausalGreenIteratedDerivative,
    Matern,
    SubGaussian,
    Wendland,
)
from pycsou_tpu_torch.math.prox import (
    lambertw,
    proj_l1_ball,
    proj_l2_ball,
    proj_linfty_ball,
    proj_nonnegative_orthant,
    proj_segment,
    sign,
    soft,
)

__all__ = [
    "CausalGreenExponential",
    "CausalGreenIteratedDerivative",
    "Matern",
    "SubGaussian",
    "Wendland",
    "lambertw",
    "proj_l1_ball",
    "proj_l2_ball",
    "proj_linfty_ball",
    "proj_nonnegative_orthant",
    "proj_segment",
    "sign",
    "soft",
]
