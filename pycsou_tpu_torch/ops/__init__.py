"""Operators of the TV-deconvolution and masked TV slices."""
from pycsou_tpu_torch.ops.basic import HomothetyOperator, IdentityOperator, NullOperator
from pycsou_tpu_torch.ops.conv import Convolve2D, SeparableConvGram2D
from pycsou_tpu_torch.ops.diff import Gradient
from pycsou_tpu_torch.ops.sampling import DownSampling, Masking, SubSampling

__all__ = [
    "HomothetyOperator",
    "IdentityOperator",
    "NullOperator",
    "Convolve2D",
    "SeparableConvGram2D",
    "Gradient",
    "SubSampling",
    "Masking",
    "DownSampling",
]
