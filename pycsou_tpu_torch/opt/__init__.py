"""Solvers of the TV-deconvolution slice."""
from pycsou_tpu_torch.opt.proxalgs import PDS, PrimalDualSplitting
from pycsou_tpu_torch.opt.tv import TVDeconvolution

__all__ = ["PDS", "PrimalDualSplitting", "TVDeconvolution"]
