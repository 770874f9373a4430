"""Solvers of the TV-deconvolution and masked TV slices."""
from pycsou_tpu_torch.opt.proxalgs import CPS, PDS, ChambollePockSplitting, PrimalDualSplitting
from pycsou_tpu_torch.opt.tv import TVDeconvolution

__all__ = ["PDS", "PrimalDualSplitting", "CPS", "ChambollePockSplitting", "TVDeconvolution"]
