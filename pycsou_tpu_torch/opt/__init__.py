"""Solvers: the proximal splittings (PDS, CPS, DRS, FBS, APGD), the fused
TV and LASSO engines, the PMYULA sampler and consensus ADMM."""
from pycsou_tpu_torch.opt.admm import ConsensusADMM
from pycsou_tpu_torch.opt.lasso import LassoDeconvolution
from pycsou_tpu_torch.opt.mcmc import PMYULA
from pycsou_tpu_torch.opt.proxalgs import (
    APGD,
    CPS,
    DRS,
    FBS,
    PDS,
    AcceleratedProximalGradientDescent,
    ChambollePockSplitting,
    DouglasRachfordSplitting,
    ForwardBackwardSplitting,
    PrimalDualSplitting,
)
from pycsou_tpu_torch.opt.tv import TVDeconvolution

__all__ = [
    "APGD",
    "AcceleratedProximalGradientDescent",
    "CPS",
    "ConsensusADMM",
    "ChambollePockSplitting",
    "DRS",
    "DouglasRachfordSplitting",
    "FBS",
    "ForwardBackwardSplitting",
    "LassoDeconvolution",
    "PDS",
    "PMYULA",
    "PrimalDualSplitting",
    "TVDeconvolution",
]
