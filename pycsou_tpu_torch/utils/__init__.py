"""Utilities: shapes, devices, JAX-state conversion, streaming quantiles and
MCMC diagnostics."""
from pycsou_tpu_torch.utils.diagnostics import autocovariance, effective_sample_size, split_rhat
from pycsou_tpu_torch.utils.opnorm import lanczos_eigs, power_iteration
from pycsou_tpu_torch.utils.shapes import as_shape, size_of
from pycsou_tpu_torch.utils.stats import P2Algorithm, p2_add, p2_init, p2_quantile

__all__ = [
    "P2Algorithm",
    "as_shape",
    "autocovariance",
    "effective_sample_size",
    "lanczos_eigs",
    "p2_add",
    "p2_init",
    "p2_quantile",
    "power_iteration",
    "size_of",
    "split_rhat",
]
