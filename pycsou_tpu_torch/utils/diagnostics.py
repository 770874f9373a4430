"""MCMC convergence diagnostics: effective sample size and split-R-hat
(counterpart of ``pycsou_tpu/utils/diagnostics.py``; Vehtari, Gelman,
Simpson, Carpenter and Buerkner 2021).

* :func:`effective_sample_size`: multi-chain ESS from the FFT
  autocovariance with Geyer's initial-monotone-sequence truncation;
* :func:`split_rhat`: the potential scale reduction factor on half-split
  chains (usable on one chain).

Tensor code on the chains' device, float32 as in the reference; Geyer's
truncation is a masked cumulative product and minimum, not a loop.
"""
from __future__ import annotations

import math

import torch

__all__ = ["autocovariance", "effective_sample_size", "split_rhat"]


def _chains_2d(x) -> torch.Tensor:
    """The chains as a (n_chains, n_draws) float32 tensor."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError("chains must be (n_draws,) or (n_chains, n_draws)")
    return x


def autocovariance(x) -> torch.Tensor:
    """Biased (1/n) autocovariance of each row of ``x`` by one real FFT
    round trip; shape (n_chains, n_draws)."""
    x = _chains_2d(x)
    n = x.shape[-1]
    xc = x - x.mean(dim=-1, keepdim=True)
    # a power of two >= 2n - 1, so the circular correlation is linear
    nfft = 1 << max(1, int(2 * n - 1).bit_length())
    f = torch.fft.rfft(xc, n=nfft, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=-1)[:, :n]
    return acov / n


def effective_sample_size(chains) -> torch.Tensor:
    """Multi-chain effective sample size (0-d tensor) of ``chains``
    ((n_chains, n_draws) or (n_draws,)): between/within-chain variance
    pooling, Geyer pair sums ``P_k = rho_{2k} + rho_{2k+1}`` truncated at
    the first non-positive pair and made non-increasing, then
    ``ESS = m n / (-1 + 2 sum_k P_k)``, capped at ``m n log10(m n)``.

    Example: independent draws have an ESS near m n::

        >>> import numpy as np
        >>> from pycsou_tpu_torch.utils.diagnostics import effective_sample_size
        >>> x = np.random.default_rng(0).standard_normal((4, 500))
        >>> bool(float(effective_sample_size(x)) > 1000)
        True
    """
    x = _chains_2d(chains)
    m, n = x.shape
    acov = autocovariance(x)
    mean_acov = acov.mean(dim=0)
    W = torch.mean(acov[:, 0] * n / (n - 1.0))  # within-chain variance (unbiased)
    var_plus = W * (n - 1.0) / n
    if m > 1:
        var_plus = var_plus + torch.var(x.mean(dim=-1), correction=1)
    rho = 1.0 - (W - mean_acov) / var_plus
    n_pairs = n // 2
    pair = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(dim=1)
    # keep pairs up to the first non-positive one (pair 0 always stays)
    pos = pair > 0.0
    pos[0] = True
    keep = torch.cumprod(pos.to(torch.int32), dim=0) == 1
    zero = torch.zeros_like(pair)
    mono = torch.cummin(torch.where(keep, pair, zero), dim=0).values
    tau = -1.0 + 2.0 * torch.sum(torch.where(keep, torch.clamp(mono, min=0.0), zero))
    ess = (m * n) / torch.clamp(tau, min=1.0 / (m * n))
    return torch.clamp(ess, max=m * n * math.log10(float(m * n)))


def split_rhat(chains) -> torch.Tensor:
    """Split-R-hat (0-d tensor): each chain split in half, so one chain
    also gives a diagnostic; values near 1 (< 1.01) say the chains agree in
    their first two moments.

    Example::

        >>> import numpy as np
        >>> from pycsou_tpu_torch.utils.diagnostics import split_rhat
        >>> x = np.random.default_rng(0).standard_normal((4, 500))
        >>> bool(abs(float(split_rhat(x)) - 1.0) < 0.05)
        True
    """
    x = _chains_2d(chains)
    m, n = x.shape
    half = n // 2
    x = torch.cat([x[:, :half], x[:, n - half:]], dim=0)
    W = torch.mean(torch.var(x, dim=-1, correction=1))
    B_over_n = torch.var(x.mean(dim=-1), correction=1)
    var_plus = W * (half - 1.0) / half + B_over_n
    return torch.sqrt(var_plus / W)
