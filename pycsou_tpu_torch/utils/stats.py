"""Streaming statistics: the P-Square quantile estimate, vectorised over
coordinates (counterpart of ``pycsou_tpu/utils/stats.py``).

A state is a dict of tensors on one device; :func:`p2_add` is pure tensor
code with no host read, so a sampler can update it every sample without
waiting on the card.  The warm-up (fewer than five samples) and the marker
update are both computed and the state's own ``count`` selects between
them, as the reference's ``lax.cond`` does.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["p2_init", "p2_add", "p2_quantile", "P2Algorithm"]


def p2_init(pvalue: float, shape=(), device=None) -> Dict[str, torch.Tensor]:
    """Fresh P^2 state for per-coordinate quantile tracking on tensors of
    ``shape``; markers at the p-values [0, p/2, p, (1+p)/2, 1]."""
    p = float(pvalue)
    shape = tuple(shape)
    f32 = dict(dtype=torch.float32, device=device)
    n0 = torch.arange(1.0, 6.0, **f32).reshape((5,) + (1,) * len(shape))
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "buffer": torch.zeros((5,) + shape, **f32),
        "q": torch.zeros((5,) + shape, **f32),
        "n": n0 * torch.ones((5,) + shape, **f32),
        "n_des": torch.tensor([1.0, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5.0], **f32),
        "inc": torch.tensor([0.0, p / 2, p, (1 + p) / 2, 1.0], **f32),
    }


def _p2_core(state, x):
    """One marker update for the sample x (every coordinate at once), the
    reference's ``_p2_core``."""
    q, n, n_des = state["q"].clone(), state["n"].clone(), state["n_des"]
    q[0] = torch.minimum(q[0], x)
    q[4] = torch.maximum(q[4], x)
    # cell index k in {0, 1, 2, 3} of each coordinate
    k = torch.clamp(sum((x >= q[i]).to(torch.int32) for i in range(4)) - 1, 0, 3)
    marker = torch.arange(5, device=q.device).reshape((5,) + (1,) * (q.ndim - 1))
    n = n + (marker > k[None]).to(n.dtype)
    for i in (1, 2, 3):
        d = n_des[i] - n[i]
        up = (d >= 1) & ((n[i + 1] - n[i]) > 1)
        dn = (d <= -1) & ((n[i - 1] - n[i]) < -1)
        move = up | dn
        ds = torch.where(up, 1.0, -1.0)
        # parabolic (P^2) candidate
        qp = q[i] + (ds / (n[i + 1] - n[i - 1])) * (
            (n[i] - n[i - 1] + ds) * (q[i + 1] - q[i]) / torch.clamp(n[i + 1] - n[i], min=1e-12)
            + (n[i + 1] - n[i] - ds) * (q[i] - q[i - 1]) / torch.clamp(n[i] - n[i - 1], min=1e-12)
        )
        ok = (q[i - 1] < qp) & (qp < q[i + 1])
        # linear step toward the neighbour in the direction ds
        q_up = q[i] + (q[i + 1] - q[i]) / torch.clamp(n[i + 1] - n[i], min=1e-12)
        q_dn = q[i] - (q[i - 1] - q[i]) / torch.clamp(n[i - 1] - n[i], max=-1e-12)
        q_new = torch.where(ok, qp, torch.where(ds > 0, q_up, q_dn))
        q[i] = torch.where(move, q_new, q[i])
        n[i] = torch.where(move, n[i] + ds, n[i])
    return q, n


def p2_add(state: Dict[str, torch.Tensor], sample) -> Dict[str, torch.Tensor]:
    """The state after one more sample (a tensor of the tracked shape); the
    input state is not modified."""
    buf0 = state["buffer"]
    x = torch.as_tensor(sample, dtype=torch.float32, device=buf0.device)
    cnt = state["count"]
    warm = cnt < 5
    # warm-up: the sample into buffer slot cnt, the markers the sorted buffer
    slot = torch.arange(5, device=buf0.device).reshape((5,) + (1,) * x.ndim)
    buf = torch.where(slot == cnt, x[None], buf0)
    q_warm = torch.sort(buf, dim=0).values
    # update: advance the desired positions, move the markers
    n_des = state["n_des"] + state["inc"]
    q_upd, n_upd = _p2_core({**state, "n_des": n_des}, x)
    return {
        **state,
        "count": cnt + 1,
        "buffer": torch.where(warm, buf, buf0),
        "q": torch.where(warm, q_warm, q_upd),
        "n": torch.where(warm, state["n"], n_upd),
        "n_des": torch.where(warm, state["n_des"], n_des),
    }


def p2_quantile(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The current quantile estimate (the middle marker's height)."""
    return state["q"][2]


class P2Algorithm:
    """Stateful host wrapper with the reference's API (``add_sample`` /
    ``.q``) over :func:`p2_add`.

    Example: the streaming median of 0..99::

        >>> from pycsou_tpu_torch.utils.stats import P2Algorithm
        >>> p2 = P2Algorithm(0.5)
        >>> for v in range(100):
        ...     p2.add_sample(float(v))
        >>> abs(float(p2.q[0]) - 49.5) < 1.5
        True
    """

    def __init__(self, pvalue: float, device=None):
        self.pvalue = float(pvalue)
        self.device = device
        self._state = None

    def add_sample(self, sample):
        """Fold one (vector) sample into the running quantile state."""
        x = torch.atleast_1d(torch.as_tensor(sample, dtype=torch.float32, device=self.device))
        if self._state is None:
            self._state = p2_init(self.pvalue, x.shape, device=x.device)
        self._state = p2_add(self._state, x)

    @property
    def q(self) -> np.ndarray:
        """The current quantile estimate(s)."""
        if self._state is None:
            raise ValueError("no samples added yet")
        return p2_quantile(self._state).cpu().numpy()
