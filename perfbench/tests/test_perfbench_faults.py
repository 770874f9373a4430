"""Whole runs with the timed path broken underneath: ``correct`` has to
come out false for each fault the cells can have (one chip: no exchange
between chips to leave out; one image a job: no batch, so half of the
image is left out in its place)."""
from __future__ import annotations

import pytest
import torch

from conftest import run_tiny


def _frozen_step(self, state):
    """A step that returns its state unchanged."""
    out = dict(state)
    if "_stats" in state:
        out["_stats"] = torch.zeros_like(state["_stats"])
    return out


def _half_image_step(original):
    def step(self, state):
        out = original(self, state)
        h = out["x"].shape[0] // 2
        x = out["x"].clone()
        x[h:] = state["x"][h:]
        out["x"] = x
        return out
    return step


def _altered_answer(original):
    def postprocess(self, state):
        out = original(self, state)
        x = out["x"].clone()
        x.view(-1)[x.numel() // 3] += 0.01 * float(x.abs().max())
        out["x"] = x
        return out
    return postprocess


@pytest.mark.parametrize("name", ["deconv.tiny", "inpaint.tiny", "deconv.tinyframes"])
@pytest.mark.parametrize("fault", ["frozen_step", "half_image", "altered_answer"])
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, name, fault):
    from pycsou_tpu_torch.opt.proxalgs import PrimalDualSplitting
    from pycsou_tpu_torch.opt.tv import TVDeconvolution

    if fault == "frozen_step":
        monkeypatch.setattr(TVDeconvolution, "step", _frozen_step)
    elif fault == "half_image":
        monkeypatch.setattr(TVDeconvolution, "step", _half_image_step(TVDeconvolution.step))
    else:
        monkeypatch.setattr(PrimalDualSplitting, "postprocess",
                            _altered_answer(PrimalDualSplitting.postprocess))
    result = run_tiny(tiny_bench, name)
    assert result["correct"] is False, result["checks"]


def test_the_unbroken_path_is_correct(tiny_bench):
    assert run_tiny(tiny_bench, "deconv.tiny")["correct"] is True
