"""The plain reference against the port's plain engine on the CPU, the
reference's operators against their definitions, and the control (the
reference in bfloat16 in the program's place) failing the check."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import load_tiny
from perfbench.harness import check

SEED = 2**31 + 12345


@pytest.mark.parametrize("name", ["deconv.tiny", "inpaint.tiny"])
def test_reference_follows_the_ports_plain_engine(tiny_bench, name):
    """The port (its CPU engine, through the user API) and the float64
    reference at 48 x 64: the same iterate after the port's iteration
    count, and the same stopping iteration."""
    from perfbench.harness.jobs import Setup

    cell = load_tiny(tiny_bench, name)
    setup = Setup(cell, SEED, "cpu")
    for k in range(setup.pool_size):
        _, info, x, _ = setup.job(k)
        setup.release(x)
        inputs = cell.config_module().reference_inputs(cell.config, cell.shape, SEED, k, "cpu")
        r = check.readings(cell, inputs, info.n_iter, info.converged_at, x, "cpu")
        ok, checks = check.judge(r, cell.config["limits"])
        assert ok, checks
        assert r["x_rel_l2"] < 1e-5 and r["stop_gap"] <= 2


def test_reference_convolution_is_the_ports_and_its_adjoint(tiny_bench):
    from pycsou_tpu_torch.ops import Convolve2D

    cell = load_tiny(tiny_bench, "deconv.tiny")
    mod, ref = cell.config_module(), cell.reference_module()
    h = mod.psf(cell.config)
    g = torch.Generator().manual_seed(3)
    x = torch.rand(cell.shape, generator=g, dtype=torch.float64)
    r = torch.rand(cell.shape, generator=g, dtype=torch.float64)
    p = ref.Problem({"y": torch.zeros(cell.shape), "psf": h}, "cpu")
    port = Convolve2D(cell.shape, h, device="cpu")
    ax = p.apply(x)
    assert torch.allclose(ax.float(), port.apply(x.float()), atol=1e-6)
    assert float(torch.sum(ax * r)) == pytest.approx(float(torch.sum(x * p.adjoint(r))), rel=1e-12)
    assert p.beta == pytest.approx(2 * float(np.sum(h.astype(np.float64))) ** 2, rel=1e-12)
    # the harness's own blur of the data is the same 'same' convolution
    assert torch.allclose(mod.blur(x.float(), h), port.apply(x.float()), atol=1e-6)


@pytest.mark.parametrize("name", ["deconv.tiny", "inpaint.tiny"])
def test_the_bfloat16_control_is_not_correct(tiny_bench, name):
    cell = load_tiny(tiny_bench, name)
    for seed in (SEED, SEED + 1, SEED + 2):
        inputs = cell.config_module().reference_inputs(cell.config, cell.shape, seed, 0, "cpu")
        n_iter, conv, x = check.control_record(cell, inputs, "cpu")
        ok, checks = check.judge(check.readings(cell, inputs, n_iter, conv, x, "cpu"), cell.config["limits"])
        assert not ok, checks


def test_reference_imports_nothing_of_the_program():
    from conftest import BENCH_DIR

    for p in (BENCH_DIR / "reference").glob("*.py"):
        text = p.read_text()
        for name in ("pycsou_tpu", "jax", "perfbench.harness"):
            assert f"import {name}" not in text and f"from {name}" not in text, (p.name, name)
