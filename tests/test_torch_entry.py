"""``pycsou_tpu_torch/entry.py`` against ``__graft_entry__.py`` on the CPU.

* ``entry()``: the flagship problem is the reference's (the same numpy
  draws), and its ``PDS`` fuses as the reference's does; three steps from
  the initial state against the JAX entry's three steps, and one port step
  from the JAX state after two steps (carried across by
  ``utils.convert.state_from_numpy``) against the JAX third step: rtol
  1e-4 / atol 1e-5 max|x|.
* ``dryrun_multichip(n)`` on ``n`` CPU positions prints every path the
  reference's dry run runs but "2c", and the line that says why "2c" has
  no counterpart; without an even n >= 4 the 2-D mesh paths are left out,
  as in the reference.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from pycsou_tpu_torch import entry as tentry
from pycsou_tpu_torch.utils.convert import state_from_numpy
from pycsou_tpu_torch.utils.device import set_default_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_cpu():
    """The CPU, on one thread: these runs are chains of small tensor ops,
    which several threads a test worker only slow down when the workers
    share the machine."""
    set_default_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_default_device(None)


def _reference():
    spec = importlib.util.spec_from_file_location("graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX entry's state after 0-3 steps (numpy), and its solver."""
    fn, (solver, state) = _reference().entry()
    step = jax.jit(fn)
    states = [state]
    for _ in range(3):
        states.append(step(solver, states[-1]))
    return solver, [{k: np.asarray(v) for k, v in s.items()} for s in states]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_entry_problem_and_fusion_match_reference(jax_steps):
    jsolver, _ = jax_steps
    fn, (solver, state) = tentry.entry()
    assert type(solver._fused).__name__ == type(jsolver._fused).__name__ == "TVDeconvolution"
    assert solver._fused.stencil_mode == "plain" and jsolver._fused.stencil_mode == "xla"
    _close(solver._fused.atb, jsolver._fused.atb)
    np.testing.assert_allclose(solver._fused.tau, jsolver._fused.tau, rtol=1e-6)
    assert {"x", "z0", "z1"} <= set(state)


def test_entry_steps_match_reference(jax_steps):
    _, jstates = jax_steps
    fn, (solver, state) = tentry.entry()
    for k in range(1, 4):
        state = fn(solver, state)
        for key in ("x", "z0", "z1"):
            _close(state[key], jstates[k][key])


def test_entry_step_from_the_reference_state(jax_steps):
    _, jstates = jax_steps
    fn, (solver, state) = tentry.entry()
    carried = state_from_numpy(jstates[2], "cpu", like=state)
    out = fn(solver, carried)
    for key in ("x", "z0", "z1"):
        _close(out[key], jstates[3][key])


PATHS = ("1:", "2:", "1b:", "1c:", "2b:", "2c2:", "2c3:", "2d:", "2e:", "3:", "3b:", "3c:")


def test_dryrun_multichip_cpu_mesh(capsys):
    paths = tentry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert [p.split(" ")[0] for p in paths] == list(PATHS)
    assert "dryrun_multichip(4) on cpu OK: 12 paths executed" in out
    for p in paths:
        assert f"  path {p}\n" in out
    assert "path 2c: not run: the port has no SPMD partitioner" in out


def test_dryrun_multichip_two_positions(capsys):
    paths = tentry.dryrun_multichip(2, device="cpu")
    assert [p.split(" ")[0] for p in paths] == list(PATHS[:9])
    assert "9 paths executed" in capsys.readouterr().out


def test_entry_main_on_the_cpu(capsys):
    tentry.main(["--device", "cpu", "--n", "4"])
    out = capsys.readouterr().out
    assert "entry() step OK on cpu: engine plain" in out and "12 paths executed" in out

