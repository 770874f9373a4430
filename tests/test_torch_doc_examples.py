"""The port's docstring examples run as doctests on the CPU: the five
classes ``tests/test_doc_examples.py`` pins for the reference, each of
which must carry an example, and a sweep of every module of
``pycsou_tpu_torch``.  The examples are written for the card (their tensors
on ``get_default_device()``); the fixture sets the port's default device to
the CPU, so they need no ``device=`` here.  ``tests/test_torch_gpu.py``
runs the same sweep with the default left at ``cuda``."""
import doctest
import importlib
import pathlib

import pytest
import torch

import pycsou_tpu_torch
from pycsou_tpu_torch.utils.device import set_default_device


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


def _run(obj):
    finder = doctest.DocTestFinder(recurse=False)
    runner = doctest.DocTestRunner(optionflags=doctest.NORMALIZE_WHITESPACE)
    tests = finder.find(obj, name=obj.__name__)
    assert tests and any(t.examples for t in tests), f"{obj.__name__} has no docstring example"
    for t in tests:
        runner.run(t)
    assert runner.failures == 0, f"doctest failures in {obj.__name__}"


def test_operator_example():
    from pycsou_tpu_torch.ops.conv import Convolve2D

    _run(Convolve2D)


def test_functional_example():
    from pycsou_tpu_torch.func.penalty import L1Norm

    _run(L1Norm)


def test_solver_example():
    from pycsou_tpu_torch.opt.proxalgs import PrimalDualSplitting

    _run(PrimalDualSplitting)


def test_flagship_example():
    from pycsou_tpu_torch.opt.tv import TVDeconvolution

    _run(TVDeconvolution)


def test_distributed_solver_example():
    from pycsou_tpu_torch.parallel.solvers import DistributedTVDeconv2D

    _run(DistributedTVDeconv2D)


def _package_modules():
    root = pathlib.Path(pycsou_tpu_torch.__file__).parent
    names = []
    for p in sorted(root.rglob("*.py")):
        mod = ".".join(p.relative_to(root.parent).with_suffix("").parts)
        names.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return names


@pytest.mark.parametrize("modname", _package_modules())
def test_module_doctests(modname):
    mod = importlib.import_module(modname)
    runner = doctest.testmod(mod, optionflags=doctest.NORMALIZE_WHITESPACE, verbose=False)
    assert runner.failed == 0, f"{runner.failed} doctest failures in {modname}"


def test_doctest_lines_cover_the_reference_modules():
    """Every module the reference gives docstring examples in has them in
    the port too (``pycsou_tpu/*``'s ``>>>`` lines against the port's)."""
    import pycsou_tpu

    ref, port = pathlib.Path(pycsou_tpu.__file__).parent, pathlib.Path(pycsou_tpu_torch.__file__).parent
    missing = [str(p.relative_to(ref)) for p in sorted(ref.rglob("*.py"))
               if ">>>" in p.read_text() and ">>>" not in (port / p.relative_to(ref)).read_text()]
    assert not missing, f"no docstring example in the port's {missing}"
