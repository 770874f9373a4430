"""The import check: top-level names compared whole, the run refusing
without a card, and a whole run that loads none of the JAX side."""
from __future__ import annotations

import subprocess
import sys

import pytest

from conftest import ROOT
from perfbench.harness.guard import forbidden_modules


@pytest.mark.parametrize("mods,found", [
    (["pycsou_tpu_torch", "pycsou_tpu_torch.opt.tv", "jaxtyping", "flaxen"], []),
    (["pycsou_tpu"], ["pycsou_tpu"]),
    (["pycsou_tpu.ops.conv", "torch"], ["pycsou_tpu.ops.conv"]),
    (["jax", "jax.numpy"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
])
def test_top_level_names_are_compared_whole(mods, found):
    assert forbidden_modules(mods) == found


def test_the_benchmark_refuses_without_enough_cards():
    """No card (this machine) or fewer than the cell asks for: a non-zero
    exit and no result line."""
    p = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", "deconv.tol4096",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": ""})
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_a_whole_run_loads_nothing_of_the_jax_side(tiny_bench):
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import run_tiny\n"
        "r = run_tiny(__import__('pathlib').Path(%r), 'deconv.tinyframes', trace=True)\n"
        "from perfbench.harness.guard import forbidden_modules\n"
        "assert r['correct'], r['checks']\n"
        "print(forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "perfbench" / "tests"), str(tiny_bench))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
