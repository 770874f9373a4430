"""The reader of ``conv_reuse_share`` (the program's ``pds.conv_reused``
counter over its ``pds.init`` spans): its values on hand-made records, its
entry in ``BENCHMARK.json``, and a traced tiny frames run, in which every
job's ``PDS`` takes the cell's ``Convolve2D`` as it is."""
from __future__ import annotations

import json

import pytest

import test_perfbench_program as tp
from conftest import ROOT, load_tiny, run_tiny
from pycsou_tpu_torch.utils import profiling

ctx_of = tp.ctx_of
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("case", ["reused", "no counter", "no build"])
def test_conv_reuse_share(ctx_of, case):
    recs = [r for r in tp._records() if case != "no build" or not r.name.startswith(("pds.", "conv."))]
    mod, _ = tp._fake_program(recs, {} if case == "no counter" else {"pds.conv_reused": 1})
    cell, ctx = ctx_of("deconv.frames2048", tp._trace(), mod)
    assert cell.reader("conv_reuse_share").read(ctx) == {"reused": 1.0, "no counter": 0, "no build": None}[case]


@pytest.mark.parametrize("case", ["untraced", "no module"])
def test_conv_reuse_share_has_nothing_to_read(ctx_of, case):
    mod, _ = tp._fake_program(tp._records(), {"pds.conv_reused": 1})
    cell, ctx = ctx_of("deconv.frames2048", None if case == "untraced" else tp._trace(),
                       None if case == "no module" else mod)
    assert cell.reader("conv_reuse_share").read(ctx) is None


def test_conv_reuse_share_entry():
    m = BENCH["per_layer"][-1]  # appended at the end
    assert m == {"name": "conv_reuse_share", "unit": "share", "better": "higher", "source": "program_counter",
                 "layer": "expression, matcher and operators", "moves": "images_per_s.host_paced",
                 "workloads": ["deconv.frames2048"]}
    for cell in (w["name"] for w in BENCH["workloads"]):
        listed = "conv_reuse_share" in {e["name"] for e in load_tiny(ROOT / "BENCHMARK.json", cell).per_layer}
        assert listed == (cell == "deconv.frames2048"), cell


def test_a_traced_tiny_frames_run_reuses_the_convolution(tiny_bench):
    profiling.reset()
    result = run_tiny(tiny_bench, "deconv.tinyframes", trace=True)
    m = result["metrics"]
    assert result["correct"] is True
    # each job's PDS took the cell's Convolve2D as it is: no FFT bound
    assert m["conv_reuse_share"]["value"] == 1.0
    assert m["lipschitz_ms"]["value"] == 0
    assert m["match_ms"]["value"] > 0
