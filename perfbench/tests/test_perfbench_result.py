"""The last line's schema, from whole runs of tiny cells on the CPU."""
from __future__ import annotations

import json

import pytest

from perfbench.harness.main import check_lines

PACE = {"deconv.tiny": "device_paced", "inpaint.tiny": "device_paced", "deconv.tinyframes": "host_paced"}


@pytest.mark.parametrize("name", ["deconv.tiny", "inpaint.tiny", "deconv.tinyframes"])
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line_schema(tiny_bench, name, trace):
    from conftest import load_tiny, run_tiny

    cell = load_tiny(tiny_bench, name)
    result = run_tiny(tiny_bench, name, trace=trace)
    line = json.loads(json.dumps(result))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in wanted}
    assert set(line["metrics"]) <= set(units)
    for k, v in line["metrics"].items():
        assert set(v) == {"value", "unit"} and v["unit"] == units[k] and v["value"] > 0
    if trace:
        assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert f"iters_per_image.{PACE[name]}" in line["metrics"]
    else:
        assert {f"images_per_s.{PACE[name]}", "setup_s"} <= set(line["metrics"])
        assert ("solve_ms_p90" in line["metrics"]) == (name == "deconv.tinyframes")
    for k, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    assert len(check_lines(result)) == len(line["checks"])
