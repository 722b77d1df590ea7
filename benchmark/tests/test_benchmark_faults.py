"""A whole run on the CPU at a small size, past the look for a chip: a
sound run is correct, and each fault the cell can have, planted in the
timed path (the drivers' ``--fault``), and the control turn ``correct``
false."""

import json
import os
import time

import pytest

from benchmark import run

FAULTS = ["stale_state", "half_batch", "altered_answer", "control"]


def cells() -> list:
    """Every cell of BENCHMARK.json (the route engine's, all of them)."""
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


CELLS = cells()


def small(workload: str):
    bench, cell, cfg, mix = run.load_cell(workload)
    cfg = json.loads(json.dumps(cfg))
    cfg["population"].update(ids=64, nums=64)
    mix = dict(mix, window=2, batch=512, ring=2)
    return bench, cell, cfg, mix


def go(workload, fault, seconds=1.0, trace=False):
    bench, cell, cfg, mix = small(workload)
    line, checks, forbidden = run.run_cell(
        bench, cell, cfg, mix, seed=2**31 + 3, seconds=seconds, trace=trace,
        fault=fault, device="cpu", t_start=time.time())
    assert not forbidden
    assert list(line)[-1] == "checks"
    assert len(checks) == len(line["checks"])
    return line


@pytest.mark.parametrize("workload", CELLS)
def test_engine_sound_run_is_correct(workload):
    line = go(workload, None)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"setup_s", "topic_matches_per_s"}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_engine_fault_is_caught(workload, fault):
    line = go(workload, fault)
    assert not line["correct"], line["checks"]


def test_traced_engine_run_reports_its_tail():
    line = go(CELLS[0], None, seconds=2.0, trace=True)
    assert line["correct"]
    assert set(line["metrics"]) == {"window_p99_ms"}     # no device here
    assert line["metrics"]["window_p99_ms"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_small_run_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench, cell, cfg, mix = small(workload)
    line, _checks, _f = run.run_cell(bench, cell, cfg, mix, seed=5,
                                     seconds=2.0, trace=True, device="cuda",
                                     t_start=time.time())
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
