"""Each cell end to end at a tiny shape on the CPU: the result line
meets the contract and reads correct; the controls (the reference in
TF32 in the program's place, and the program's own bfloat16 path) and
each fault planted under the timed path read not correct."""
import json
import math
import subprocess
import sys

import pytest
import torch

from dspbench.harness import main as hm
from dspbench.tests.tiny import bench, run_tiny

CELLS = ("ddc64.stream",)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_meets_the_contract(monkeypatch, workload):
    res, info = run_tiny(monkeypatch, workload)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    units = {m["name"]: m["unit"] for m in bench()["end_to_end"]}
    assert set(res["metrics"]) == set(units)
    for k, m in res["metrics"].items():
        assert m["unit"] == units[k] and math.isfinite(m["value"])
        assert m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert c["limit"] is None or c["value"] <= c["limit"]
    json.loads(json.dumps(res, allow_nan=False))


@pytest.mark.parametrize("workload,variant", [
    ("ddc64.stream", "control"), ("ddc64.stream", "control:bf16"),
    ("ddc64.stream", "fault:state"), ("ddc64.stream", "fault:half"),
    ("ddc64.stream", "fault:answer")])
def test_control_and_faults_are_not_correct(monkeypatch, workload, variant):
    res, _ = run_tiny(monkeypatch, workload, variant, seconds=0.3)
    assert res["correct"] is False


def test_a_turned_block_is_judged_by_its_drift(monkeypatch):
    """Outputs turned by an angle that grows with the block read as NCO
    drift, and leave the arithmetic numbers where they were."""
    from dspbench.systems import ddc
    turn = 1e-4
    orig = ddc.DDC.consume

    def consume(self, g, handle):
        yr, yi = handle[1]
        c = torch.cos(torch.tensor(turn * g, dtype=torch.float64))
        s = torch.sin(torch.tensor(turn * g, dtype=torch.float64))
        out = ((yr * c - yi * s).float(), (yr * s + yi * c).float())
        orig(self, g, (handle[0], out))

    base, _ = run_tiny(monkeypatch, "ddc64.stream", seconds=0.3)
    monkeypatch.setattr(ddc.DDC, "consume", consume)
    res, _ = run_tiny(monkeypatch, "ddc64.stream", seconds=0.3)
    assert res["correct"] is False
    assert res["checks"]["nco_drift_rad"]["value"] == pytest.approx(
        turn, rel=1e-2)
    for k in ("ddc_rms_err", "ddc_max_err"):
        assert res["checks"][k]["value"] < 2 * base["checks"][k]["value"] \
            + 1e-6


def test_no_card_no_result(tmp_path):
    """Without a card (as here) the command exits non-zero and prints no
    result; so it does in a directory without the program."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    run = subprocess.run([sys.executable, str(hm.BENCH_DIR / "run.py"),
                          "--workload", "ddc64.stream", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode != 0 and run.stdout.strip() == ""
