"""Cells, configurations, traffic mixes and per-layer metrics are data
found by name: a file dropped into its folder and an entry in
BENCHMARK.json are all a new cell takes.  And the per-layer readers on a
synthetic trace."""
import json
import shutil

import pytest

from dspbench.harness import main as hm
from dspbench.harness import profile


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    dst = tmp_path / "dspbench"
    shutil.copytree(hm.BENCH_DIR, dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(hm, "BENCH_DIR", dst)
    return dst, json.loads((hm.ROOT / "BENCHMARK.json").read_text())


def test_new_cell_from_files_only(bench_copy):
    import torch
    dst, bench = bench_copy
    cfg = json.loads((dst / "configs" / "ddc64.json").read_text())
    cfg["name"] = "ddc64x"
    (dst / "configs" / "ddc64x.json").write_text(json.dumps(cfg))
    tr = json.loads((dst / "traffic" / "ddc64.stream.json").read_text())
    tr.update(channels=8, block_len=4096, check_spacing=2, check_blocks=2)
    (dst / "traffic" / "ddc64x.short.json").write_text(json.dumps(tr))
    (dst / "metrics" / "blocks_per_window.py").write_text(
        "def read(ctx):\n    return len(ctx.latency_s)\n")
    bench["configs"].append(dict(bench["configs"][0], name="ddc64x",
                                 file="dspbench/configs/ddc64x.json"))
    bench["workloads"].append({"name": "ddc64x.short", "config": "ddc64x",
                               "traffic": "ddc64x.short", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "blocks_per_window", "unit": "blocks",
                               "better": "higher", "source": "host_clock",
                               "layer": "runtime", "moves": "msps",
                               "workloads": ["ddc64x.short"]})
    cell, c, t = hm.cell_spec(bench, "ddc64x.short")
    assert c["name"] == "ddc64x" and t["block_len"] == 4096
    got = [m["name"] for m in hm._cell_metrics(bench, cell, "per_layer")]
    assert "blocks_per_window" in got
    assert hm.load_reader("blocks_per_window")(
        hm.Context(None, [1e-3], [2e-3, 2e-3], 1.0, {})) == 2
    res, _ = hm.run_cell("ddc64x.short", 5, 0.3, 0, device=torch.device(
        "cpu"), bench=bench)
    assert res["correct"] and res["metrics"]["msps"]["value"] > 0


def test_missing_names_are_refused(bench_copy):
    _, bench = bench_copy
    with pytest.raises(hm.RunError):
        hm.cell_spec(bench, "no.such.cell")
    bench["workloads"].append({"name": "x.y", "config": "nothing",
                               "traffic": "nothing", "chips": 1, "why": "-"})
    with pytest.raises(hm.RunError):
        hm.cell_spec(bench, "x.y")


def _trace():
    """Two blocks: in each, an enqueue span [0, 1) ms with two kernels
    after it, then the wait; times in seconds."""
    dev, spans = [], []
    for k in range(2):
        t = k * 10e-3
        spans += [("bench.enqueue", t, t + 1e-3),
                  ("bench.result_copy", t + 1e-3, t + 1.1e-3),
                  ("bench.consumer_wait", t + 1.1e-3, t + 9e-3)]
        dev += [("void mix_fir_decim_kernel<float>", t + 0.5e-3, t + 6.5e-3),
                ("elementwise", t + 6.5e-3, t + 7e-3)]
    return profile.Trace(2, dev, spans, 0)


def test_readers_on_a_trace():
    tr = _trace()
    shapes = {"mix_fir_decim": {"rows": 64, "samples": 1 << 20,
                                "taps": 144, "down": 2}}
    # a window of 100 blocks in 1 s, each with 6.5 ms of device work
    ctx = hm.Context(tr, [1e-4, 3e-4], [5e-3] * 100, 1.0, shapes)
    read = hm.load_reader
    assert read("runner_enqueue_ms")(ctx) == pytest.approx(0.2)
    assert read("device_ops_per_block")(ctx) == 2
    # the traced window 0 .. 19 ms, busy 2 x 6.5 ms
    assert read("device_idle_pct")(ctx) == pytest.approx(
        100 * (1 - 13e-3 / 19e-3))
    assert profile.busy_s(tr) == pytest.approx(13e-3)
    assert profile.window(tr) == pytest.approx((0.0, 19e-3))
    bound = hm.bound_s(2 * 64 * (1 << 20) * 4 + 2 * 64 * (1 << 19) * 4,
                       64 * (1 << 19) * 144 * 4 + 64 * (1 << 20) * 6)[0]
    assert read("mix_fir_decim.roofline_pct")(ctx) == pytest.approx(
        100 * bound * 2 / 12e-3)
    gaps = dict(profile.idle_gaps(tr))
    assert set(gaps) <= {"enqueue", "consumer_wait", "result_copy", "host"}
    assert gaps["consumer_wait"] == pytest.approx(2e-3)
