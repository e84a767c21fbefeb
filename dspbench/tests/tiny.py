"""A cell at a tiny shape on the CPU: the harness's own path with the
look for a card skipped (`run_cell(device=...)`)."""
import json

import torch

from dspbench.harness import main as hm

TINY = {"ddc64.stream": {"channels": 8, "block_len": 8192,
                         "check_spacing": 3, "check_blocks": 3}}


def bench():
    return json.loads((hm.ROOT / "BENCHMARK.json").read_text())


def run_tiny(monkeypatch, workload, variant="program", seconds=0.5,
             seed=2**33 + 17, device="cpu"):
    orig = hm.load_named

    def small(folder, name):
        d = orig(folder, name)
        if folder == "traffic":
            d.update(TINY.get(name, {}))
        return d

    monkeypatch.setattr(hm, "load_named", small)
    return hm.run_cell(workload, seed, seconds, 0, variant,
                       device=torch.device(device), bench=bench())
