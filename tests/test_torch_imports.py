"""Guards for the PyTorch port's boundary: liquid_dsp_tpu_torch imports
torch and never jax or the JAX package, every module imports with no
triton, no nvcc and no CUDA (kernels build on first use), and
chip_smoke.py fails rather than skips without a card."""
import pathlib
import re
import shutil
import subprocess
import sys

import _torch_port  # noqa: F401  (torch thread cap)

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import liquid_dsp_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import torch
from liquid_dsp_tpu_torch.ops.kernels import build
print(json.dumps({
    "built": build.load_library.cache_info().currsize,
    "modules": mods,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "reference": sorted(m for m in sys.modules if m == "liquid_dsp_tpu"
                        or m.startswith("liquid_dsp_tpu.")),
    "triton": "triton" in sys.modules,
    "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_port_never_imports_jax_or_the_reference():
    import json
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("ops.kernels.mix_fir_decim", "ops.kernels.codebook_argmax",
                "ops.kernels.fir_real", "convert", "utils.sequence",
                "design.firdes", "modem.linear", "fec.crc", "fec.interleave",
                "fec.block", "fec.dispatch", "fec.packetizer", "fec.device",
                "framing.qpacket", "framing.stream_rx", "framing.detector",
                "framing.frame64", "ops.kernels.symsync_scan",
                "ops.kernels.agc_scan", "ops.kernels.pll_lms", "ops.symsync",
                "ops.agc", "ops.equalize", "framing.symtrack", "debug",
                "multichannel.ofdm", "framing.ofdmflexframe",
                "framing.ofdmflex_stream", "framing.sources"):
        assert "liquid_dsp_tpu_torch." + mod in got["modules"], mod
    assert got["jax"] == [] and got["reference"] == []
    assert not got["triton"] and not got["cuda_initialized"]
    assert got["built"] == 0          # no kernel library loaded


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    imported = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert "liquid_dsp_tpu_torch" in imported
    assert not [m for m in imported if m.split(".")[0] in
                ("jax", "jaxlib", "liquid_dsp_tpu")]


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    # this machine has no CUDA card: the script must fail, and print no
    # result line
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
