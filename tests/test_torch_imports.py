"""Guards for the PyTorch port's boundary: liquid_dsp_tpu_torch imports
torch and never jax or the JAX package, every module imports with no
triton, no nvcc and no CUDA (kernels build on first use), and
chip_smoke.py fails rather than skips without a card."""
import ast
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

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
                "framing.ofdmflex_stream", "framing.sources",
                "design.firdespm", "design.special", "ops.resample",
                "design.iirdes", "ops.iir", "ops.misc_filters", "ops.channel",
                "modem.analog", "ops.kernels.iir_scan",
                "ops.kernels.iir_block_state", "fec.rs", "fec.ldpc", "io",
                "runtime", "compat", "utils.audio", "utils.bits",
                "utils.buffer", "utils.checkpoint", "utils.matrix",
                "utils.optim", "utils.poly", "utils.quantization",
                "ops.kernels.cvsd_scan", "ops.kernels.eqlms_scan",
                "ops.kernels.eqrls_scan", "ops.kernels.symsync_pll_lms",
                "ops.kernels.branch_bank", "ops.kernels.suppress_scan",
                "ops.kernels.ldpc_bp", "ops.kernels.iir_pscan",
                "parallel", "parallel.mesh",
                "parallel.stream", "parallel.rx", "parallel.pipeline"):
        assert "liquid_dsp_tpu_torch." + mod in got["modules"], mod
    assert got["jax"] == [] and got["reference"] == []
    assert not got["triton"] and not got["cuda_initialized"]
    assert got["built"] == 0          # no kernel library loaded


def _public_defs(path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


@pytest.mark.parametrize("module", ["ops/fir.py", "ops/resample.py",
                                    "ops/nco.py", "ops/dotprod.py",
                                    "design/firdes.py", "design/special.py",
                                    "design/firdespm.py", "design/iirdes.py",
                                    "ops/iir.py", "ops/misc_filters.py",
                                    "ops/channel.py", "modem/analog.py",
                                    "fec/rs.py", "fec/ldpc.py", "io.py",
                                    "runtime.py", "compat.py",
                                    "fec/packetizer.py", "utils/audio.py",
                                    "utils/bits.py", "utils/buffer.py",
                                    "utils/checkpoint.py", "utils/matrix.py",
                                    "utils/optim.py", "utils/poly.py",
                                    "utils/quantization.py"])
def test_port_module_defines_every_public_name(module):
    # a diff of the top-level def/class names: the port's module is a
    # superset of the JAX package's
    missing = (_public_defs(ROOT / "liquid_dsp_tpu" / module)
               - _public_defs(ROOT / "liquid_dsp_tpu_torch" / module))
    assert not missing, sorted(missing)


_NO_JAX = """
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "liquid_dsp_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import liquid_dsp_tpu_torch.compat as c
names = {}
for n in dir(c):
    if not n.startswith("_"):
        o = getattr(c, n)
        names[n] = getattr(o, "__module__", None) or ""
print(json.dumps(names))
"""


def test_compat_has_every_name_of_the_jax_shim():
    # compat's names are module-level assignments and generated aliases,
    # not only defs: the port's module is imported in a process where jax
    # cannot be imported, and its dir() compared with the JAX shim's
    import json
    import liquid_dsp_tpu.compat as jcompat
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = {n for n in dir(jcompat) if not n.startswith("_")}
    assert not want - set(got), sorted(want - set(got))
    # every alias resolves to the port (functions, classes, factories)
    foreign = {n: m for n, m in got.items()
               if m.startswith("liquid_dsp_tpu.") or m == "liquid_dsp_tpu"}
    assert not foreign, foreign
    assert got["firfilt_crcf_create"].startswith("liquid_dsp_tpu_torch")
    assert got["eqlms_cccf_create"].startswith("liquid_dsp_tpu_torch")


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
