"""What a run loads: neither JAX nor the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's); and
the references load nothing of the program."""
import subprocess
import sys

from dspbench.harness import main as hm

FORBIDDEN = ("jax", "jaxlib", "flax", "liquid_dsp_tpu")


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split"
         "('.')[0] for m in sys.modules}))"], capture_output=True,
        text=True, cwd=hm.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_references_load_nothing_of_the_program():
    top = _modules_after(
        "import dspbench.reference.ddc, dspbench.reference.designs")
    assert not top & set(FORBIDDEN + ("liquid_dsp_tpu_torch",))


def test_a_run_loads_no_jax():
    top = _modules_after(
        "import pytest\n"
        "from dspbench.tests.tiny import run_tiny\n"
        "mp = pytest.MonkeyPatch()\n"
        "assert run_tiny(mp, 'ddc64.stream', seconds=0.2)[0]['correct']\n")
    assert "liquid_dsp_tpu_torch" in top
    assert not top & set(FORBIDDEN)
