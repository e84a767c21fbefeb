"""Entry point of the benchmark of liquid_dsp_tpu_torch; see
dspbench/harness/main.py.

    python3 dspbench/run.py --workload ddc64.stream --seed 7 --seconds 20 --trace 0
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from dspbench.harness.main import main
    sys.exit(main(t_start=T_START))
