"""The reference C library's flexframe goldens
(tests/golden/flexframe_golden.npz): which frames they are and the bytes
its generator (tools/gen_flexframe_golden.py) filled them with.

Numpy only, so that the CPU tests, the card tests and chip_smoke.py
(the last two run where JAX is not installed) share one copy."""
import numpy as np

# (frame, payload length, seed): the header is lcg_bytes(14, seed), the
# payload lcg_bytes(n, seed + 1)
FLEX_GOLDEN = (("ffg_a", 64, 21), ("ffg_b", 40, 33), ("ffg_c", 100, 55))


def lcg_bytes(n, seed):
    """The generator's byte stream: bits 16-23 of a 32-bit LCG."""
    s, out = seed, []
    for _ in range(n):
        s = (s * 1103515245 + 12345) & 0xFFFFFFFF
        out.append((s >> 16) & 0xFF)
    return np.asarray(out, np.uint8)
