"""Build and load the port's CUDA kernels.

The sources in ``liquid_dsp_tpu_torch/csrc/*.cu`` have plain C entry
points (no PyTorch headers), so nvcc builds them in seconds: one nvcc per
source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <src>.o csrc/<src>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib>.so *.o

The library lands in ``build/liquid_dsp_tpu_torch/`` at the repository
root, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as is.  nvcc's report (ptxas
registers, shared memory, spills) and each source's seconds are kept
beside it as ``<lib>.log``.
Nothing here runs at import time: the first kernel call builds.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

__all__ = ["build", "load_library", "NVCC_FLAGS"]

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "liquid_dsp_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong
# C signatures of the entry points in csrc/ (argtypes, restype)
_SIGNATURES = {
    "mix_fir_decim_launch": ([_P] * 10 + [_I] * 7 + [_F, _P], _I),
    "codebook_argmax_launch": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "fir_real_launch": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "symsync_scan_launch": ([_P] * 6 + [_I] * 7 + [_F] * 4 + [_P], _I),
    "agc_scan_launch": ([_P] * 4 + [_I] * 3 + [_F] * 3 + [_P], _I),
    "pll_lms_launch": ([_P] * 16 + [_I] * 9 + [_F] * 4 + [_P], _I),
    "symsync_pll_lms_launch": ([_P, _L, _L, _P, _I, _I] + [_P] * 18
                               + [_I] * 15 + [_F] * 8 + [_P], _I),
    "branch_bank_launch": ([_P] * 3 + [_I] * 5 + [_L] * 2 + [_P], _I),
    "viterbi_acs_launch": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "viterbi_acs_dec_smem_max": ([], _I),
    "iir_scan_launch": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "iir_block_state_launch": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "iir_pscan_launch": ([_P] * 5 + [_I] * 4 + [_P], _I),
    "cvsd_scan_launch": ([_P] * 2 + [_I] * 3 + [_U] + [_F] * 4 + [_P], _I),
    "eqlms_scan_launch": ([_P] * 7 + [_I] * 5 + [_F] * 2 + [_P], _I),
    "eqrls_scan_launch": ([_P] * 6 + [_I] * 4 + [_F] * 2 + [_P], _I),
    "suppress_scan_launch": ([_P] * 6 + [_I] * 6 + [_L, _P], _I),
    "ldpc_bp_launch": ([_P] * 11 + [_I] * 10 + [_F] * 4 + [_P], _I),
    "ldpc_bp_smem_bytes": ([_I] * 3, _L),
    "ldpc_bp_blocks": ([_I] * 5, _I),
    "ldpc_bp_smem_max": ([], _L),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([str(pathlib.Path(home) / "bin" / "nvcc")] if home else [])
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ on first use")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _compile(cmd):
    """(the finished nvcc process, its seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter() - t0


def build() -> pathlib.Path:
    """Compile csrc/*.cu into one shared library (once per source hash)
    and return its path: one nvcc per source, all at once, then a link.
    Raises with nvcc's output on failure."""
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(srcs + sorted(CSRC.glob("*.cuh"))):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    lib = BUILD_DIR / f"liquid_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # objects and the library under temporary names, then a rename: a
    # concurrent process never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in srcs:
            obj = os.path.join(tmpdir, src.stem + ".o")
            jobs.append((src, [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                         obj))
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            done = list(pool.map(lambda job: _compile(job[1]), jobs))
        log, failed = [], []
        for (src, cmd, _), (proc, secs) in zip(jobs, done):
            log.append(f"nvcc {src.name}: {secs:.1f} s\n{proc.stdout}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{proc.stdout}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *(o for _, _, o in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        lib.with_suffix(".log").write_text("".join(log))
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library with its entry points' C signatures set
    (every pointer and the stream as c_void_p); built and loaded once
    per process."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
