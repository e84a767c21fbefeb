#!/usr/bin/env python3
"""Times of the port's `agc_scan` and `codebook_argmax` kernels on one CUDA
card, and of the two steps they serve, for a checkout given by --root:

    python3 chip_kernel_bench.py [--root DIR] [--tag NAME] [--no-steps] [--sass DIR]
    python3 chip_kernel_bench.py --ffma-rate

With two checkouts (this one and, say, `git archive` of its parent unpacked
into a directory that .gitignore lists) run it in turns, one after the other,
on one card: parent, change, change, parent.  It uses only what both
checkouts have: the two wrappers with their plain versions, and the stream
makers, the timer and the profiler table of that checkout's chip_smoke.py.

  * codebook_argmax at the receiver's shape, 153,600 x 24 x 4096 (golay2412;
    normal soft bits from a seed), indices against the plain version; the
    same with the codebook's columns sorted by their masks, where aligned
    groups of 4 columns share their first 10 positions (a wrapper that
    sorts them itself takes the same time for both);
  * agc_scan at the tracker's shape, 256 x 32768 (alpha 0.02), unlocked
    and locked, and against the plain version over 256 samples;
  * unless --no-steps: the symtrack_stream step at 256 x 32768 and the
    framesync64_stream_full step at 128 x 32768, each timed (CUDA events)
    and under torch.profiler (device time by kernel);
  * with --sass DIR: cuobjdump's SASS of the two kernels into
    DIR/sass_<tag>.txt.

With --ffma-rate it measures instead what the float32 bound of
codebook_argmax rests on: the card's rate of float32 multiply-adds per
clock and SM sub-partition (the data sheet's 67 TFLOP/s is 1.0 at
1.98 GHz) in a loop of independent `acc[k] = fma(a, b, acc[k])` where two,
one or none of the three register operands repeat from the instruction
before, at 4 to 32 warps per SM.

Every line names the card and its power limit.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np


FFMA_RATE_SRC = r"""
#include <cuda_runtime.h>
// REPEAT 2: acc[k] = fma(a, b, acc[k]); 1: fma(a, b[k], acc[k]);
// 0: fma(a[k'], b[k''], acc[k])
constexpr int NACC = 16;
extern "C" __global__ void __launch_bounds__(128)
ffma_rate(const float* __restrict__ in, float* __restrict__ out, int iters) {
  float a[NACC], b[NACC], acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    a[k] = in[threadIdx.x + k];
    b[k] = in[threadIdx.x + 64 + k];
    acc[k] = in[threadIdx.x + 128 + k];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int k = 0; k < NACC; ++k) {
#if REPEAT == 2
        acc[k] = __fmaf_rn(a[0], b[0], acc[k]);
#elif REPEAT == 1
        acc[k] = __fmaf_rn(a[u & 1], b[k], acc[k]);
#else
        acc[k] = __fmaf_rn(a[(k + u) % NACC], b[(k + 3 * u + 1) % NACC], acc[k]);
#endif
      }
    }
  }
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < NACC; ++k) t += acc[k];
  out[blockIdx.x * 128 + threadIdx.x] = t;
}
extern "C" int ffma_rate_launch(const void* in, void* out, int blocks,
                                int iters, void* stream) {
  ffma_rate<<<blocks, 128, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, iters);
  return (int)cudaGetLastError();
}
"""
SM_CLOCK_HZ = 1.98e9     # H100 SXM boost clock: 67 TFLOP/s = 132*128*2*1.98e9
SUBPARTITIONS = 132 * 4


def ffma_rate(torch, cs, build, tag):
    """Float32 multiply-adds per clock and SM sub-partition by how many
    register operands repeat (see the module's note)."""
    import ctypes
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "ffma_rate.cu"
    src.write_text(FFMA_RATE_SRC)
    dev = torch.device("cuda")
    inp = torch.rand(1024, device=dev) * 1e-3
    iters, nacc = 2000, 16
    for repeat in (2, 1, 0):
        so = build.BUILD_DIR / f"ffma_rate_{repeat}.so"
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-DREPEAT={repeat}",
                        "-shared", "-o", str(so), str(src)], check=True,
                       capture_output=True, text=True)
        fn = ctypes.CDLL(str(so)).ffma_rate_launch
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rates = []
        for warps in (4, 8, 16, 32):
            blocks = 132 * warps // 4
            out = torch.empty(blocks * 128, device=dev)

            def run():
                rc = fn(inp.data_ptr(), out.data_ptr(), blocks, iters,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"ffma_rate launch failed: {rc}")

            ms = cs.time_ms(run, iters=5)
            n = blocks * 4 * iters * 8 * nacc       # warp instructions
            rates.append(f"{warps} warps/SM "
                         f"{n / (ms * 1e-3) / (SUBPARTITIONS * SM_CLOCK_HZ):.3f}")
        print(f"{tag} float32 multiply-adds per clock and sub-partition, "
              f"{repeat} of 3 register operands repeating: "
              + "; ".join(rates), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--no-steps", action="store_true")
    ap.add_argument("--sass", metavar="DIR")
    ap.add_argument("--ffma-rate", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_kernel_bench: needs one CUDA card")
    import chip_smoke as cs
    from liquid_dsp_tpu_torch.fec.device import block_codebook
    from liquid_dsp_tpu_torch.ops.kernels import build
    from liquid_dsp_tpu_torch.ops.kernels.agc_scan import (
        agc_scan, agc_scan_reference)
    from liquid_dsp_tpu_torch.ops.kernels.codebook_argmax import (
        codebook_argmax, codebook_argmax_reference, pack_codebook)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    tag = f"[{args.tag}] ({card})"
    if args.ffma_rate:
        ffma_rate(torch, cs, build, tag)
        return
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    log = lib.with_suffix(".log").read_text().splitlines()
    print(f"{tag} built {root} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for k, ln in enumerate(log):
        if "Compiling entry" in ln and ("agc_scan" in ln or "codebook" in ln):
            used = [u.strip() for u in log[k + 1:k + 4]
                    if "registers" in u or "spill" in u]
            print(f"{tag} ptxas {ln.split('function')[-1].strip()}: "
                  f"{' | '.join(used)}", flush=True)

    # codebook_argmax at the receiver's shape
    bip_np, n, _ = block_codebook("golay2412")
    bip = torch.from_numpy(bip_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cw = torch.randn(153600, n, generator=gen, device=dev)
    want = codebook_argmax_reference(cw, bip)
    got = codebook_argmax(cw, bip)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    k1 = cs.time_ms(lambda: codebook_argmax(cw, bip))
    k2 = cs.time_ms(lambda: codebook_argmax(cw, bip))
    print(f"{tag} codebook_argmax {cw.shape[0]} x {n} x {bip.shape[1]}: "
          f"{k1:.4f}, {k2:.4f} ms; indices equal to the plain version: {same}",
          flush=True)
    masks = pack_codebook(bip).cpu().numpy().view(np.uint32)
    order = torch.from_numpy(np.argsort(masks, kind="stable")).to(dev)
    bip_s = bip[:, order].contiguous()
    got_s = codebook_argmax(cw, bip_s)
    same_s = bool(torch.equal(got_s, codebook_argmax_reference(cw, bip_s)))
    s1 = cs.time_ms(lambda: codebook_argmax(cw, bip_s))
    s2 = cs.time_ms(lambda: codebook_argmax(cw, bip_s))
    print(f"{tag} codebook_argmax, columns sorted by mask: {s1:.4f}, "
          f"{s2:.4f} ms; indices equal to the plain version: {same_s}",
          flush=True)

    # agc_scan at the tracker's shape
    B, T = 256, 1 << 15
    x = torch.randn(B, T, generator=gen, device=dev) * torch.logspace(
        -1.5, 0.5, B, device=dev)[:, None]
    p = (x * x).contiguous()
    g0 = torch.ones(B, device=dev)
    y0 = torch.ones(B, device=dev)
    a = agc_scan(p[:, :256].contiguous(), g0, y0, alpha=0.02)
    b = agc_scan_reference(p[:, :256].contiguous(), g0, y0, alpha=0.02)
    torch.cuda.synchronize()
    equal = all(torch.equal(u, v) for u, v in zip(a, b))
    err = float((a[0] - b[0]).abs().max() / b[0].square().mean().sqrt())
    a1 = cs.time_ms(lambda: agc_scan(p, g0, y0, alpha=0.02), iters=5)
    a2 = cs.time_ms(lambda: agc_scan(p, g0, y0, alpha=0.02), iters=5)
    al = cs.time_ms(lambda: agc_scan(p, g0, y0, alpha=0.02, locked=True),
                    iters=5)
    print(f"{tag} agc_scan {B} x {T}: {a1:.4f}, {a2:.4f} ms "
          f"({a1 * 1e6 / T:.1f} ns per sample); locked {al:.4f} ms; "
          f"256 samples against the plain version: bit-equal {equal}, "
          f"max|err|/rms {err:.3e}", flush=True)

    if args.sass:
        out = os.path.abspath(args.sass)
        os.makedirs(out, exist_ok=True)
        nvcc_dir = os.path.dirname(build._nvcc())
        sass = subprocess.run([os.path.join(nvcc_dir, "cuobjdump"), "-sass",
                               str(lib)], capture_output=True, text=True,
                              timeout=600).stdout
        keep, on = [], False
        for ln in sass.splitlines():
            if "Function :" in ln:
                on = "agc_scan" in ln or ("codebook" in ln and "Li24E" in ln)
            if on:
                keep.append(ln)
        path = os.path.join(out, f"sass_{args.tag}.txt")
        with open(path, "w") as f:
            f.write("\n".join(keep))
        print(f"{tag} SASS of agc_scan and codebook_argmax<24>: {path} "
              f"({len(keep)} lines)", flush=True)

    if args.no_steps:
        return
    from liquid_dsp_tpu_torch.framing.frame64 import framesync64_stream_full
    from liquid_dsp_tpu_torch.framing.symtrack import symtrack_stream
    # the tracker step
    xt, _ = cs.make_timing_stream(np.random.default_rng(11), B, 2 * T, 7,
                                  20.0, True)
    xt = torch.from_numpy(xt).to(dev)
    st = symtrack_stream(ms="qpsk").to(dev)
    _, c1 = st(st.init(batch_shape=(B,), device=dev), xt[:, :T])
    blk = xt[:, T:]
    t1 = cs.time_ms(lambda: st(c1, blk), iters=3)
    t2 = cs.time_ms(lambda: st(c1, blk), iters=3)
    print(f"{tag} symtrack_stream step {B} x {T}: {t1:.4f}, {t2:.4f} ms",
          flush=True)
    cs.profile_steps(torch, f"{args.tag}; {card}", lambda: st(c1, blk), 3,
                     f"symtrack_stream step at {B}x{T}")
    del xt, blk
    # the receiver step
    xr, _ = cs.make_rx_stream(np.random.default_rng(7))
    xr = torch.from_numpy(xr).to(dev)
    rx = framesync64_stream_full(cs.RX_T).to(dev)
    _, r1 = rx(rx.init(batch_shape=(cs.RX_B,), device=dev), xr[:, :cs.RX_T])
    rblk = xr[:, cs.RX_T:2 * cs.RX_T]
    r_1 = cs.time_ms(lambda: rx(r1, rblk), iters=10)
    r_2 = cs.time_ms(lambda: rx(r1, rblk), iters=10)
    print(f"{tag} framesync64_stream_full step {cs.RX_B} x {cs.RX_T}: "
          f"{r_1:.4f}, {r_2:.4f} ms", flush=True)
    cs.profile_steps(torch, f"{args.tag}; {card}", lambda: rx(r1, rblk), 3,
                     f"framesync64_stream_full step at {cs.RX_B}x{cs.RX_T}")


if __name__ == "__main__":
    main()
