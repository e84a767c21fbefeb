"""The `ddc` system: the port's headline down-converter, built as its
users build it, `planar(kernel_fuse(fuse(chain(nco, firfilt..., msresamp))))`,
and fed through the production loop `runtime.StreamRunner` one block of
(re, im) float32 planes [2, B, T] at a time.  A block's results are its
output planes on the device, ready by a CUDA event.

Input: a ring of R distinct blocks of one circular stream, made on the
card from the seed (white noise plus a tone a channel), so that each
block is read from device memory as a live stream's would be.

Correct: after the window, a sample of the window's blocks drawn from
the seed, with its last block, is held against the float64 reference
(`reference/ddc.py`), which recomputes each block from the stream and
its absolute start.  Two errors are judged apart.  The mixer's phase:
the NCO carries its phase from block to block in float32, so the
program's outputs turn slowly against the reference; the angle by which
a block is turned is fitted over the block, and its growth from the
first held block to the last, per block between them, is
`nco_drift_rad`.  The arithmetic: each held block turned back by its own
angle, its rms error and its largest error over the reference's rms,
the worst held block's (`ddc_rms_err`, `ddc_max_err`).  Neither grows
with the number of blocks a window completes.
"""
from __future__ import annotations

import numpy as np

from ..harness.devices import event

__all__ = ["build"]


def build(torch, cfg, traffic, seed, device, variant="program"):
    return DDC(torch, cfg, traffic, seed, device, variant)


class DDC:
    def __init__(self, torch, cfg, traffic, seed, device, variant):
        from liquid_dsp_tpu_torch import chain, fuse, kernel_fuse, planar
        from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
        from liquid_dsp_tpu_torch.ops.fir import firfilt
        from liquid_dsp_tpu_torch.ops.nco import nco
        from liquid_dsp_tpu_torch.ops.resample import msresamp
        from liquid_dsp_tpu_torch.runtime import StreamRunner
        self.torch, self.cfg, self.traffic = torch, cfg, traffic
        self.device, self.variant = device, variant
        B, T, R = (traffic["channels"], traffic["block_len"],
                   traffic["ring_blocks"])
        self.B, self.T, self.R = B, T, R
        self.block_samples = B * T
        stages = chain(
            nco(dphi=cfg["nco"]["dphi"], direction=cfg["nco"]["direction"]),
            *[firfilt(firdes_kaiser(f["n"], f["fc"], f["as_db"]))
              for f in cfg["fir"]],
            msresamp(cfg["msresamp"]["rate"], cfg["msresamp"]["as_db"]))
        # the program's own bfloat16 path: bfloat16 planes in and out
        bf16 = variant == "control:bf16"
        proc = planar(kernel_fuse(fuse(stages),
                                  out_dtype="input" if bf16 else None))
        self.runner = StreamRunner(proc, batch_shape=(B,), device=device)
        self._carry0 = self.runner.carry
        self.ring = self._make_ring(seed)
        # what the runner is fed; the reference always reads `ring`
        self.feed = self.ring.to(torch.bfloat16) if bf16 else self.ring
        self._fault = variant if variant.startswith("fault:") else None
        rng = np.random.default_rng([seed, 1])
        # window blocks whose outputs are held: the first, then seeded
        # gaps; the last window block is held as well
        gaps = rng.integers(1, 2 * traffic["check_spacing"],
                            traffic["check_blocks"] - 1)
        self.check_at = set(np.concatenate([[0], np.cumsum(gaps)]).tolist())
        self.kept, self.last, self.window0 = {}, None, None

    def _make_ring(self, seed):
        """[R, 2, B, T] float32: unit-power complex white noise plus, on
        each channel, a tone of seeded amplitude, frequency and phase."""
        torch, tr = self.torch, self.traffic
        B, T, R = self.B, self.T, self.R
        rng = np.random.default_rng([seed, 0])
        amp = rng.uniform(*tr["tone_amplitude"], B)
        freq = rng.uniform(-0.5, 0.5, B)
        phase = rng.uniform(0, 2 * np.pi, B)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) % (1 << 63))
        ring = torch.empty((R, 2, B, T), dtype=torch.float32,
                           device=self.device)
        ring.normal_(0.0, float(np.sqrt(0.5)), generator=gen)
        f = torch.as_tensor(freq, dtype=torch.float64, device=self.device)
        a = torch.as_tensor(amp, dtype=torch.float64, device=self.device)
        p = torch.as_tensor(phase, dtype=torch.float64, device=self.device)
        for k in range(R):
            n = torch.arange(k * T, (k + 1) * T, dtype=torch.float64,
                             device=self.device)
            arg = torch.remainder(2 * np.pi * f[:, None] * n + p[:, None],
                                  2 * np.pi)
            ring[k, 0] += (a[:, None] * torch.cos(arg)).float()
            ring[k, 1] += (a[:, None] * torch.sin(arg)).float()
        return ring

    def warm_allocator(self):
        """Cache the device memory of the held outputs now, so that no
        allocation of the window calls cudaMalloc."""
        torch = self.torch
        dt = (torch.bfloat16 if self.variant == "control:bf16"
              else torch.float32)
        n = 2 * (self.traffic["check_blocks"] + 2)      # two planes each
        down = round(1 / self.cfg["msresamp"]["rate"])
        bufs = [torch.empty((self.B, self.T // down), dtype=dt,
                            device=self.device) for _ in range(n)]
        del bufs

    def block(self, g):
        return self.feed[g % self.R]

    def after(self, g, out):
        if self._fault:
            with self.torch.inference_mode():
                out = self._plant(out)
        return event(self.torch, self.device), out

    def wait(self, handle):
        handle[0].synchronize()

    def consume(self, g, handle):
        if self.window0 is None:
            return
        k = g - self.window0
        if k in self.check_at:
            self.kept[g] = handle[1]
        self.last = (g, handle[1])

    def start_window(self, g):
        self.window0 = g

    def stop_window(self):
        if self.last is not None:
            self.kept[self.last[0]] = self.last[1]
        self.window0 = None

    def _plant(self, out):
        """A fault under the timed path, for the harness's own tests."""
        yr, yi = out
        if self._fault == "fault:state":
            self.runner.carry = self._carry0
        elif self._fault == "fault:half":
            yr[self.B // 2:] = 0
            yi[self.B // 2:] = 0
        elif self._fault == "fault:answer":
            yr[0, 100] += 1.0
        return out

    def release(self):
        """Free the program's state before the reference runs."""
        self.runner = None

    def check(self, limits):
        """{name: (value, limit)} and (attempted, failed) of the held
        blocks against the float64 reference.  With the variant
        "control", the reference in TF32 (`DDCReference(tf32=True)`)
        takes the program's place at the same blocks."""
        from ..reference.ddc import DDCReference
        torch = self.torch
        ref = DDCReference(self.cfg)
        H = -(-ref.halo // 256) * 256
        worst_rms, worst_max, failed, angle, rms_at = 0.0, 0.0, 0, {}, {}
        for g in sorted(self.kept):
            cur = self.ring[g % self.R].double()
            prev = (self.ring[(g - 1) % self.R, :, :, -H:].double() if g
                    else torch.zeros_like(cur[..., :H]))
            x = torch.cat([prev, cur], dim=-1)
            rr, ri = ref(x[0], x[1], g * self.T, self.T)
            if self.variant == "control":
                yr, yi = DDCReference(self.cfg, tf32=True)(
                    x[0], x[1], g * self.T, self.T, dtype=torch.float32)
            else:
                yr, yi = self.kept[g]
            yr, yi = yr.double(), yi.double()
            # the angle that turns the reference onto the block
            a = float(torch.atan2((yi * rr - yr * ri).sum(),
                                  (yr * rr + yi * ri).sum()))
            c, s = np.cos(a), np.sin(a)
            dr = yr * c + yi * s - rr
            di = yi * c - yr * s - ri
            rms = float(torch.sqrt((rr * rr + ri * ri).mean()))
            e_rms = float(torch.sqrt((dr * dr + di * di).mean())) / rms
            e_max = float(torch.sqrt(dr * dr + di * di).max()) / rms
            del x, rr, ri, yr, yi, dr, di
            angle[g], rms_at[g] = a, e_rms
            worst_rms, worst_max = max(worst_rms, e_rms), max(worst_max, e_max)
            failed += int(not (e_rms <= limits["ddc_rms_err"]
                               and e_max <= limits["ddc_max_err"]))
        g0, g1 = min(angle), max(angle)
        turn = np.angle(np.exp(1j * (angle[g1] - angle[g0])))
        drift = abs(float(turn)) / max(g1 - g0, 1)
        checks = {"ddc_rms_err": (worst_rms, limits["ddc_rms_err"]),
                  "ddc_max_err": (worst_max, limits["ddc_max_err"]),
                  "nco_drift_rad": (drift, limits["nco_drift_rad"]),
                  "blocks_compared": (len(self.kept), None)}
        self.readings = {"angle_rad": {str(g): a for g, a in angle.items()},
                         "rms_err": {str(g): e for g, e in rms_at.items()}}
        return checks, failed

    def shapes(self):
        """What the metric readers need of this cell's work: the fused
        mixer and FIR's rows, samples, taps and decimation, from the
        configuration's designs (the cascade's halo plus one tap)."""
        from ..reference.ddc import DDCReference
        ref = DDCReference(self.cfg)
        return {"mix_fir_decim": {"rows": self.B, "samples": self.T,
                                  "taps": ref.halo + 1, "down": ref.down}}
