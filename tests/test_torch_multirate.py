"""Port parity for the two multi-rate paths, composed through the public
API in both packages at B = 8, T = 4096, over 3 carried blocks:

* receive: ``chain(kernel_fuse(fuse(chain(nco(0.125, "down"),
  firfilt(kaiser 64), firdecim(4, kaiser 48)))), msresamp(0.375))``: the
  mixer and the fused 111-tap FIR at down 4 in one kernel (the JAX
  package's Pallas kernel in interpret mode, the port's plain version),
  then a halfband decimator, its zeta and resamp(3/4)
  (4096 -> 1024 -> 512 -> 384 per block);
* transmit: ``chain(firinterp(2, rrcos(2, 7, 0.35)), msresamp(2.5),
  nco(0.125, "up"))``: a 29-tap pulse shaper, resamp(5/4), a halfband
  interpolator and the up-mix (4096 symbols -> 20480 samples).

Tolerance: 2e-4 max|err|/rms, the reference's bound for the kernel
(tests/test_pallas_chain.py:49)."""
import numpy as np
import pytest

import _torch_port as tp
import liquid_dsp_tpu as J
import liquid_dsp_tpu_torch as P
from liquid_dsp_tpu.design.windows import kaiser
from liquid_dsp_tpu.ops import fir as jfir
from liquid_dsp_tpu.ops import nco as jnco
from liquid_dsp_tpu.ops import resample as jresample
from liquid_dsp_tpu_torch.convert import carry_from_numpy, load_jax_params
from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser, firdes_rrcos
from liquid_dsp_tpu_torch.ops import fir, nco, resample

from test_resample import spectral_peak_and_sidelobe

B, T = 8, 4096
TOL = 2e-4
JAX = {"nco": jnco, "fir": jfir, "resample": jresample, "c": J}
PORT = {"nco": nco, "fir": fir, "resample": resample, "c": P}


def multirate_rx(m):
    front = m["c"].kernel_fuse(m["c"].fuse(m["c"].chain(
        m["nco"].nco(dphi=0.125, direction="down"),
        m["fir"].firfilt(firdes_kaiser(64, 0.2, 60.0)),
        m["fir"].firdecim(4, firdes_kaiser(48, 0.1, 60.0)))))
    return m["c"].chain(front, m["resample"].msresamp(0.375))


def multirate_tx(m):
    return m["c"].chain(m["fir"].firinterp(2, firdes_rrcos(2, 7, 0.35)),
                        m["resample"].msresamp(2.5),
                        m["nco"].nco(dphi=0.125, direction="up"))


def test_rx_front_is_one_kernel_at_down_4():
    p = multirate_rx(PORT)
    front = p.stages[0]
    assert type(front).__name__ == "MixFIRDecim"
    assert front.down == 4 and front.taps.numel() == 111
    assert p.rate == (3, 32)
    jf = J.fuse(J.chain(jnco.nco(dphi=0.125, direction="down"),
                        jfir.firfilt(firdes_kaiser(64, 0.2, 60.0)),
                        jfir.firdecim(4, firdes_kaiser(48, 0.1, 60.0))))
    np.testing.assert_array_equal(front.taps.numpy(),
                                  jf.children[-1].lti.taps)


def _qpsk(rng, shape):
    s = (rng.integers(0, 2, shape) * 2 - 1) + 1j * (
        rng.integers(0, 2, shape) * 2 - 1)
    return (s / np.sqrt(2)).astype(np.complex64)


@pytest.mark.parametrize("path", ["rx", "tx"])
def test_path_matches_jax(path):
    rng = np.random.default_rng(12 if path == "rx" else 13)
    make = multirate_rx if path == "rx" else multirate_tx
    jp, p = make(JAX), make(PORT)
    load_jax_params(p, tp.jax_params(jp))
    blocks = [tp.cnoise(rng, (B, T)) if path == "rx" else _qpsk(rng, (B, T))
              for _ in range(3)]
    yj, _ = tp.run_jax(jp, blocks, (B,))
    yt, _ = tp.run_torch(p, blocks, (B,))
    n_out = {"rx": 3 * T * 3 // 32, "tx": 3 * T * 5}[path]
    assert yt.shape == yj.shape == (B, n_out)
    assert np.isfinite(yt).all()
    assert tp.rel_err(yt, yj) < TOL
    # the JAX carry after block 0 handed to the port for blocks 1-2
    _, cj0 = tp.run_jax(jp, blocks[:1], (B,))
    y12, _ = tp.run_torch(p, blocks[1:], (B,),
                          carry=carry_from_numpy(tp.to_numpy(cj0)))
    assert tp.rel_err(y12, yj[..., n_out // 3:]) < TOL


def test_rx_tone_lands_at_its_offset():
    # a tone 0.02 cycles/sample above the mixer's 0.125 rad/sample lands
    # at 0.02 * 32/3 cycles per output sample, everything else 40 dB down
    fx, n = 0.02, 4 * T
    t = np.arange(n)
    x = np.exp(1j * (0.125 * t + 2 * np.pi * fx * t)).astype(np.complex64)
    p = multirate_rx(PORT)
    y, _ = tp.run_torch(p, np.split(np.repeat(x[None], B, 0), 4, axis=-1),
                        (B,))
    y = y[0, 64:]
    fpeak, side = spectral_peak_and_sidelobe(y * kaiser(len(y), 10.0),
                                             main_lobe_width=0.07)
    assert abs(fpeak - fx * 32 / 3) < 0.02
    assert side < -40
