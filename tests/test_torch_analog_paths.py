"""Port parity for the two analog paths, composed through the public API in
both packages at B = 4, T = 1024, over 3 carried blocks:

* transmit: ``chain(freq_modulator(0.1), channel(...))``: a two-tone
  message (0.013 and 0.037 cycles/sample at 0.6 and 0.3, scaled per
  channel) FM-modulated, then 4 complex multipath taps and a carrier
  offset; the noise and the shadowing are off here, since the packages
  draw their randomness differently (tests/test_torch_channel.py holds
  those);
* receive: ``chain(iirfilt_sos(*iirdes_sos("butter", 7, 0.2)),
  freq_demodulator(0.1), iirdecim(4), iirfilt_dc_blocker(0.01))``
  (1024 -> 256 samples per block), on the port's transmit output.

Tolerances: transmit 1e-5 absolute at unit amplitude (the table gather is
exact, the multipath FIR and the mixer within float32 rounding); receive
1e-5 absolute on a message of amplitude ~1 (the demodulator's angle, then
float32 recurrences; the JAX package's block-versus-scan bound is 1e-4).
Both packages run their CPU routes (the scan backend, the kernels' plain
versions)."""
import numpy as np

import _torch_port as tp
import liquid_dsp_tpu as J
import liquid_dsp_tpu_torch as P
from liquid_dsp_tpu.design.iirdes import iirdes_sos
from liquid_dsp_tpu.modem import analog as janalog
from liquid_dsp_tpu.ops import channel as jchannel
from liquid_dsp_tpu.ops import iir as jiir
from liquid_dsp_tpu.ops import misc_filters as jmisc
from liquid_dsp_tpu_torch.convert import load_jax_params
from liquid_dsp_tpu_torch.modem import analog
from liquid_dsp_tpu_torch.ops import channel, iir, misc_filters

B, T, NBLK = 4, 1024, 3
TAPS = np.asarray([1.0, 0.12 - 0.05j, -0.06j, 0.03 + 0.02j], np.complex64)
JAX = {"c": J, "analog": janalog, "channel": jchannel, "iir": jiir,
       "misc": jmisc}
PORT = {"c": P, "analog": analog, "channel": channel, "iir": iir,
        "misc": misc_filters}


def analog_tx(m, noise=True):
    kw = dict(dphi=0.001, multipath_taps=TAPS)
    if noise:
        kw.update(snr_db=30.0, shadowing_std=1.0, shadowing_fd=0.001)
    return m["c"].chain(m["analog"].freq_modulator(0.1),
                        m["channel"].channel(**kw))


def analog_rx(m):
    return m["c"].chain(m["iir"].iirfilt_sos(*iirdes_sos("butter", 7, 0.2)),
                        m["analog"].freq_demodulator(0.1),
                        m["misc"].iirdecim(4),
                        m["iir"].iirfilt_dc_blocker(0.01))


def message(b, t0, n):
    t = np.arange(t0, t0 + n)
    scale = 0.5 + 0.5 * np.arange(b)[:, None] / max(b - 1, 1)
    return (scale * (0.6 * np.cos(2 * np.pi * 0.013 * t)
                     + 0.3 * np.cos(2 * np.pi * 0.037 * t))
            ).astype(np.float32)


def test_analog_tx_matches_jax_without_noise():
    blocks = [message(B, k * T, T) for k in range(NBLK)]
    jp, p = analog_tx(JAX, noise=False), analog_tx(PORT, noise=False)
    load_jax_params(p, tp.jax_params(jp))
    yj, _ = tp.run_jax(jp, blocks, (B,))
    yt, _ = tp.run_torch(p, blocks, (B,))
    assert yt.shape == (B, NBLK * T) and yt.dtype == np.complex64
    assert np.abs(yt - yj).max() < 1e-5


def test_analog_rx_matches_jax():
    blocks = [message(B, k * T, T) for k in range(NBLK)]
    tx = analog_tx(PORT)
    x, _ = tp.run_torch(tx, blocks, (B,))
    xb = [x[:, k * T:(k + 1) * T] for k in range(NBLK)]
    jp, p = analog_rx(JAX), analog_rx(PORT)
    load_jax_params(p, tp.jax_params(jp))
    yj, cj = tp.run_jax(jp, xb, (B,))
    yt, ct = tp.run_torch(p, xb, (B,))
    assert yt.shape == (B, NBLK * T // 4) and yt.dtype == np.float32
    assert np.abs(yt - yj).max() < 1e-5
    for c, d in zip(ct, cj):
        np.testing.assert_allclose(c.numpy(), np.asarray(d), atol=1e-5)
    # the message comes back: the demodulated tones, past the filters'
    # settling, within 5% of the message's rms
    ref = message(B, 0, NBLK * T)[:, ::4]
    lag = int(np.argmax([np.sum(yt[:, 64 + d:] * ref[:, 64:ref.shape[1] - d])
                         for d in range(8)]))
    err = yt[:, 64 + lag:] - ref[:, 64:ref.shape[1] - lag]
    assert np.sqrt(np.mean(err ** 2) / np.mean(ref ** 2)) < 0.5
