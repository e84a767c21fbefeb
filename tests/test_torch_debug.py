"""Port parity: the debug tap points (`liquid_dsp_tpu_torch.debug`)
against the JAX package's (tests/test_debug.py): off by default, and
inside a capture the same taps with the same values.

The port's receivers run a batch of channels in one call, so a
single-stream receiver's tap carries a leading batch axis of 1 where the
JAX package's has none.  Tolerances: the AGC gain within 1e-5 relative
(the port's agc_scan against the JAX loop, tests/test_torch_agc_eq.py),
the stream receiver's segment peaks, coarse CFOs and region symbols
within 1e-5 (measured 2.4e-7, 7.4e-13, 3.8e-7), the OFDM metric within
1e-5 (measured below 1e-6)."""
import numpy as np
import pytest
import torch

import _torch_port as tp
import jax.numpy as jnp
from liquid_dsp_tpu import debug as jdebug
from liquid_dsp_tpu.ops.agc import agc as jagc
from liquid_dsp_tpu_torch import debug
from liquid_dsp_tpu_torch.ops.agc import agc


@pytest.fixture(autouse=True)
def _empty_stores():
    """Both packages keep the last capture's store after the context
    ends; empty them around each test, so that no test here (nor
    tests/test_debug.py, which may run after it in the same process)
    starts with another's captures."""
    debug.store().clear()
    jdebug.store().clear()
    yield
    debug.store().clear()
    jdebug.store().clear()


def test_disabled_by_default():
    q = agc()
    q(q.init(), torch.full((256,), 0.1, dtype=torch.complex64))
    assert not debug.enabled()
    assert debug.store() == {}
    # a tap outside a capture touches nothing (no copy, no sync)
    debug.tap("not.a.tensor", object())
    assert debug.store() == {}


def test_capture_agc_gain_matches_jax():
    x = np.ones(512, np.complex64) * 0.1
    q, jq = agc(bandwidth=0.05), jagc(bandwidth=0.05)
    with jdebug.capture() as jstore:
        jq(jnp.asarray(x), batch_shape=())
    with debug.capture() as store:
        assert debug.enabled()
        q(q.init(), torch.from_numpy(x))
    assert not debug.enabled()
    assert list(store) == list(jstore) == ["agc.gain"]
    g, jg = store["agc.gain"][0], np.asarray(jstore["agc.gain"][0])
    assert g.shape == jg.shape == () and abs(g - 10.0) < 1.0
    assert abs(g - jg) < 1e-5 * abs(jg)
    # disabled again afterwards: no further recording
    q(q.init(), torch.from_numpy(x))
    assert len(store["agc.gain"]) == 1


def test_capture_stream_rx_matches_jax(tmp_path):
    from liquid_dsp_tpu.framing.frame64 import Framesync64 as JFramesync64
    from liquid_dsp_tpu_torch.framing.frame64 import (FRAME64_LEN,
                                                      Framesync64, framegen64)
    cap = np.zeros(8192, np.complex64)
    cap[1000:1000 + FRAME64_LEN] = framegen64(
        np.arange(8, dtype=np.uint8), np.arange(64, dtype=np.uint8))
    with jdebug.capture() as jstore:
        JFramesync64(block_len=4096).execute(cap)
    with debug.capture() as store:
        Framesync64(block_len=4096, device="cpu").execute(cap)
    assert sorted(store) == sorted(jstore) == [
        "stream_rx.dphi", "stream_rx.region_syms", "stream_rx.seg_peak"]
    for name, got in store.items():
        want = jstore[name]
        assert len(got) == len(want) == 2, name        # one per block
        for g, w in zip(got, want):
            assert g.shape == (1,) + np.shape(w), name
            assert np.abs(g[0] - np.asarray(w)).max() < 1e-5, name
    # the detection trace sees the frame's correlation peak
    assert max(float(np.max(s)) for s in store["stream_rx.seg_peak"]) > 0.5
    debug.dump(tmp_path / "dbg.npz")
    d = np.load(tmp_path / "dbg.npz")
    assert d["stream_rx_seg_peak"].shape == (2, 1, 17)
    assert d["stream_rx_region_syms"].dtype == np.complex64


def test_capture_ofdm_metric_matches_jax():
    from liquid_dsp_tpu.multichannel import ofdm as jofdm
    from liquid_dsp_tpu_torch.multichannel import ofdm
    rng = np.random.default_rng(0)
    p = ofdm.ofdm_params(64, 16, 4)
    nsym = 4
    X = ((rng.integers(0, 2, (nsym, p.M_data)) * 2 - 1) +
         1j * (rng.integers(0, 2, (nsym, p.M_data)) * 2 - 1)
         ).astype(np.complex64) / np.sqrt(2)
    cap = np.concatenate([np.zeros(100, np.complex64),
                          ofdm.ofdm_generate_frame(p, X),
                          np.zeros(100, np.complex64)])
    cap = (cap + 0.01 * tp.cnoise(rng, len(cap))).astype(np.complex64)
    with jdebug.capture() as jstore:
        jofdm.ofdm_frame_sync(jofdm.ofdm_params(64, 16, 4), cap, nsym)
    with debug.capture() as store:
        r = ofdm.ofdm_frame_sync(p, cap, nsym, device="cpu")
    assert r.detected
    m, jm = store["ofdm.metric"][0], np.asarray(jstore["ofdm.metric"][0])
    assert m.shape == jm.shape == (len(cap) - 64 + 1,)
    assert float(m.max()) > 0.7
    assert np.abs(m - jm).max() < 1e-5


@pytest.mark.parametrize("ragged", [False, True])
def test_dump_stacks_or_splits(tmp_path, ragged):
    with debug.capture():
        debug.tap("a.b", torch.arange(3))
        debug.tap("a.b", torch.arange(4 if ragged else 3))
    debug.dump(tmp_path / "d.npz")
    d = np.load(tmp_path / "d.npz")
    if ragged:
        assert sorted(d.files) == ["a_b_0", "a_b_1"]
        np.testing.assert_array_equal(d["a_b_1"], np.arange(4))
    else:
        np.testing.assert_array_equal(d["a_b"], np.stack([np.arange(3)] * 2))
