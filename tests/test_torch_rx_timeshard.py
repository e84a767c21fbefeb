"""Port parity: the time-sharded streaming frame64 receiver
(liquid_dsp_tpu_torch.parallel.rx, a mesh of the CPU device repeated)
against the JAX package's single-device receiver, which
tests/test_rx_timeshard.py proves equal to its own time-sharded one.

With frames placed to STRADDLE shard and block boundaries, the port's
sharded run must decode the set of sample_index the JAX receiver decodes,
with the symbols within 2e-5 (tests/test_rx_timeshard.py's tolerance),
and with the watermark the JAX receiver carries.  On one shard it is the
port's single-device receiver bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch thread cap)
from liquid_dsp_tpu.framing import frame64 as jf
from liquid_dsp_tpu_torch.fec.device import qpacket_soft_decoder
from liquid_dsp_tpu_torch.framing.frame64 import (FRAME64_LEN, framegen64,
                                                  framesync64_stream)
from liquid_dsp_tpu_torch.parallel import (framesync64_time_sharded,
                                           stream_mesh)

T = 16384          # 8 shards of 2048 >= the 1561-sample halo
_JAX_STEPS = {}


def _mesh(n):
    return stream_mesh(n_time=n, devices=["cpu"] * n)


def _capture(T, K, rng, offsets, lead=()):
    """K blocks (leading axes ``lead``) with frames at the given absolute
    sample offsets on every row."""
    x = np.zeros(lead + (K * T,), np.complex64)
    sent = []
    for s0 in offsets:
        hdr = rng.integers(0, 256, 8, dtype=np.uint8)
        pay = rng.integers(0, 256, 64, dtype=np.uint8)
        f = framegen64(hdr, pay)
        x[..., s0:s0 + len(f)] += f
        sent.append((s0, hdr, pay))
    x += (0.004 * (rng.standard_normal(x.shape)
                   + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return x.reshape(lead + (K, T)), sent


def _frames(out, frames):
    v = out.valid.numpy()
    for p in np.nonzero(v)[0]:
        frames[int(out.sample_index[p])] = out.symbols[p].numpy()


def _run_jax(x, T):
    if T not in _JAX_STEPS:
        proc = jf.framesync64_stream(T)
        _JAX_STEPS[T] = (proc, jax.jit(proc.apply))
    proc, step = _JAX_STEPS[T]
    c, frames = proc.init(), {}
    for k in range(x.shape[0]):
        out, c = step((), c, jnp.asarray(x[k]))
        v = np.asarray(out.valid)
        for p in np.nonzero(v)[0]:
            frames[int(np.asarray(out.sample_index)[p])] = \
                np.asarray(out.symbols)[p]
    return frames, c


def _run_sharded(x, T, n, P=4):
    init, step = framesync64_time_sharded(T, _mesh(n),
                                          max_frames_per_shard=P)
    c, frames = init(), {}
    for k in range(x.shape[0]):
        out, c = step(c, torch.from_numpy(x[k]))
        assert out.valid.shape == (n * P,)
        _frames(out, frames)
    return frames, c


def _offsets(n, K):
    Tl = T // n
    # one just before a shard boundary (its span crosses into the next
    # shard), one exactly ON a boundary, one mid-shard, one across a
    # BLOCK boundary, one straddling in block 2 -- kept apart so that
    # every frame decodes
    cands = [Tl - FRAME64_LEN // 3, 2 * Tl % T or Tl + 2048,
             3 * Tl % T + 511, T - FRAME64_LEN // 2,
             T + Tl - FRAME64_LEN + 7, 2 * T + 1000]
    offsets, last = [], -(1 << 30)
    for s0 in sorted(set(cands)):
        if s0 - last > FRAME64_LEN + 600 and s0 + FRAME64_LEN < K * T:
            offsets.append(s0)
            last = s0
    return offsets


@pytest.mark.parametrize("n", [2, 4, 8])
def test_matches_single_device(n):
    rng = np.random.default_rng(100 + n)
    x, sent = _capture(T, 3, rng, _offsets(n, 3))
    ref, c_ref = _run_jax(x, T)
    got, c = _run_sharded(x, T, n)
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    assert len(ref) == len(sent)
    for si in ref:
        np.testing.assert_allclose(got[si], ref[si], atol=2e-5)
    assert int(c["last_end"]) == int(c_ref["last_end"])
    assert int(c["base"]) == int(c_ref["base"])
    np.testing.assert_array_equal(c["buf"].numpy(), np.asarray(c_ref["buf"]))


def test_carry_replicates_and_decodes_all():
    # the straddling frames' symbol windows come from real halo data: the
    # port's device decoder gives back every byte with its CRC
    rng = np.random.default_rng(7)
    Tl = T // 4
    offsets = [Tl - 300, 2 * Tl - 700, 3 * Tl + 100, T + Tl - 400]
    x, sent = _capture(T, 3, rng, offsets)
    got, _ = _run_sharded(x, T, 4)
    dev, fin = qpacket_soft_decoder(72, "crc24", "none", "golay2412",
                                    "qpsk")
    assert sorted(got) == [s0 for s0, _, _ in sent]
    for s0, hdr, pay in sent:
        buf, ok = fin(dev(torch.from_numpy(got[s0])[None]).numpy()[0])
        assert bool(ok), f"CRC failed for frame at {s0}"
        np.testing.assert_array_equal(buf[:8], hdr)
        np.testing.assert_array_equal(buf[8:], pay)


def test_single_shard_mesh_degenerates_cleanly():
    rng = np.random.default_rng(3)
    T1 = 4096
    x, sent = _capture(T1, 2, rng, [1000, T1 + 2000])
    ref, _ = _run_jax(x, T1)
    got, c = _run_sharded(x, T1, 1)
    assert set(got) == set(ref) and len(ref) == 2
    for si in ref:
        np.testing.assert_allclose(got[si], ref[si], atol=2e-5)
    # one shard is the port's single-device receiver, bit for bit
    proc = framesync64_stream(T1, max_frames=4)
    c1, mine = proc.init(), {}
    for k in range(2):
        out, c1 = proc(c1, torch.from_numpy(x[k]))
        _frames(out, mine)
    assert set(mine) == set(got)
    for si in mine:
        np.testing.assert_array_equal(got[si], mine[si])
    for k in c1:
        assert torch.equal(c[k], c1[k])


def test_watermark_replicates_across_shards():
    # a frame detected on shard 2 of 4 advances the carried watermark as
    # the single-device receiver does (tests/test_rx_timeshard.py:141)
    rng = np.random.default_rng(0)
    x = np.zeros(T, np.complex64)
    x[2 * 4096:2 * 4096 + FRAME64_LEN] = framegen64(
        np.arange(8, dtype=np.uint8), np.arange(64, dtype=np.uint8))
    x += (0.004 * (rng.standard_normal(T)
                   + 1j * rng.standard_normal(T))).astype(np.complex64)
    init, step = framesync64_time_sharded(T, _mesh(4))
    out, c = step(init(), torch.from_numpy(x))
    _, c1 = _run_jax(x[None], T)
    assert int(out.valid.sum()) == 1
    assert int(c["last_end"]) == int(np.asarray(c1["last_end"])) > -(1 << 30)


def test_channel_batch_equals_one_stream_a_row():
    # [3, T]: three channels at once against three 1-D runs (the
    # detection matmuls take other shapes: symbols within 2e-5)
    rng = np.random.default_rng(11)
    Tl = T // 4
    x, _ = _capture(T, 2, rng, [Tl - 500, 2 * Tl + 40, T + 3 * Tl - 900],
                    lead=(3,))
    init, step = framesync64_time_sharded(T, _mesh(4))
    cb, cs = init(batch_shape=(3,)), [init() for _ in range(3)]
    n_valid = 0
    for k in range(2):
        ob, cb = step(cb, torch.from_numpy(x[:, k]))
        assert ob.symbols.shape == (3, 16, 600)
        n_valid += int(ob.valid.sum())
        for row in range(3):
            o1, cs[row] = step(cs[row], torch.from_numpy(x[row, k]))
            v = o1.valid.numpy()
            np.testing.assert_array_equal(ob.valid[row].numpy(), v)
            np.testing.assert_array_equal(ob.sample_index[row].numpy()[v],
                                          o1.sample_index.numpy()[v])
            np.testing.assert_allclose(ob.symbols[row].numpy()[v],
                                       o1.symbols.numpy()[v], atol=2e-5)
            for key in cb:
                assert torch.equal(cb[key][row], cs[row][key])
    assert n_valid == 9
