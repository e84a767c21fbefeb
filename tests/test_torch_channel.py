"""Port parity for `ops/channel.py`, the channel impairment model.

The two packages draw their randomness differently (a JAX key, a torch
Generator), so parity is held where no random number enters: multipath,
carrier offset and gain with noise and shadowing off, within 1e-6
absolute of the JAX package (the same float32 products; cos/sin of the
phase are each library's own); the shadowing recurrence on one injected
white-noise sequence, within 1e-6 of the JAX package's scan step (XLA may
contract its multiply-add); the noise power and the shadowing's variance
statistically, at the JAX test's 1 dB for the SNR and 5-10% for powers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu.ops import channel as J
from liquid_dsp_tpu_torch.convert import load_jax_params
from liquid_dsp_tpu_torch.ops import channel as P

H = np.asarray([0.9, 0.2j, -0.1, 0.05 + 0.05j], np.complex64)
DETERMINISTIC = {
    "multipath": dict(multipath_taps=H),
    "cfo": dict(dphi=0.013, phi=0.5),
    "gain": dict(snr_db=310.0, noise_floor_db=-300.0),   # noise at 1e-15
    "all": dict(multipath_taps=H, dphi=-0.2, phi=1.0, snr_db=306.0,
                noise_floor_db=-300.0),
}


@pytest.mark.parametrize("case", sorted(DETERMINISTIC))
def test_deterministic_impairments_match_jax(case):
    kw = DETERMINISTIC[case]
    jq, q = J.channel(**kw), P.channel(**kw)
    if "multipath_taps" in kw:
        load_jax_params(q, tp.jax_params(jq))
    x = tp.cnoise(np.random.default_rng(2), (3, 700))
    blocks = [x[:, :256], x[:, 256:]]
    yj, cj = tp.run_jax(jq, blocks, (3,))
    yt, ct = tp.run_torch(q, blocks, (3,))
    assert np.abs(yt - yj).max() < 1e-6 * max(1.0, np.abs(yj).max())
    assert set(ct) == set(cj)
    for k in set(ct) - {"key"}:
        assert tuple(ct[k].shape) == cj[k].shape
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]),
                                   atol=1e-5)


def _jax_shadow(beta, s0, w):
    # liquid_dsp_tpu/ops/channel.py:65-71, the scan body as written there
    def step(s, wt):
        s = beta * s + np.sqrt(1 - beta ** 2) * wt
        return s, s

    sh, seq = jax.lax.scan(step, jnp.asarray(s0), jnp.moveaxis(
        jnp.asarray(w), -1, 0))
    return np.asarray(jnp.moveaxis(seq, 0, -1)), np.asarray(sh)


@pytest.mark.parametrize("fd", [0.001, 0.1])
def test_shadowing_recurrence_matches_jax_step(fd):
    q = P.channel(shadowing_std=1.0, shadowing_fd=fd)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 600)).astype(np.float32)
    s0 = rng.standard_normal(4).astype(np.float32)
    sj, shj = _jax_shadow(q.beta_sh, s0, w)
    s1, last1 = q.shadow(torch.from_numpy(s0), torch.from_numpy(w[:, :250]))
    s2, last2 = q.shadow(last1, torch.from_numpy(w[:, 250:]))
    st = torch.cat([s1, s2], dim=-1).numpy()
    np.testing.assert_allclose(st, sj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(last2.numpy(), shj, rtol=1e-6, atol=1e-6)


def test_awgn_power_and_snr():
    q = P.channel(snr_db=20.0, noise_floor_db=-40.0, seed=1)
    x = torch.ones(4, 20000, dtype=torch.complex64)
    y, _ = q(q.init(batch_shape=(4,)), x)
    y = y.numpy()
    noise = y - y.mean(axis=-1, keepdims=True)
    snr = 10 * np.log10(np.abs(y.mean()) ** 2 / np.mean(np.abs(noise) ** 2))
    assert abs(snr - 20.0) < 1.0, snr
    # the noise floor alone: total power nstd^2
    z, _ = q(q.init(batch_shape=(4,)), torch.zeros(4, 20000,
                                                    dtype=torch.complex64))
    p = float(np.mean(np.abs(z.numpy()) ** 2))
    assert abs(p / 1e-4 - 1.0) < 0.05, p


def test_shadowing_gain_variance():
    std_db = 2.0
    q = P.channel(shadowing_std=std_db, shadowing_fd=0.05, seed=4)
    c = q.init(batch_shape=(8,))
    x = torch.ones(8, 4096, dtype=torch.complex64)
    ys = []
    for _ in range(2):
        y, c = q(c, x)
        ys.append(y.numpy())
    g_db = 20 * np.log10(np.abs(np.concatenate(ys, axis=-1)))
    assert abs(g_db.std() / std_db - 1.0) < 0.1, g_db.std()
    assert abs(g_db.mean()) < 0.3 * std_db
    np.testing.assert_allclose(c["sh_state"].numpy(), g_db[:, -1] / std_db,
                               rtol=1e-4)


def test_randomness_is_reproducible_from_the_seed_and_streams():
    kw = dict(snr_db=10.0, shadowing_std=1.0, shadowing_fd=0.01)
    x = torch.from_numpy(tp.cnoise(np.random.default_rng(0), (2, 300)))
    runs = []
    for seed in (7, 7, 8):
        q = P.channel(seed=seed, **kw)
        c = q.init(batch_shape=(2,))
        y1, c = q(c, x)
        y2, c = q(c, x)
        runs.append(torch.cat([y1, y2], -1))
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0][:, :300], runs[0][:, 300:])


def test_carrier_offset_phase_and_continuity():
    q = P.channel(dphi=0.01, phi=0.5)
    c = q.init()
    y1, c = q(c, torch.ones(256, dtype=torch.complex64))
    y2, c = q(c, torch.ones(256, dtype=torch.complex64))
    ph = np.unwrap(np.angle(np.concatenate([y1.numpy(), y2.numpy()])))
    np.testing.assert_allclose(np.diff(ph), 0.01, atol=1e-5)
    assert abs(ph[0] - 0.5) < 1e-5
    assert 0.0 <= float(c["theta"]) < 2 * np.pi


def test_init_matches_jax_carry_layout():
    kw = dict(multipath_taps=H, shadowing_std=1.0, snr_db=20.0)
    cj = J.channel(**kw).init(batch_shape=(5, 2))
    c = P.channel(**kw).init(batch_shape=(5, 2))
    assert set(c) == set(cj)
    for k in ("theta", "mp_tail", "sh_state"):
        assert tuple(c[k].shape) == cj[k].shape
        assert str(c[k].dtype)[6:] == str(cj[k].dtype)
