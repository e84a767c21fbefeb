"""The identities that the card's `codebook_argmax` and `agc_scan` kernels
are built on, shown on the CPU against the plain versions and numpy:

* codebook_argmax: a multiply-add with a factor of +-1 is the rounded add
  of +-w, bit for bit; zeros appended to a row change no sum; and the
  kernel's own walk, written out in numpy float32 (the columns sorted by
  mask, 4 neighbours per thread, their first 8 to 10 positions summed once
  where every thread of the warp finds its columns agreeing there, columns
  past K repeating the last one, the larger score and on equal scores the
  smaller index of the column's own inside a thread and between threads),
  gives the scores of the ordered sum bit for bit and the indices of
  `codebook_argmax_reference`, ties included;
* agc_scan: the loop's own log and exp (`agc_log`, `agc_exp`) stay below
  1 ulp of float32 against float64 over the loop's domain; with the
  exponent's factor at 0 the exp is exactly 1, so the guard leaves g as it
  is; the clamp holds; and the plain version stays within 1e-5 of the JAX
  package's `agc_scan` at alpha 1e-3, 0.02 and 0.5.

Inputs are seeded numpy; T <= 1024.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu.ops import agc as jagc
from liquid_dsp_tpu_torch.fec.device import block_codebook
from liquid_dsp_tpu_torch.ops.kernels import agc_scan as ak
from liquid_dsp_tpu_torch.ops.kernels import codebook_argmax as cba
from liquid_dsp_tpu_torch.ops.kernels.symsync_scan import fma32

THREADS, CB = 128, 4              # the kernel's block, columns per thread
PFX = {8: 8, 16: 9, 24: 10, 32: 8}    # shared positions by padded row width


def _codebook(name):
    """[n, K] +-1 float32 codebooks: the two block codes, golay with its
    columns in a random order, a random one with K off a pass's multiple
    (its sorted neighbours share too little), and one with far-apart
    duplicates."""
    rng = np.random.default_rng(len(name))
    if name in ("golay2412", "hamming1511"):
        return block_codebook(name)[0]
    if name == "golay_shuffled":
        bip = block_codebook("golay2412")[0]
        return np.ascontiguousarray(bip[:, rng.permutation(bip.shape[1])])
    bip = np.where(rng.random((32, 1000)) < 0.5, -1.0, 1.0).astype(np.float32)
    if name == "duplicates":
        bip[:, 900] = bip[:, 3]
        bip[:, 517] = bip[:, 516]
    return bip


def _rows(bip, seed, M=24):
    """Soft bits with ties in them: zero rows, a row that is one column's
    own signs (twice the best score where that column is duplicated), rows
    of one repeated value, and normal rows."""
    rng = np.random.default_rng(seed)
    cw = rng.standard_normal((M, bip.shape[0])).astype(np.float32)
    cw[0] = 0.0
    cw[1] = 1.0
    cw[2] = bip[:, 3] * (rng.random(bip.shape[0]) + 0.5)
    cw[3] = bip[:, min(516, bip.shape[1] - 1)] * 0.75
    cw[4] = -0.0
    return cw


def _ordered_scores(cw, bip):
    """acc = acc + cw[i]*bip[i, k] for i = 0..n-1 from zero, in float32."""
    acc = np.zeros((cw.shape[0], bip.shape[1]), np.float32)
    for i in range(cw.shape[1]):
        acc = acc + cw[:, i:i + 1] * bip[i]
    return acc


def _kernel_walk(cw, bip):
    """The kernel's structure in numpy float32: (scores [M, K], indices [M],
    number of warp passes that took the shared-prefix form)."""
    M, n = cw.shape
    K = bip.shape[1]
    NP = -(-n // 8) * 8
    w = np.zeros((M, NP), np.float32)
    w[:, :n] = cw
    masks, order = cba.sort_codebook(torch.from_numpy(bip))
    masks, order = masks.numpy().view(np.uint32), order.numpy()
    sign = lambda m, i: np.float32(-1.0 if (int(m) >> (31 - i)) & 1 else 1.0)
    scores = np.full((M, K), np.nan, np.float32)
    best = np.full((THREADS, M), -np.inf, np.float32)
    bidx = np.full((THREADS, M), 0x7FFFFFFF, np.int64)
    shared_passes = 0
    for base in range(0, K, THREADS * CB):
        at = [[min(base + t * CB + j, K - 1) for j in range(CB)]
              for t in range(THREADS)]
        cols = [[masks[c] for c in row] for row in at]
        for warp in range(THREADS // 32):
            lanes = range(warp * 32, warp * 32 + 32)
            agree = all(((cols[t][0] ^ cols[t][j]) >> (32 - PFX[NP])) == 0
                        for t in lanes for j in range(1, CB))
            P = PFX[NP] if agree else 0
            shared_passes += agree
            for t in lanes:
                head = np.zeros(M, np.float32)
                for i in range(P):
                    head = head + w[:, i] * sign(cols[t][0], i)
                for j in range(CB):
                    acc = head.copy()
                    for i in range(P, NP):
                        acc = acc + w[:, i] * sign(cols[t][j], i)
                    own = order[at[t][j]]
                    scores[:, own] = acc
                    more, same = acc > best[t], acc == best[t]
                    bidx[t] = np.where(more, own, np.where(
                        same, np.minimum(bidx[t], own), bidx[t]))
                    best[t] = np.maximum(best[t], acc)
    top = best.max(axis=0)
    idx = np.where(best == top, bidx, 0x7FFFFFFF).min(axis=0)
    return scores, idx, shared_passes


@pytest.mark.parametrize("name,shared", [
    ("golay2412", True), ("golay_shuffled", True), ("hamming1511", True),
    ("random", False), ("duplicates", False)])
def test_codebook_kernel_walk_matches_the_ordered_sum(name, shared):
    bip = _codebook(name)
    cw = _rows(bip, seed=len(name))
    scores, idx, shared_passes = _kernel_walk(cw, bip)
    want = _ordered_scores(cw, bip)
    # equal as numbers is equal in bits for finite floats, zeros apart
    assert np.isfinite(scores).all()
    np.testing.assert_array_equal(scores, want)
    ref = cba.codebook_argmax_reference(torch.from_numpy(cw),
                                        torch.from_numpy(bip)).numpy()
    np.testing.assert_array_equal(idx, ref)
    np.testing.assert_array_equal(idx, np.argmax(want, axis=-1))
    assert (shared_passes > 0) == shared
    assert idx[0] == 0 and idx[4] == 0          # constant rows: all tied
    if name == "duplicates":
        assert idx[2] == 3 and idx[3] == 516    # never 900 or 517


def test_columns_past_k_never_win():
    # K = 5: three of the second thread's columns and every later thread
    # repeat a real column under an index past K
    bip = np.where(np.random.default_rng(1).random((9, 5)) < 0.5, -1.0,
                   1.0).astype(np.float32)
    cw = _rows(bip, seed=2, M=12)
    _, idx, _ = _kernel_walk(cw, bip)
    assert idx.max() < 5
    np.testing.assert_array_equal(idx, np.argmax(_ordered_scores(cw, bip), -1))


def _awkward_floats(rng, n):
    x = rng.standard_normal(n).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -30, 30, n).astype(np.float32)
    x[:8] = [0.0, -0.0, 1e-45, -1e-45, 3e38, -3e38, 1.17549435e-38, 1.0]
    return x


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_fma_by_a_sign_is_the_rounded_add(sign):
    rng = np.random.default_rng(int(sign) + 5)
    w = torch.from_numpy(_awkward_floats(rng, 200_000))
    acc = torch.from_numpy(rng.permutation(_awkward_floats(rng, 200_000)))
    # close magnitudes too, where the add rounds
    acc[1000:100_000] = w[1000:100_000] * torch.from_numpy(
        rng.uniform(-4, 4, 99_000).astype(np.float32))
    got = fma32(w, torch.full_like(w, sign), acc)
    want = acc + sign * w
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_appended_zeros_change_no_sum():
    rng = np.random.default_rng(3)
    acc = torch.from_numpy(_awkward_floats(rng, 10_000))
    for z in (0.0, -0.0):
        for s in (1.0, -1.0):
            got = fma32(torch.full_like(acc, z), torch.full_like(acc, s), acc)
            assert torch.equal(got, acc)       # -0 + 0 is +0: equal, and
            nz = acc != 0                      # bit-equal where acc != 0
            assert torch.equal(got[nz].view(torch.int32),
                               acc[nz].view(torch.int32))


# --- agc_scan ------------------------------------------------------------

def _ulps(got, want64):
    return np.abs(got.astype(np.float64) - want64) / np.spacing(
        np.abs(want64.astype(np.float32))).astype(np.float64)


def test_agc_log_is_below_one_ulp():
    rng = np.random.default_rng(0)
    y = np.concatenate([
        np.exp(rng.uniform(np.log(1e-6), np.log(3e38), 200_000)),
        rng.uniform(0.5, 2.0, 200_000), 1 + rng.uniform(-1e-3, 1e-3, 50_000),
        [1.0, 2 / 3, 4 / 3, 1.0000001e-6, 0.99999994, 1.0000001, 3.4e38]
    ]).astype(np.float32)
    y = y[y > 1e-6]
    got = ak.agc_log(torch.from_numpy(y)).numpy()
    want = np.log(y.astype(np.float64))
    assert got[y == 1.0].tolist() == [0.0] * int((y == 1.0).sum())
    ok = want != 0
    assert _ulps(got[ok], want[ok]).max() < 1.0
    assert np.abs(got - want).max() < 7.7e-6    # an ulp at |log| = 88


def test_agc_exp_is_below_one_ulp():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-45, 45, 200_000),
                        rng.uniform(-0.5, 0.5, 200_000),
                        rng.uniform(-1e-3, 1e-3, 50_000),
                        [0.0, -0.0, 44.36, -44.36, 0.34657359, -0.34657359]
                        ]).astype(np.float32)
    got = ak.agc_exp(torch.from_numpy(x)).numpy()
    assert _ulps(got, np.exp(x.astype(np.float64))).max() < 1.0
    assert got[x == 0].tolist() == [1.0] * int((x == 0).sum())


@pytest.mark.parametrize("alpha", [1e-3, 0.02, 0.5, 1.0])
def test_agc_power_step_against_float64(alpha):
    # the loop's y2p^(-alpha/2), with t formed from the log as the loop
    # does, against float64: an ulp of the log scaled by alpha/2 (relative
    # 2^-23 of the exponent x), the product's rounding and an ulp of the exp
    rng = np.random.default_rng(2)
    y = np.exp(rng.uniform(np.log(1e-6), np.log(1e30), 100_000)).astype(
        np.float32)
    yt = torch.from_numpy(y)
    _, _, ch = ak.agc_consts(alpha)
    chl = float(np.float32(ch) * np.float32(ak.LOG2E))
    lg = ak.agc_log(yt)
    t = fma32(lg, torch.full_like(lg, chl), torch.full_like(lg, ak.ROUND_MAGIC))
    got = ak.agc_exp(lg * ch, t).numpy()
    x = np.log(y.astype(np.float64)) * np.float64(np.float32(ch))
    want = np.exp(x)
    assert (np.abs(got - want) / want / (2.0 + 1.5 * np.abs(x))).max() < 2.0 ** -23


def test_agc_guard_and_clamp_are_exact():
    # silence: y2p falls below 1e-6, g grows to the clamp and stays there
    p = torch.zeros(3, 200)
    p[1] = 1e-30
    p[2, :50] = 4.0
    g0, y0 = torch.tensor([1.0, 0.5, 2.0]), torch.ones(3)
    gains, g, y2p = ak.agc_scan_reference(p, g0, y0, alpha=0.5)
    assert float(y2p.max()) < 1e-6
    assert g.tolist() == [1e6, 1e6, 1e6] and float(gains.max()) == 1e6
    # below the guard the factor is 0, the exp exactly 1 and g unchanged
    held = ak.agc_scan_reference(torch.zeros(2, 5), torch.tensor([3.25, 7.0]),
                                 torch.tensor([1e-7, 5e-7]), alpha=0.5)
    assert held[1].tolist() == [3.25, 7.0]
    assert torch.equal(held[0], torch.tensor([[3.25] * 5, [7.0] * 5]))
    zero = torch.zeros(4)
    lg = torch.tensor([-88.0, -13.9, 0.0, 88.7])
    one = ak.agc_exp(lg * zero, fma32(lg, zero, torch.full_like(
        lg, ak.ROUND_MAGIC)))
    assert one.tolist() == [1.0] * 4


@pytest.mark.parametrize("alpha", [1e-3, 0.02, 0.5])
@pytest.mark.parametrize("locked", [False, True])
def test_agc_scan_reference_matches_jax(alpha, locked):
    rng = np.random.default_rng(int(alpha * 1000) + locked)
    B, T = 6, 1024
    x = tp.cnoise(rng, (B, T)) * np.geomspace(1e-3, 30.0, B)[:, None]
    x[:, T // 2:] *= np.geomspace(30.0, 0.01, B)[:, None]     # a level step
    x = x.astype(np.complex64)
    p = (x.real * x.real + x.imag * x.imag).astype(np.float32)
    g0 = rng.uniform(0.5, 2.0, B).astype(np.float32)
    y0 = np.ones(B, np.float32)
    yj, cj = jagc.agc_scan(alpha, {"g": jnp.asarray(g0),
                                   "y2_prime": jnp.asarray(y0)},
                           jnp.asarray(x), locked=locked)
    gains, g, y2p = ak.agc_scan_reference(
        torch.from_numpy(p), torch.from_numpy(g0), torch.from_numpy(y0),
        alpha=alpha, locked=locked)
    assert tp.rel_err(x * gains.numpy(), np.asarray(yj)) < 1e-5
    np.testing.assert_allclose(g.numpy(), np.asarray(cj["g"]), rtol=1e-5)
    np.testing.assert_allclose(y2p.numpy(), np.asarray(cj["y2_prime"]),
                               rtol=1e-5)
