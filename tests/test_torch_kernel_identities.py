"""The identities that the card's `pll_lms` and `symsync_scan` kernels are
built on, shown on the CPU against the plain versions (which the parity
tests hold to the JAX package):

* pll_lms: the state changes only on valid slots, so running over the
  compacted valid slots gives the same state and the same outputs there,
  bit for bit; an invalid slot's output is the dot with the state frozen at
  the last valid slot before it; and the kernel's own walk (valid slots
  only, the next partial dot as A + g e C, outputs latched per slot),
  written out in numpy float64, agrees with the plain version to 2e-5 with
  equal decisions (the kernel itself is held to 2e-4 on the card);
* symsync_scan: within a step the valid mask never rises along the emit
  axis, and the kernel's emit loop (one recompute for a step that opens
  inactive, then active emits only), written out with the plain version's
  arithmetic, gives bit-equal outputs and state.

Inputs are seeded numpy; T <= 1024.
"""
import numpy as np
import pytest
import torch

from liquid_dsp_tpu_torch.modem import constellation
from liquid_dsp_tpu_torch.ops.kernels import pll_lms as pk
from liquid_dsp_tpu_torch.ops.kernels import symsync_scan as sk

PLL_KW = dict(alpha=0.05, beta2=0.5 * 0.05 ** 2, mu=0.05)


def _pll_case(seed, B, S, L, ms, share, n0=None):
    """Noisy constellation points with a slow rotation on the valid slots
    (zeros elsewhere, as symsync leaves them), a random state near the
    tracker's, and the slicer: what pll_lms takes, as torch tensors."""
    rng = np.random.default_rng(seed)
    table = np.asarray(constellation(ms)).astype(np.complex64)
    valid = rng.random((B, S)) < share
    sym = table[rng.integers(0, len(table), (B, S))]
    sym = sym * np.exp(1j * (0.3 + 2e-3 * np.arange(S)))
    sym = sym + 0.03 * (rng.standard_normal((B, S))
                        + 1j * rng.standard_normal((B, S)))
    sym = np.where(valid, sym, 0).astype(np.complex64)
    w = np.zeros((B, L), np.complex64)
    w[:, L // 2] = 1.0
    w += 0.02 * (rng.standard_normal((B, L)) + 1j * rng.standard_normal((B, L)))
    buf = table[rng.integers(0, len(table), (B, L))]
    st = {"theta": rng.uniform(-0.2, 0.2, B), "dtheta": np.zeros(B),
          "ew_re": w.real, "ew_im": w.imag, "eb_re": buf.real,
          "eb_im": buf.imag,
          "eq_x2": (np.abs(buf) ** 2).sum(-1),
          "eq_n": np.full(B, L if n0 is None else n0)}
    st = {k: torch.from_numpy(np.ascontiguousarray(v).astype(
        np.int32 if k == "eq_n" else np.float32)) for k, v in st.items()}
    tab = (torch.from_numpy(table.real.copy()),
           torch.from_numpy(table.imag.copy()))
    return (torch.from_numpy(sym.real.copy()), torch.from_numpy(
        sym.imag.copy()), torch.from_numpy(valid), st, tab,
        pk.slicer_config(table))


def _row(st, b):
    return {k: v[b:b + 1].contiguous() for k, v in st.items()}


PLL_CASES = [("qpsk", 13, 1 / 6), ("qam16", 13, 1 / 6), ("qpsk", 32, 1 / 3),
             ("qpsk", 1, 1 / 2), ("psk8", 16, 1.0)]


@pytest.mark.parametrize("ms,L,share", PLL_CASES)
def test_pll_lms_over_compacted_valid_slots_is_bit_equal(ms, L, share):
    B, S = 3, 384
    s_re, s_im, valid, st, tab, qpsk = _pll_case(L, B, S, L, ms, share)
    valid[1] = share == 1.0          # a channel with no valid slot at all
    kw = dict(PLL_KW, qpsk=qpsk)
    y_re, y_im, dec, full = pk.pll_lms_reference(s_re, s_im, valid, st, *tab,
                                                 **kw)
    for b in range(B):
        m = valid[b]
        n = int(m.sum())
        c_re, c_im, c_dec, comp = pk.pll_lms_reference(
            s_re[b:b + 1, m], s_im[b:b + 1, m],
            torch.ones(1, n, dtype=torch.bool), _row(st, b), *tab, **kw)
        for key in pk.STATE_KEYS:
            assert torch.equal(comp[key][0], full[key][b]), (b, key)
        assert torch.equal(c_re[0], y_re[b, m])
        assert torch.equal(c_im[0], y_im[b, m])
        assert torch.equal(c_dec[0], dec[b, m])
    for key in pk.STATE_KEYS:        # no valid slot: the state passes through
        assert torch.equal(full[key][1], st[key][1]) or share == 1.0


@pytest.mark.parametrize("ms,L,share", PLL_CASES[:4])
def test_pll_lms_invalid_slots_see_the_frozen_state(ms, L, share):
    B, S = 2, 256
    s_re, s_im, valid, st, tab, qpsk = _pll_case(10 + L, B, S, L, ms, share)
    # invalid slots that carry a sample, which the wrapper must serve too
    rng = np.random.default_rng(L)
    s_re = s_re + torch.from_numpy((~valid.numpy() * rng.standard_normal(
        (B, S)) * 0.5).astype(np.float32))
    kw = dict(PLL_KW, qpsk=qpsk)
    y_re, y_im, dec, _ = pk.pll_lms_reference(s_re, s_im, valid, st, *tab,
                                              **kw)
    c = dict(st)
    always = torch.ones(B, dtype=torch.bool)
    for s in range(S):
        # the frozen-state formula: y = sum conj(w_j) [buf[1:], v]_j
        th = c["theta"].double()
        v = torch.complex(s_re[:, s].double(), s_im[:, s].double()) \
            * torch.exp(-1j * th)
        w = torch.complex(c["ew_re"].double(), c["ew_im"].double())
        buf = torch.complex(c["eb_re"].double(), c["eb_im"].double())
        y = (w.conj() * torch.cat([buf[:, 1:], v[:, None]], -1)).sum(-1)
        inv = ~valid[:, s]
        got = torch.complex(y_re[:, s].double(), y_im[:, s].double())
        assert float(((got - y).abs() * inv).max()) < 2e-6, s
        d, _, _ = pk.nearest(y.real.float(), y.imag.float(), *tab, qpsk)
        assert torch.equal(d[inv], dec[inv, s]), s
        # the state moves on over the valid slots only
        new, _ = pk.pll_lms_step(c, s_re[:, s], s_im[:, s], always, *tab,
                                 **kw)
        vm = valid[:, s]
        c = {k: torch.where(vm[:, None] if new[k].dim() == 2 else vm, new[k],
                            c[k]) for k in c}


def _nearest64(v, table, qpsk):
    if qpsk is not None:
        s2v, (k00, k01, k10, k11) = qpsk
        a, b = v.real < 0, v.imag < 0
        idx = (k11 if b else k10) if a else (k01 if b else k00)
        return idx, complex(-s2v if a else s2v, -s2v if b else s2v)
    idx = int(np.argmin(np.abs(v - table) ** 2))
    return idx, complex(table[idx])


def _kernel_walk(sym, valid, st, table, qpsk, alpha, beta2, mu):
    """csrc/pll_lms.cu's walk over one channel in float64: valid slots
    only, the window kept shifted ahead, P' = A + g e C, invalid slots from
    the state latched at the last valid slot."""
    L = len(st["w"])
    w, theta, dtheta = st["w"].copy(), st["theta"], st["dtheta"]
    sb = np.append(st["buf"][1:], 0)          # sb_j = buf_{j+1}, newest 0
    old, x2, n = st["buf"][0], st["x2"], st["n"]
    P = np.sum(np.conj(w) * sb)
    y = np.zeros(len(sym), complex)
    dec = np.zeros(len(sym), np.int64)
    frozen = (P, w[L - 1], theta)
    for s in range(len(sym)):
        if not valid[s]:
            fp, fw, fth = frozen
            y[s] = fp + np.conj(fw) * sym[s] * np.exp(-1j * fth)
            dec[s] = _nearest64(y[s], table, qpsk)[0]
            continue
        v = sym[s] * np.exp(-1j * theta)
        _, r = _nearest64(v, table, qpsk)
        e = np.angle(v * np.conj(r))
        dtheta = dtheta + beta2 * e
        theta = theta + dtheta + alpha * e
        nb = sb.copy()
        nb[L - 1] = v
        sb = np.append(nb[1:], 0)
        A = np.sum(np.conj(w) * sb)
        C = np.sum(np.conj(nb) * sb)
        x2 = x2 + abs(v) ** 2 - abs(old) ** 2
        old = nb[0]
        n += 1
        gain = (mu if n >= L else 0.0) / max(x2, 1e-12)
        y[s] = P + np.conj(w[L - 1]) * v
        dec[s], d = _nearest64(y[s], table, qpsk)
        err = d - y[s]
        P = A + gain * err * C
        w = w + gain * np.conj(err) * nb
        frozen = (P, w[L - 1], theta)
    buf = np.append(old, sb[:L - 1])
    return y, dec, {"theta": theta, "dtheta": dtheta, "w": w, "buf": buf,
                    "x2": x2, "n": n}


@pytest.mark.parametrize("ms,L,share,n0", [
    ("qpsk", 13, 1 / 6, None), ("qam16", 13, 1 / 6, None),
    ("qpsk", 32, 1 / 3, None), ("qpsk", 1, 1 / 2, None),
    ("psk8", 16, 1.0, None), ("qpsk", 13, 1 / 4, 0)])
def test_pll_lms_kernel_walk_matches_plain_version(ms, L, share, n0):
    # n0 = 0: the window is not yet full, the update waits for n + 1 >= L
    B, S = 3, 512
    s_re, s_im, valid, st, tab, qpsk = _pll_case(20 + L, B, S, L, ms, share,
                                                 n0)
    valid[1, :200] = False           # a long run without a valid slot
    valid[2] = share == 1.0
    kw = dict(PLL_KW, qpsk=qpsk)
    y_re, y_im, dec, out = pk.pll_lms_reference(s_re, s_im, valid, st, *tab,
                                                **kw)
    table = (tab[0] + 1j * tab[1]).numpy().astype(complex)
    for b in range(B):
        st64 = {"theta": float(st["theta"][b]),
                "dtheta": float(st["dtheta"][b]),
                "w": (st["ew_re"][b] + 1j * st["ew_im"][b]).numpy().astype(
                    complex),
                "buf": (st["eb_re"][b] + 1j * st["eb_im"][b]).numpy().astype(
                    complex),
                "x2": float(st["eq_x2"][b]), "n": int(st["eq_n"][b])}
        sym = (s_re[b] + 1j * s_im[b]).numpy().astype(complex)
        y, d, fin = _kernel_walk(sym, valid[b].numpy(), st64, table, qpsk,
                                 **PLL_KW)
        got = (y_re[b] + 1j * y_im[b]).numpy()
        assert np.abs(got - y).max() < 2e-5, b
        np.testing.assert_array_equal(d, dec[b].numpy())
        assert abs(fin["theta"] - float(out["theta"][b])) < 2e-5
        assert fin["n"] == int(out["eq_n"][b])
        assert abs(fin["x2"] - float(out["eq_x2"][b])) < 1e-4
        np.testing.assert_allclose(
            fin["w"], (out["ew_re"][b] + 1j * out["ew_im"][b]).numpy(),
            rtol=0, atol=2e-5)
        np.testing.assert_allclose(
            fin["buf"], (out["eb_re"][b] + 1j * out["eb_im"][b]).numpy(),
            rtol=0, atol=2e-5)


# ---------------------------------------------------------------- symsync

def _sync_case(seed, P, B, Tc, npfb, k, stale):
    """Branch outputs and a loop state for `symsync_scan`.  With `stale`,
    bi and bf are moved off round(tau*npfb), as a step decrement leaves
    them, and one tau sits on a rounding edge (tau*npfb = x.5)."""
    rng = np.random.default_rng(seed)
    ma = (rng.standard_normal((P, B, 2 * npfb, Tc)) * 0.7).astype(np.float32)
    fs = np.zeros((6, B), np.float32)
    fs[0] = rng.uniform(-0.3, 1.6, B)
    fs[0, 0] = 15.5 / npfb
    fs[1] = fs[2] = float(k)
    fs[3] = rng.uniform(-0.01, 0.01, B)
    fs[4] = fs[0] * npfb
    bi = np.round(fs[4]).astype(np.int32)
    if stale:
        fs[4] = fs[4] * (1 + 2e-7) + 1e-6
        bi[1::2] += rng.choice([-1, 1], len(bi[1::2]))
    is_ = np.stack([bi, rng.integers(1, 3, B).astype(np.int32)])
    return torch.from_numpy(ma), torch.from_numpy(fs), torch.from_numpy(is_)


def _kernel_emits(ma, fstate, istate, *, npfb, max_out, k, k_out, bw,
                  locked):
    """csrc/symsync_scan.cu's chain, one channel after the other, in the
    plain version's arithmetic (float32 ops rounded one by one, `fma32` at
    the three contraction points)."""
    P, B, _, Tc = ma.shape
    c_q, c_v, c_r = (np.float32(c) for c in sk.loop_consts(bw))
    inv_k = np.float32(sk.inverse_k(k))
    f32, one = np.float32, np.float32(1.0)
    y_re = np.zeros((B, Tc * max_out), np.float32)
    y_im = np.zeros((B, Tc * max_out), np.float32)
    valid = np.zeros((B, Tc * max_out), bool)
    fs, is_ = fstate.numpy().copy(), istate.numpy().copy()
    m = ma.numpy()

    def fma(a, b, c):
        a, b, c = (torch.tensor([float(x)], dtype=torch.float32)
                   for x in (a, b, c))
        return f32(sk.fma32(a, b, c)[0])

    for ch in range(B):
        tau, rate, dl, v0, bf, ran = (f32(v) for v in fs[:, ch])
        bi, decim = int(is_[0, ch]), int(is_[1, ch])
        for t in range(Tc):
            e = 0
            if bi >= npfb:
                tau = f32(tau + f32(0.0))
                ran = max(ran, f32(0.0))
                bf = f32(tau * f32(npfb))
                bi = int(np.rint(bf))
                e = 1
            while e < max_out and bi < npfb:
                bc = max(bi, 0)
                mf_re, dmf_re = m[0, ch, bc, t], m[0, ch, npfb + bc, t]
                mf_im = f32(0.0)
                if P == 2:
                    mf_im, dmf_im = m[1, ch, bc, t], m[1, ch, npfb + bc, t]
                    q_raw = fma(mf_re, dmf_re, f32(mf_im * dmf_im))
                else:
                    q_raw = f32(mf_re * dmf_re)
                run = decim == k_out and not locked
                q = min(max(q_raw, -one), one)
                q_hat = fma(c_q, q, v0)
                v0n = f32(c_v * q_hat)
                rn = fma(c_r, q_hat, rate)
                dn = f32(rn + q_hat)
                tau = f32(tau + dl)
                bf = f32(tau * f32(npfb))
                bi = int(np.rint(bf))
                if run:
                    rate, dl, v0, ran = rn, dn, v0n, one
                ran = max(ran, f32(0.0))
                decim = 1 if decim == k_out else decim + 1
                o = t * max_out + e
                y_re[ch, o] = f32(mf_re * inv_k)
                y_im[ch, o] = f32(mf_im * inv_k)
                valid[ch, o] = True
                e += 1
            tau = f32(tau - one)
            bf = f32(bf - f32(npfb))
            bi -= npfb
        fs[:, ch] = (tau, rate, dl, v0, bf, ran)
        is_[:, ch] = (bi, decim)
    return y_re, y_im, valid, fs, is_


@pytest.mark.parametrize("P,k,k_out,locked,bw,stale", [
    (2, 2, 1, False, 0.02, False), (1, 2, 1, False, 0.02, True),
    (2, 2, 1, True, 0.02, True), (2, 3, 2, False, 0.05, True),
    (2, 3, 1, False, 0.3, True), (1, 4, 1, False, 0.3, False)])
def test_symsync_emit_loop_identity(P, k, k_out, locked, bw, stale):
    B, Tc, npfb = 4, 200, 32
    max_out = int(np.ceil(k / k_out)) + 1
    ma, fs, is_ = _sync_case(7 * k + P, P, B, Tc, npfb, k, stale)
    kw = dict(npfb=npfb, max_out=max_out, k=k, k_out=k_out, bw=bw,
              locked=locked)
    y_re, y_im, valid, fs2, is2 = sk.symsync_scan_reference(ma, fs, is_, **kw)
    assert 0 < int(valid.sum()) < valid.numel()
    got = _kernel_emits(ma, fs, is_, **kw)
    np.testing.assert_array_equal(got[2], valid.numpy())
    np.testing.assert_array_equal(got[0], y_re.numpy())
    np.testing.assert_array_equal(got[1], y_im.numpy())
    np.testing.assert_array_equal(got[3].view(np.int32),
                                  fs2.numpy().view(np.int32))
    np.testing.assert_array_equal(got[4], is2.numpy())


@pytest.mark.parametrize("P,k,k_out", [(2, 2, 1), (1, 2, 1), (2, 3, 2),
                                       (2, 4, 1)])
def test_symsync_valid_mask_falls_within_a_step(P, k, k_out):
    # from a state that a run leaves (bi = round(tau*npfb)): once an emit of
    # a step is inactive, so is every later one
    B, Tc, npfb = 4, 256, 32
    max_out = int(np.ceil(k / k_out)) + 1
    ma, fs, is_ = _sync_case(3 * k + P, P, B, Tc, npfb, k, False)
    valid = sk.symsync_scan_reference(ma, fs, is_, npfb=npfb, max_out=max_out,
                                      k=k, k_out=k_out, bw=0.05,
                                      locked=False)[2]
    v = valid.reshape(B, Tc, max_out).to(torch.int8)
    assert bool((v[..., 1:] <= v[..., :-1]).all())
