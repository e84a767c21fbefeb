"""The two equalizer kernels' layouts, walked in float32 numpy.

* `csrc/eqlms_scan.cu`: a warp holds 32/LM channels of LM lanes (LM =
  `lanes(L)`, 8, 16 or 32); lane j keeps tap j of w and of the window
  (zero from L on, and on a channel past B).  Samples come a tile of LM:
  lane j loads sample t0 + j, each step takes its sample from lane s, the
  window shifts down one lane with the new sample in lane L-1 and the
  oldest taken from lane 0, the dot is the width-LM xor butterfly, lane s
  keeps step s's output; a last ragged tile runs the same step.  The walk
  equals `eqlms_scan_reference` bit for bit in each mode.
* `csrc/eqrls_scan.cu`: the same lanes and tiles; lane i keeps row i of
  P, gathers the window from the lanes, forms Px_i as its own tree over
  the row, and takes y, den and every column sum r_l as xor butterflies
  over the lanes.  The walk equals `eqrls_scan_reference` bit for bit.
* Why r is the column product buf^H P: after 200 steps P is not exactly
  Hermitian, and the walk with r taken as (P buf)^H gives another P.

Change a kernel's loop only together with its walk here."""
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu_torch.ops.kernels.eqlms_scan import (
    QPSK_SCALE, eqlms_scan_reference, lanes)
from liquid_dsp_tpu_torch.ops.kernels.eqrls_scan import (
    eqrls_scan_reference, rls_consts)
from liquid_dsp_tpu_torch.ops.kernels.symsync_scan import fma32

F32 = np.float32
LANE = np.arange(32)


def shfl(v, src, width):
    """__shfl_sync(v, src, width): lane k reads lane src of its segment."""
    return v[..., LANE // width * width + src % width]


def shfl_down(v, delta, width):
    """__shfl_down_sync: lane k reads lane k + delta inside its segment,
    else keeps its own value."""
    up = v[..., np.minimum(LANE + delta, 31)]
    return np.where(LANE % width + delta < width, up, v)


def butterfly(v, width):
    """The xor butterfly over a segment, each level rounded once."""
    o = width // 2
    while o:
        v = v + v[..., LANE ^ o]
        o //= 2
    return v


def fma(a, b, c):
    return fma32(*(torch.from_numpy(np.asarray(t, F32)) for t in (a, b, c))
                 ).numpy()


def slicer(v, sc):
    return np.where(v > 0, F32(sc), np.where(v < 0, F32(-sc), F32(0)))


def _lanes_of(B, LM, blk):
    """(channel, live, tap) of the 32 lanes of warp `blk`."""
    ch = blk * (32 // LM) + LANE // LM
    live = ch < B
    return np.minimum(ch, B - 1), live, LANE % LM


def _load(a, ch, idx, ok):
    """Per lane a[ch, idx] as (re, im) float32 planes, zero where not ok."""
    v = a[ch, np.minimum(idx, a.shape[1] - 1)]
    re = np.where(ok, np.real(v), 0).astype(F32)
    im = np.where(ok, np.imag(v), 0).astype(F32)
    return re, im


def lms_walk(x, w, buf, x2, n, mu, d):
    """eqlms_scan.cu on rows x [B, T] from the carry (w, buf [B, L], x2
    [B], n [B]); trained with d, else the default slicer."""
    B, T = x.shape
    L = w.shape[1]
    LM = lanes(L)
    cplx = np.iscomplexobj(w)
    sc = QPSK_SCALE if cplx else 1.0
    y = np.zeros((B, T), w.dtype)
    w2, b2 = np.array(w), np.array(buf)
    x22, n2 = np.array(x2), np.array(n)
    for blk in range(-(-B // (32 // LM))):
        ch, live, j = _lanes_of(B, LM, blk)
        wr, wi = _load(w, ch, j, live & (j < L))
        br, bi = _load(buf, ch, j, live & (j < L))
        s2 = np.where(live, x2[ch], 0).astype(F32)
        cnt = np.where(live, n[ch], 0).astype(np.int32)
        newest, ahead = j == L - 1, j < L - 1

        def tile(t0):
            ok = live & (t0 + j < T)
            return _load(x, ch, t0 + j, ok) + (
                _load(d, ch, t0 + j, ok) if d is not None
                else (np.zeros(32, F32),) * 2)

        keep = np.zeros((2, 32), F32)
        for t0 in range(0, T, LM):
            xr_t, xi_t, dr_t, di_t = tile(t0)
            for s in range(min(LM, T - t0)):
                xr, xi = shfl(xr_t, s, LM), shfl(xi_t, s, LM)
                orr, oi = shfl(br, 0, LM), shfl(bi, 0, LM)
                ur, ui = shfl_down(br, 1, LM), shfl_down(bi, 1, LM)
                br = np.where(newest, xr, np.where(ahead, ur, F32(0)))
                bi = np.where(newest, xi, np.where(ahead, ui, F32(0)))
                s2 = (s2 + fma(xr, xr, xi * xi)) - fma(orr, orr, oi * oi)
                cnt = cnt + 1
                g = np.where(cnt >= L, F32(mu), F32(0)) / np.maximum(
                    s2, F32(1e-12))
                yr = butterfly(wr * br + wi * bi, LM)
                yi = butterfly(wr * bi - wi * br, LM)
                if d is not None:
                    tr, ti = shfl(dr_t, s, LM), shfl(di_t, s, LM)
                else:
                    tr, ti = slicer(yr, sc), slicer(yi, sc)
                ger, gei = g * (tr - yr), g * (ti - yi)
                wr = wr + (ger * br + gei * bi)
                wi = wi + (ger * bi - gei * br)
                keep = np.where(j == s, np.stack([yr, yi]), keep)
            for k in np.flatnonzero(live & (t0 + j < T)):
                y[ch[k], t0 + j[k]] = keep[0, k] + 1j * keep[1, k] \
                    if cplx else keep[0, k]
        for k in np.flatnonzero(live & (j < L)):
            w2[ch[k], j[k]] = wr[k] + 1j * wi[k] if cplx else wr[k]
            b2[ch[k], j[k]] = br[k] + 1j * bi[k] if cplx else br[k]
        for k in np.flatnonzero(live & (j == 0)):
            x22[ch[k]], n2[ch[k]] = s2[k], cnt[k]
    return y, w2, b2, x22, n2


def rls_walk(x, d, w, buf, P, lam, hermitian_shortcut=False):
    """eqrls_scan.cu on rows x, d [B, T] from the carry (w, buf [B, L],
    P [B, L, L]); with `hermitian_shortcut` r is taken as (P buf)^H."""
    B, T = x.shape
    L = w.shape[1]
    LM = lanes(L)
    cplx = np.iscomplexobj(w)
    lf, il = (F32(v) for v in rls_consts(lam))
    y = np.zeros((B, T), w.dtype)
    w2, b2, P2 = np.array(w), np.array(buf), np.array(P)
    for blk in range(-(-B // (32 // LM))):
        ch, live, i = _lanes_of(B, LM, blk)
        mine = live & (i < L)
        wr, wi = _load(w, ch, i, mine)
        br, bi = _load(buf, ch, i, mine)
        rows = [_load(P[:, :, min(l, L - 1)], ch, i, mine & (l < L))
                for l in range(LM)]
        pr = np.stack([r[0] for r in rows], -1)       # [lane, l]
        pi = np.stack([r[1] for r in rows], -1)
        newest, ahead = i == L - 1, i < L - 1
        keep = np.zeros((2, 32), F32)
        for t0 in range(0, T, LM):
            ok = live & (t0 + i < T)
            xr_t, xi_t = _load(x, ch, t0 + i, ok)
            dr_t, di_t = _load(d, ch, t0 + i, ok)
            for s in range(min(LM, T - t0)):
                xr, xi = shfl(xr_t, s, LM), shfl(xi_t, s, LM)
                dr, di = shfl(dr_t, s, LM), shfl(di_t, s, LM)
                ur, ui = shfl_down(br, 1, LM), shfl_down(bi, 1, LM)
                br = np.where(newest, xr, np.where(ahead, ur, F32(0)))
                bi = np.where(newest, xi, np.where(ahead, ui, F32(0)))
                vr = np.stack([shfl(br, jj, LM) for jj in range(LM)], -1)
                vi = np.stack([shfl(bi, jj, LM) for jj in range(LM)], -1)
                qr, qi = pr * vr - pi * vi, pr * vi + pi * vr
                o = LM // 2
                while o:
                    qr, qi = qr[:, :o] + qr[:, o:2 * o], qi[:, :o] + \
                        qi[:, o:2 * o]
                    o //= 2
                pxr, pxi = qr[:, 0], qi[:, 0]
                yr = butterfly(wr * br + wi * bi, LM)
                yi = butterfly(wr * bi - wi * br, LM)
                er, ei = dr - yr, di - yi
                q = butterfly(br * pxr + bi * pxi, LM)
                rden = F32(1) / (q + lf)
                kr, ki = pxr * rden, pxi * rden
                wr = wr + (kr * er + ki * ei)
                wi = wi + (ki * er - kr * ei)
                if hermitian_shortcut:
                    # r_l = conj(Px_l): lane l's Px, taken by every lane
                    rr = np.stack([shfl(pxr, ll, LM) for ll in range(LM)],
                                  -1)
                    ri = -np.stack([shfl(pxi, ll, LM) for ll in range(LM)],
                                   -1)
                else:
                    rr = butterfly((br[:, None] * pr + bi[:, None] * pi).T,
                                   LM).T
                    ri = butterfly((br[:, None] * pi - bi[:, None] * pr).T,
                                   LM).T
                pr = (pr - (kr[:, None] * rr - ki[:, None] * ri)) * il
                pi = (pi - (kr[:, None] * ri + ki[:, None] * rr)) * il
                keep = np.where(i == s, np.stack([yr, yi]), keep)
            for k in np.flatnonzero(ok):
                y[ch[k], t0 + i[k]] = keep[0, k] + 1j * keep[1, k] \
                    if cplx else keep[0, k]
        for k in np.flatnonzero(mine):
            c, r = ch[k], i[k]
            w2[c, r] = wr[k] + 1j * wi[k] if cplx else wr[k]
            b2[c, r] = br[k] + 1j * bi[k] if cplx else br[k]
            P2[c, r] = (pr[k, :L] + 1j * pi[k, :L]) if cplx else pr[k, :L]
    return y, w2, b2, P2


def _equal(got, want):
    for g, w_ in zip(got, want):
        w_ = w_.numpy() if isinstance(w_, torch.Tensor) else w_
        assert g.shape == w_.shape and g.dtype == w_.dtype
        assert np.array_equal(np.asarray(g).view(np.uint8),
                              np.ascontiguousarray(w_).view(np.uint8))


def _carry(rng, B, L, cplx):
    w = tp.cnoise(rng, (B, L)) * 0.3
    buf = tp.cnoise(rng, (B, L))
    if not cplx:
        w, buf = w.real.copy(), buf.real.copy()
    x2 = np.sum(np.abs(buf) ** 2, -1).astype(F32)
    n = rng.integers(0, 2 * L, B).astype(np.int32)
    return w, buf, x2, n


@pytest.mark.parametrize("L,B,T", [(1, 5, 21), (5, 3, 40), (13, 3, 70),
                                   (16, 2, 33), (17, 2, 50), (32, 1, 65)])
@pytest.mark.parametrize("mode", ["trained", "decision", "decision_real"])
def test_eqlms_walk_equals_plain(mode, L, B, T):
    rng = np.random.default_rng(L * 7 + B)
    cplx = mode != "decision_real"
    w, buf, x2, n = _carry(rng, B, L, cplx)
    x, d = tp.cnoise(rng, (B, T)), tp.cnoise(rng, (B, T))
    if not cplx:
        x, d = x.real.copy(), d.real.copy()
    d = d if mode == "trained" else None
    mu = 0.3
    got = lms_walk(x, w, buf, x2, n, mu, d)
    t = torch.from_numpy
    want = eqlms_scan_reference(t(x), t(w), t(buf), t(x2), t(n), mu,
                                None if d is None else t(d))
    _equal(got, want)


@pytest.mark.parametrize("L,B,T", [(1, 5, 21), (5, 3, 40), (9, 3, 70),
                                   (16, 2, 33), (32, 1, 40)])
@pytest.mark.parametrize("cplx", [True, False])
def test_eqrls_walk_equals_plain(L, B, T, cplx):
    rng = np.random.default_rng(L * 11 + B)
    w, buf, _, _ = _carry(rng, B, L, cplx)
    x, d = tp.cnoise(rng, (B, T)), tp.cnoise(rng, (B, T))
    P = np.broadcast_to(np.eye(L, dtype=np.complex64) * 10, (B, L, L)).copy()
    P += 0.01 * tp.cnoise(rng, (B, L, L))
    if not cplx:
        x, d, P = x.real.copy(), d.real.copy(), P.real.copy()
    t = torch.from_numpy
    got = rls_walk(x, d, w, buf, P, 0.99)
    want = eqrls_scan_reference(t(x), t(d), t(w), t(buf), t(P), 0.99)
    _equal(got, want)


def test_rls_p_is_not_exactly_hermitian():
    # from a Hermitian start (I / delta) the update's roundings leave P
    # off Hermitian, so buf^H P (the column product) and (P buf)^H differ,
    # and a kernel built on the shortcut would compute another function
    L, B, T = 9, 2, 200
    rng = np.random.default_rng(3)
    h = np.array([1.0, 0.0, -0.25 + 0.2j, 0.0, 0.1], np.complex64)
    d = ((np.sign(rng.standard_normal((B, T))) + 1j * np.sign(
        rng.standard_normal((B, T)))) * np.sqrt(0.5)).astype(np.complex64)
    x = np.stack([np.convolve(r, h)[:T] for r in d]).astype(np.complex64)
    w = np.zeros((B, L), np.complex64)
    w[:, 0] = 1
    buf = np.zeros((B, L), np.complex64)
    P = np.broadcast_to(np.eye(L, dtype=np.complex64) * 10, (B, L, L)).copy()
    y, _, _, P2 = rls_walk(x, d, w, buf, P, 0.99)
    asym = np.abs(P2 - np.conj(np.swapaxes(P2, -1, -2))).max()
    assert 0 < asym < 1e-5 * np.abs(P2).max()
    y_s, _, _, P_s = rls_walk(x, d, w, buf, P, 0.99, hermitian_shortcut=True)
    assert not np.array_equal(P_s, P2)
    t = torch.from_numpy
    _equal((y, P2), [eqrls_scan_reference(t(x), t(d), t(w), t(buf), t(P),
                                          0.99)[k] for k in (0, 3)])
