"""The two equalizer kernels' layouts, walked in float32 numpy.

* `csrc/eqlms_scan.cu`: a warp holds 32/LM channels of LM lanes (LM =
  `lanes(L)`, 8, 16 or 32); lane j keeps tap j of w (zero from L on, and
  on a channel past B).  Samples come a tile of LM: lane j loads sample
  t0 + j two tiles ahead, the tile is staged into shared memory behind LM
  samples of history, and each step reads its window entry there.  Every
  lane runs the next tile's x2 running sum beside the current tile's
  steps (the powers from lane s by shuffles) and keeps the value after
  its own step; each tile starts with one division a lane for its gain,
  which step s takes from lane s.  The dot's products go through shared
  memory and every lane sums all of its channel's in the butterfly's
  order; lane s keeps step s's output; a last ragged tile runs the same
  step.  The walk equals `eqlms_scan_reference` bit for bit in each mode.
* `csrc/eqrls_scan.cu`: a channel takes LM row lanes times H halves (H =
  2 at 2 <= L <= 16, else 1); lane (h, i) keeps columns h, h + H, ... of
  row i (only the L live ones).  The window and d come from the staged
  tile; each lane writes its row's products conj(buf_i) P_il to shared
  memory, lane l sums column l (`live_tree`) and writes r_l, each lane
  reads its columns' r back; Px_i is each half's live tree (a half's
  missing last column skipped) plus the other half's by one shuffle; y
  and den are xor butterflies over the LM rows.  The walk equals
  `eqrls_scan_reference` bit for bit.
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


def pow2(re, im):
    """|v|^2 as the kernels form it: one fused multiply-add."""
    return fma(re, re, im * im)


def tree(v, dead=None):
    """The butterfly's levels over the last axis's live entries (the
    kernels' live_tree and, for a power of two, lane_tree); with `dead`
    (per lane) the last entry holds no value and its one add is
    skipped."""
    v = np.array(v)
    N = n = v.shape[-1]
    o = (1 << (N - 1).bit_length()) // 2 if N > 1 else 0
    while o:
        for j in range(o):
            if j + o < n:
                s = v[..., j] + v[..., j + o]
                if j + o == N - 1 and dead is not None:
                    s = np.where(dead, v[..., j], s)
                v[..., j] = s
        n = min(n, o)
        o //= 2
    return v[..., 0]


def lms_walk(x, w, buf, x2, n, mu, d):
    """eqlms_scan.cu on rows x [B, T] from the carry (w, buf [B, L], x2
    [B], n [B]); trained with d, else the default slicer.  Per warp: the
    shared window (LM samples of history, then the tile), the gains of
    each tile from a running sum that every lane runs a tile ahead (the
    powers from lane s by shuffles; one division a lane), the dot's
    products through shared memory summed by every lane in the
    butterfly's order."""
    B, T = x.shape
    L = w.shape[1]
    LM = lanes(L)
    G = 32 // LM
    cplx = np.iscomplexobj(w)
    sc = QPSK_SCALE if cplx else 1.0
    y = np.zeros((B, T), w.dtype)
    w2, b2 = np.array(w), np.array(buf)
    x22, n2 = np.array(x2), np.array(n)
    zero = np.zeros(32, F32)
    for blk in range(-(-B // G)):
        ch, live, j = _lanes_of(B, LM, blk)
        g = LANE // LM
        tap = j < L
        wr, wi = _load(w, ch, j, live & tap)
        br, bi = _load(buf, ch, j, live & tap)
        x2_in = np.where(live, x2[ch], 0).astype(F32)
        n0 = np.where(live, n[ch], 0).astype(np.int64)
        xs = np.zeros((2, G, 2 * LM), F32)         # (re, im), channel, slot
        xs[:, g[tap], (LM - L + j)[tap]] = np.stack([br, bi])[:, tap]
        win = LM - L + 1 + np.where(tap, j, L - 1)
        ps = np.zeros((2, G, 2, LM), F32)          # (re, im), channel, parity
        st = {"w": (wr, wi), "b": (br, bi), "keep": np.zeros((2, 32), F32)}

        def tile(t0):
            ok = live & (t0 + j < T)
            return np.stack(_load(x, ch, t0 + j, ok)), np.stack(
                _load(d, ch, t0 + j, ok) if d is not None else (zero, zero))

        def stage(first, xprev, xv):
            if not first:
                xs[:, g, j] = xprev
            xs[:, g, LM + j] = xv

        def run_step(A, P, run, mine, s):
            run = (run + shfl(A, s, LM)) - shfl(P, s, LM)
            return run, np.where(j == s, run, mine)

        def step(s, gs, dv):
            wr, wi = st["w"]
            br, bi = np.where(tap, xs[:, g, win + s], F32(0))
            ps[:, g, s & 1, j] = np.stack([wr * br + wi * bi,
                                           wr * bi - wi * br])
            yr, yi = tree(ps[0, g, s & 1]), tree(ps[1, g, s & 1])
            if d is not None:
                tr, ti = shfl(dv[0], s, LM), shfl(dv[1], s, LM)
            else:
                tr, ti = slicer(yr, sc), slicer(yi, sc)
            ger, gei = gs * (tr - yr), gs * (ti - yi)
            st["w"] = (wr + (ger * br + gei * bi), wi + (ger * bi - gei * br))
            st["b"] = (br, bi)
            st["keep"] = np.where(j == s, np.stack([yr, yi]), st["keep"])

        def gains(t0, x2m):
            return np.where(n0 + t0 + j + 1 >= L, F32(mu), F32(0)) / \
                np.maximum(x2m, F32(1e-12))

        def out(t0, cnt):
            for k in np.flatnonzero(live & (j < cnt)):
                v = st["keep"][:, k]
                y[ch[k], t0 + j[k]] = v[0] + 1j * v[1] if cplx else v[0]

        (xc, dc), (xn, dn) = tile(0), tile(LM)
        Ac = pow2(*xc)
        P = np.where(tap, pow2(br, bi), shfl(Ac, np.maximum(j - L, 0), LM))
        run, x2m = x2_in, zero
        for s in range(LM):
            run, x2m = run_step(Ac, P, run, x2m, s)
        x2_out, xprev = x2_in, None
        full = T // LM * LM
        for t0 in range(0, full, LM):
            gm = gains(t0, x2m)
            x2_out = run
            xnn, dnn = tile(t0 + 2 * LM)
            An = pow2(*xn)
            Pn = np.where(j >= L, shfl(An, np.maximum(j - L, 0), LM),
                          shfl(Ac, np.where(j < L, LM + j - L, 0), LM))
            stage(t0 == 0, xprev, xc)
            x2m_next = zero
            for s in range(LM):
                step(s, shfl(gm, s, LM), dc)
                run, x2m_next = run_step(An, Pn, run, x2m_next, s)
            out(t0, LM)
            xprev, xc, dc, xn, dn = xc, xn, dn, xnn, dnn
            Ac, x2m = An, x2m_next
        rem = T - full
        if rem:
            gm = gains(full, x2m)
            stage(full == 0, xprev, xc)
            for s in range(rem):
                step(s, shfl(gm, s, LM), dc)
            out(full, rem)
            x2_out = shfl(x2m, rem - 1, LM)
        wr, wi = st["w"]
        br, bi = st["b"]
        for k in np.flatnonzero(live & tap):
            w2[ch[k], j[k]] = wr[k] + 1j * wi[k] if cplx else wr[k]
            b2[ch[k], j[k]] = br[k] + 1j * bi[k] if cplx else br[k]
        for k in np.flatnonzero(live & (j == 0)):
            x22[ch[k]], n2[ch[k]] = x2_out[k], n0[k] + T
    return y, w2, b2, x22, n2


def rls_walk(x, d, w, buf, P, lam, hermitian_shortcut=False):
    """eqrls_scan.cu on rows x, d [B, T] from the carry (w, buf [B, L],
    P [B, L, L]), H = 2 lanes a row at 2 <= L <= 16, else 1: lane (h, i)
    keeps columns h, h + H, ... of row i; the
    shared window; each row's products conj(buf_i) P_il through shared
    memory, lane l summing column l; Px_i as each half's live tree and
    one shuffle.  With `hermitian_shortcut` r is taken as (P buf)^H."""
    B, T = x.shape
    L = w.shape[1]
    H = 2 if 2 <= L <= 16 else 1
    LM = lanes(L)
    CW = LM * H
    G = 32 // CW
    CH = -(-L // H)
    CHP = CH + (CH & 1)
    PITCH = L | 1
    cplx = np.iscomplexobj(w)
    lf, il = (F32(v) for v in rls_consts(lam))
    y = np.zeros((B, T), w.dtype)
    w2, b2, P2 = np.array(w), np.array(buf), np.array(P)
    c = LANE % CW
    g = LANE // CW
    i, h = c % LM, c // LM
    row = i < L
    dead = (H == 2) & (L % 2 == 1) & (h == 1)
    cols = h[:, None] + H * np.arange(CH)             # [lane, slot]
    # the slots that hold a column: all but a dead lane's last
    held = ~(dead[:, None] & (np.arange(CH) == CH - 1))
    for blk in range(-(-B // G)):
        ch = blk * G + g
        live = ch < B
        ch = np.minimum(ch, B - 1)
        wr, wi = _load(w, ch, i, live & row)
        ok = (live & row)[:, None] & (cols < L)
        Pv = P[ch[:, None], np.minimum(i, L - 1)[:, None],
               np.minimum(cols, L - 1)]
        pr = np.where(ok, np.real(Pv), 0).astype(F32)
        pi = np.where(ok, np.imag(Pv), 0).astype(F32)
        xs = np.zeros((2, G, LM + CW + 2), F32)
        ds = np.zeros((2, G, CW), F32)
        ps = np.zeros((2, G, 2, LM * PITCH), F32)
        rs = np.zeros((2, G, 2, H * CHP), F32)
        first = live & (c < L)
        xs[:, g[first], LM - L + c[first]] = np.stack(
            _load(buf, ch, c, first))[:, first]
        st = {"w": (wr, wi), "P": (pr, pi), "b": (np.zeros(32, F32),) * 2,
              "keep": np.zeros((2, 32), F32)}

        def step(s):
            wr, wi = st["w"]
            pr, pi = st["P"]
            b = s & 1
            base = LM + s - L + 1
            br, bi = np.where(row, xs[:, g, base + np.where(row, i, L - 1)],
                              F32(0))
            vr, vi = xs[:, g[:, None], base + cols]
            dr, di = ds[:, g, s]
            # r: the rows' products, lane l's column sum, each lane's
            # columns read back
            prod = np.stack([br[:, None] * pr + bi[:, None] * pi,
                             br[:, None] * pi - bi[:, None] * pr])
            at = (i * PITCH)[:, None] + cols
            for a in range(CH):
                k = held[:, a]
                ps[:, g[k], b, at[k, a]] = prod[:, k, a]
            ll = np.where(c < L, c, L - 1)
            col = ps[:, g[:, None], b, np.arange(L) * PITCH + ll[:, None]]
            rr_l, ri_l = tree(col[0]), tree(col[1])
            k = c < L
            rs[:, g[k], b, (c % H * CHP + c // H)[k]] = np.stack(
                [rr_l, ri_l])[:, k]
            rr, ri = rs[:, g[:, None], b, (h * CHP)[:, None] + np.arange(CH)]
            # Px_i: this half's live tree, then the other half's
            pxr = tree(pr * vr - pi * vi, dead)
            pxi = tree(pr * vi + pi * vr, dead)
            if H == 2:
                pxr, pxi = pxr + pxr[LANE ^ LM], pxi + pxi[LANE ^ LM]
            yr = butterfly(wr * br + wi * bi, LM)
            yi = butterfly(wr * bi - wi * br, LM)
            er, ei = dr - yr, di - yi
            q = butterfly(br * pxr + bi * pxi, LM)
            rden = F32(1) / (q + lf)
            kr, ki = pxr * rden, pxi * rden
            st["w"] = (wr + (kr * er + ki * ei), wi + (ki * er - kr * ei))
            if hermitian_shortcut:
                # r_l = conj(Px_l): row l's Px, taken by every lane
                src = (g * CW)[:, None] + np.minimum(cols, L - 1)
                rr, ri = pxr[src], -pxi[src]
            kr, ki = kr[:, None], ki[:, None]
            st["P"] = ((pr - (kr * rr - ki * ri)) * il,
                       (pi - (kr * ri + ki * rr)) * il)
            st["b"] = (br, bi)
            st["keep"] = np.where(c == s, np.stack([yr, yi]), st["keep"])

        def stage(first, xprev, xv, dv):
            if not first:
                k = c >= CW - LM
                xs[:, g[k], (c - (CW - LM))[k]] = xprev[:, k]
            xs[:, g, LM + c] = xv
            ds[:, g, c] = dv

        def out(t0, cnt):
            for k in np.flatnonzero(live & (c < cnt)):
                v = st["keep"][:, k]
                y[ch[k], t0 + c[k]] = v[0] + 1j * v[1] if cplx else v[0]

        xprev = None
        for t0 in range(0, T, CW):
            cnt = min(CW, T - t0)
            ok = live & (t0 + c < T)
            stage(t0 == 0, xprev, np.stack(_load(x, ch, t0 + c, ok)),
                  np.stack(_load(d, ch, t0 + c, ok)))
            xprev = np.stack(_load(x, ch, t0 + c, ok))
            for s in range(cnt):
                step(s)
            out(t0, cnt)
        wr, wi = st["w"]
        pr, pi = st["P"]
        br, bi = st["b"]
        for k in np.flatnonzero(live & row):
            if h[k] == 0:
                w2[ch[k], i[k]] = wr[k] + 1j * wi[k] if cplx else wr[k]
                b2[ch[k], i[k]] = br[k] + 1j * bi[k] if cplx else br[k]
            for a in range(CH):
                if cols[k, a] < L:
                    v = pr[k, a] + 1j * pi[k, a] if cplx else pr[k, a]
                    P2[ch[k], i[k], cols[k, a]] = v
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


@pytest.mark.parametrize("L,B,T", [(1, 5, 21), (5, 3, 40), (8, 5, 43),
                                   (9, 3, 37), (13, 3, 70), (16, 2, 33),
                                   (17, 2, 50), (32, 1, 65)])
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


@pytest.mark.parametrize("L,B,T", [(1, 5, 21), (2, 3, 19), (5, 3, 40),
                                   (8, 3, 35), (9, 3, 70), (16, 2, 33),
                                   (17, 2, 41), (32, 1, 40)])
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
