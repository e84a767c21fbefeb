"""The identities the two IIR recurrence kernels rest on, walked in numpy.

* The block form (`ops/iir.py`, `_block_mats` and `_block_rows`; the state
  pass is `csrc/iir_block_state.cu`): over blocks of L samples,
  y = Th u + Obs s and s' = A^L s + K u reproduce the per-sample DF2T
  recurrence exactly, the carry being the stacked section states; shown
  in float64 for the transfer-function form and for cascades of order 1
  to 8 over several blocks and a ragged remainder (to 1e-9 of rms).
* `csrc/iir_scan.cu`'s chain lane on its row (staged tiles of one
  128-byte line, 32 float or 16 complex samples; a whole tile's samples
  loaded, then stepped; a last ragged tile sample by sample; the products
  of complex values on the planes) in float32 numpy equals
  `iir_scan_reference` bit for bit.
* `csrc/iir_block_state.cu`'s lanes on a row (P' lanes, P' the next power
  of two >= p; lane q holds row q of M and state q, saves its state, then
  takes the row's states from lanes 0 .. p-1 as a width-P' shuffle gives
  them and forms its p-term dot in order and + w; lanes q >= p idle, and
  read the w of lane p-1) in float32 numpy equals
  `iir_block_state_reference` bit for bit.
* `csrc/iir_pscan.cu`'s block on a row (a ring of two tiles of C * NT
  samples in shared memory at swizzled 16-byte units, tile t + 1 copied
  in before tile t's walks; a chunk of C a thread, lane l of warp w
  holding chunk 32 w + l; per section the walk from zero, thread 0 from
  the carry; the combine by shuffles in each warp, the warps' totals
  through a shared buffer that alternates by section, their scan by
  shuffles in every warp, each chunk's start W_{l-1} + M^(C l) G_{w-1};
  section k's re-walk and section k + 1's walk in one pass; the carry from
  the thread with the tile's last sample; every a*b + c one exact fused
  multiply-add) in float32 numpy equals `iir_pscan_reference` bit for bit
  at several chunks, warps and tiles; a full tile's unpredicated path
  equals the predicated one; and the swizzled tile's copies, chunk reads
  and output reads of each quarter warp fall in distinct bank groups.

Change a kernel's loop only together with its walk here."""
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch thread cap)
from liquid_dsp_tpu_torch.design.iirdes import iirdes, iirdes_sos
from liquid_dsp_tpu_torch.ops import iir
from liquid_dsp_tpu_torch.ops.kernels.iir_block_state import (
    iir_block_state_reference)
from liquid_dsp_tpu_torch.ops.kernels.iir_pscan import (CHUNK, LANES,
                                                        THREADS,
                                                        iir_pscan_reference)
from liquid_dsp_tpu_torch.ops.kernels.iir_scan import iir_scan_reference

F32 = np.float32


def df2t64(B, A, x, s):
    """The per-sample DF2T cascade in float64: B, A [ns, n], x [T],
    s [ns, n-1] -> (y, s')."""
    s = s.astype(np.complex128).copy()
    y = np.empty(len(x), np.complex128)
    for t, v in enumerate(x):
        for k in range(B.shape[0]):
            yk = B[k, 0] * v + s[k, 0]
            d = B[k, 1:] * v - A[k, 1:] * yk
            s[k, :-1] = d[:-1] + s[k, 1:]
            s[k, -1] = d[-1]
            v = yk
        y[t] = v
    return y, s


def block_walk64(ss, L, x, s):
    """The block form in float64 on one row: per whole block the matrix
    products and the state step, then the remainder."""
    A, Bv, C, D = ss
    p = A.shape[0]
    Apow = [np.eye(p)]
    for _ in range(L):
        Apow.append(Apow[-1] @ A)
    h = np.array([D] + [C @ Apow[i] @ Bv for i in range(L - 1)])
    Th = np.array([[h[i - k] if i >= k else 0.0 for k in range(L)]
                   for i in range(L)])
    Obs = np.array([C @ Apow[i] for i in range(L)])
    K = np.array([Apow[L - 1 - i] @ Bv for i in range(L)]).T
    y = []
    nb, r = divmod(len(x), L)
    for n in range(nb):
        u = x[n * L:(n + 1) * L]
        y.append(Th @ u + Obs @ s)
        s = Apow[L] @ s + K @ u
    if r:
        u = x[nb * L:]
        y.append(Th[:r, :r] @ u + Obs[:r] @ s)
        s = Apow[r] @ s + K[:, L - r:] @ u
    return np.concatenate(y), s


FILTERS = ([("sos", ("butter", n, 0.17)) for n in range(1, 9)]
           + [("tf", ("cheby1", 5, 0.2)), ("tf", ("ellip", 4, 0.25)),
              ("sos", ("ellip", 6, 0.3))])


@pytest.mark.parametrize("form,design", FILTERS)
@pytest.mark.parametrize("L,T", [(16, 100), (32, 96), (7, 5)])
def test_block_form_reproduces_the_per_sample_recurrence(form, design, L,
                                                         T):
    rng = np.random.default_rng(L + T)
    if form == "sos":
        B, A = iirdes_sos(*design)
        ss = iir._ss_cascade([iir._df2t_ss(B[k], A[k])
                              for k in range(B.shape[0])])
    else:
        b, a = iirdes(*design)
        B, A = b[None], a[None]
        ss = iir._df2t_ss(b, a)
    x = rng.standard_normal(T)
    s0 = rng.standard_normal((B.shape[0], B.shape[1] - 1))
    y_ref, s_ref = df2t64(B, A, x, s0)
    y, s = block_walk64(ss, L, x, s0.reshape(-1))
    rms = np.sqrt(np.mean(np.abs(y_ref) ** 2))
    assert np.abs(y - y_ref).max() < 1e-9 * rms
    # the carry IS the stacked per-section DF2T states
    assert np.abs(s - s_ref.reshape(-1)).max() < 1e-9 * rms


def _cmul(a, b):
    return (F32(a[0] * b[0]) - F32(a[1] * b[1]),
            F32(a[0] * b[1]) + F32(a[1] * b[0]))


def _ops(cplx):
    if cplx:
        return (_cmul, lambda a, b: (F32(a[0] + b[0]), F32(a[1] + b[1])),
                lambda a, b: (F32(a[0] - b[0]), F32(a[1] - b[1])))
    return ((lambda a, b: F32(a * b)), (lambda a, b: F32(a + b)),
            (lambda a, b: F32(a - b)))


def _val(z, cplx):
    return (F32(z.real), F32(z.imag)) if cplx else F32(z)


def scan_walk(x, b, a, s, cplx):
    """csrc/iir_scan.cu's chain lane on one row, in float32 numpy:
    registers for the coefficients and the state; per staged tile of one
    line (32 float samples, 16 complex), the whole tile's samples loaded
    and then stepped, a ragged last tile sample by sample."""
    mul, add, sub = _ops(cplx)
    ns, n = b.shape
    bc = [[_val(b[k, i], cplx) for i in range(n)] for k in range(ns)]
    ac = [[_val(a[k, i], cplx) for i in range(n)] for k in range(ns)]
    st = [[_val(s[k, i], cplx) for i in range(n - 1)] for k in range(ns)]

    def step(v):
        for k in range(ns):
            yk = add(mul(bc[k][0], v), st[k][0])
            for i in range(n - 2):
                st[k][i] = add(sub(mul(bc[k][i + 1], v),
                                   mul(ac[k][i + 1], yk)), st[k][i + 1])
            st[k][n - 2] = sub(mul(bc[k][n - 1], v), mul(ac[k][n - 1], yk))
            v = yk
        return v

    T, out = len(x), []
    tile = 16 if cplx else 32
    for t0 in range(0, T, tile):
        if T - t0 >= tile:
            loaded = [_val(x[t0 + u], cplx) for u in range(tile)]
            out += [step(v) for v in loaded]
        else:
            out += [step(_val(x[u], cplx)) for u in range(t0, T)]
    if cplx:
        return (np.array([complex(*v) for v in out], np.complex64),
                np.array([[complex(*v) for v in r] for r in st],
                         np.complex64))
    return np.array(out, F32), np.array(st, F32)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("ns,n,T", [(1, 2, 21), (1, 5, 16), (3, 3, 19),
                                    (1, 9, 3), (2, 3, 75)])
def test_scan_kernel_walk_equals_plain_version(ns, n, T, cplx):
    rng = np.random.default_rng(ns * 10 + n)
    dt = np.complex64 if cplx else F32

    def draw(*shape):
        z = rng.standard_normal(shape) * 0.3
        if cplx:
            z = z + 1j * rng.standard_normal(shape) * 0.3
        return z.astype(dt)

    x, b, a, s = draw(2, T), draw(ns, n), draw(ns, n), draw(2, ns, n - 1)
    a[:, 0] = 1
    y_ref, s_ref = iir_scan_reference(*(torch.from_numpy(v)
                                        for v in (x, b, a, s)))
    for r in range(2):
        y, st = scan_walk(x[r], b, a, s[r], cplx)
        np.testing.assert_array_equal(y, y_ref[r].numpy())
        np.testing.assert_array_equal(st, s_ref[r].numpy())


def block_state_walk(w, m, s, cplx):
    """csrc/iir_block_state.cu's P' lanes on one row, in float32 numpy:
    lane q keeps M's row q and state q (zeros on an idle lane q >= p) and
    reads, for each j, the state of lane j of its row (the shuffle)."""
    mul, add, _ = _ops(cplx)
    p = m.shape[0]
    pw = 1 << (p - 1).bit_length()             # P': lanes a row
    zero = _val(0, cplx)
    mv = [[_val(m[q, j], cplx) for j in range(p)] if q < p else
          [zero] * p for q in range(pw)]
    lanes = [_val(s[q], cplx) if q < p else zero for q in range(pw)]
    pre = []
    for n in range(w.shape[0]):
        pre.append(lanes[:p])                  # the live lanes' stores
        shfl = [lanes[j] for j in range(p)]    # width-P' shuffles of s
        nxt = []
        for q in range(pw):
            acc = mul(shfl[0], mv[q][0])
            for j in range(1, p):
                acc = add(acc, mul(shfl[j], mv[q][j]))
            nxt.append(add(acc, _val(w[n, min(q, p - 1)], cplx)))
        lanes = nxt
    sv = lanes[:p]
    if cplx:
        return (np.array([[complex(*v) for v in r] for r in pre],
                         np.complex64).reshape(len(pre), p),
                np.array([complex(*v) for v in sv], np.complex64))
    return np.array(pre, F32).reshape(len(pre), p), np.array(sv, F32)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("p,nb", [(1, 9), (4, 5), (8, 3), (12, 4),
                                  (32, 3)])
def test_block_state_kernel_walk_equals_plain_version(p, nb, cplx):
    rng = np.random.default_rng(p + nb)
    dt = np.complex64 if cplx else F32

    def draw(*shape):
        z = rng.standard_normal(shape) * 0.4
        if cplx:
            z = z + 1j * rng.standard_normal(shape) * 0.4
        return z.astype(dt)

    w, m, s = draw(3, nb, p), draw(p, p), draw(3, p)
    pre_ref, s_ref = iir_block_state_reference(
        *(torch.from_numpy(v) for v in (w, m, s)))
    for r in range(3):
        pre, sv = block_state_walk(w[r], m, s[r], cplx)
        np.testing.assert_array_equal(pre, pre_ref[r].numpy())
        np.testing.assert_array_equal(sv, s_ref[r].numpy())


def _fma(a, b, c):
    """a*b + c in float32 with one rounding (``__fmaf_rn``; the plain
    version's `fma32`): the product exact in float64, a sum that lands on a
    float32 tie rounded toward the side its float64 rounding error
    points to."""
    a, b, c = (np.asarray(v, F32) for v in (a, b, c))
    p = a.astype(np.float64) * b.astype(np.float64)
    cd = c.astype(np.float64)
    s = p + cd
    z = s - p
    err = (p - (s - z)) + (cd - z)
    r = s.astype(F32)
    d = s - r.astype(np.float64)
    other = np.nextafter(r, np.where(d > 0, np.inf, -np.inf).astype(F32))
    tie = (d != 0) & (r.astype(np.float64) + other.astype(np.float64)
                      == 2.0 * s)
    return np.where(tie & (err * d > 0), other, r).astype(F32)


def _pscan_ops(cplx):
    """(val, madd, mul, pick) on float32 arrays; a complex value as a
    trailing axis of its two planes."""
    if not cplx:
        return (F32, _fma, (lambda p, q: (p * q).astype(F32)),
                (lambda m, p, q: np.where(m, p, q)))

    def madd(p, q, r):
        return np.stack([
            _fma(p[..., 0], q[..., 0], _fma(-p[..., 1], q[..., 1], r[..., 0])),
            _fma(p[..., 0], q[..., 1], _fma(p[..., 1], q[..., 0], r[..., 1]))],
            -1)

    def mul(p, q):
        return np.stack([
            _fma(p[..., 0], q[..., 0], -(p[..., 1] * q[..., 1])),
            _fma(p[..., 0], q[..., 1], p[..., 1] * q[..., 0])], -1)

    return ((lambda z: np.array([z.real, z.imag], F32)), madd, mul,
            (lambda m, p, q: np.where(np.asarray(m)[..., None], p, q)))


UPT = 4096 // THREADS   # 16-byte units of the kernel's chunk


def _swz(f):
    """The tile's layout: 16-byte unit f at f ^ ((f / UPT) & 7)."""
    return f ^ ((f // UPT) & 7)


def _phys(g):
    """Float g of a tile's row order at its word in the swizzled tile."""
    return 4 * _swz(g >> 2) + (g & 3)


def pscan_walk(x, b, a, s, cplx, C, NT, predicate_all=False):
    """csrc/iir_pscan.cu's block on one row, in float32 numpy: its threads
    as arrays, its warps as their rows.  The sections' constants and
    squared powers (thread k for section k), the lane powers (thread
    (k, l)); the ring of two swizzled tiles (NaN until copied: a ragged
    tile's chunks read stale words past the row); at the top of tile t its
    chunks read, tile t - 1's outputs out of the other buffer and tile
    t + 1 copied into it; per section the walk, the combine (shuffles in
    each warp, the totals through the buffer of the section's parity,
    their scan by warp 0, G handed on through shared memory, the start
    from the lane power), the re-walk fused with the next section's walk,
    the carry from the thread with the tile's last sample; the outputs
    into the tile, and the last tile's out after the loop.  A full tile
    takes the unpredicated path unless `predicate_all`."""
    val, madd, mul, pick = _pscan_ops(cplx)
    fps = 2 if cplx else 1
    zero, one = val(0.0), val(1.0)
    lc, lt = C.bit_length() - 1, NT.bit_length() - 1
    lanes = min(LANES, NT)
    nw, lw = NT // lanes, lanes.bit_length() - 1

    def matmul(A, B):
        return (madd(A[0], B[0], mul(A[1], B[2])),
                madd(A[0], B[1], mul(A[1], B[3])),
                madd(A[2], B[0], mul(A[3], B[2])),
                madd(A[2], B[1], mul(A[3], B[3])))

    def apply(P, f0, f1, e0, e1):
        return (madd(P[0], f0, madd(P[1], f1, e0)),
                madd(P[2], f0, madd(P[3], f1, e1)))

    sec = []
    for k in range(b.shape[0]):
        b0, b1, b2 = (val(b[k, i]) for i in range(3))
        na1, na2 = -val(a[k, 1]), -val(a[k, 2])
        m, P = (na1, one, na2, zero), []
        for i in range(lc + lt):
            if i >= lc:
                P.append(m)
            if i + 1 < lc + lt:
                m = matmul(m, m)
        Q = [(one, zero, zero, one)]
        for lane in range(1, lanes):
            lo = (lane & -lane).bit_length() - 1
            m = P[lo]
            for hb in range(lo + 1, lw):
                if lane >> hb & 1:
                    m = matmul(P[hb], m)
            Q.append(m)
        sec.append({"b0": b0, "c1": madd(na1, b0, b1),
                    "c2": madd(na2, b0, b2), "na1": na1, "na2": na2,
                    "P": P, "Q": tuple(np.array([q[i] for q in Q])
                                       for i in range(4))})
    car = [[val(s[k, 0]), val(s[k, 1])] for k in range(b.shape[0])]
    T, tile_n = len(x), C * NT
    xw = x.view(F32) if cplx else x
    words = -(-tile_n * fps // 32) * 32       # whole 128-byte lines
    ring = [np.full(words, np.nan, F32) for _ in range(2)]
    tot = np.full((2, 2, lanes) + zero.shape, np.nan, F32)
    gb = np.full((2, lanes) + zero.shape, np.nan, F32)
    yw = np.full(T * fps, np.nan, F32)
    ph = 0

    def load(buf, f0, nf):                    # the tile's coalesced copies
        g = np.arange(nf)
        ring[buf][_phys(g)] = xw[f0 + g]

    def store(buf, f0, nf):                   # the outputs' coalesced stores
        g = np.arange(nf)
        yw[f0 + g] = ring[buf][_phys(g)]

    def shfl_up(v, o):                        # v [nw, lanes, ...]
        out = v.copy()
        out[:, o:] = v[:, :-o]
        return out

    def step(e, u, K):
        return (madd(K["na1"], e[0], madd(K["c1"], u, e[1])),
                madd(K["na2"], e[0], mul(K["c2"], u)))

    def combine(e, cin, K):
        nonlocal ph
        lane = np.arange(lanes)
        W = [v.reshape((nw, lanes) + zero.shape) for v in e]
        for d in range(lw):
            o = 1 << d
            n = apply(K["P"][d], shfl_up(W[0], o), shfl_up(W[1], o), *W)
            W = [pick(lane >= o, n[i], W[i]) for i in range(2)]
        tb = tot[ph & 1]
        ph += 1
        tb[:, :nw] = np.stack([W[0][:, -1], W[1][:, -1]])   # lane 31's
        G = [np.zeros((1, lanes) + zero.shape, F32) for _ in range(2)]
        for i in range(2):                     # warp 0's lanes l < nw
            G[i][0, :nw] = tb[i, :nw]
        for d in range(lt - lw):
            o = 1 << d
            n = apply(K["P"][lw + d], shfl_up(G[0], o), shfl_up(G[1], o),
                      *G)
            G = [pick(lane >= o, n[i], G[i]) for i in range(2)]
        gb[:, :nw] = np.stack([G[0][0, :nw], G[1][0, :nw]])   # G, handed on
        p = [shfl_up(v, 1) for v in W]        # W_{l-1}
        st = [np.empty_like(v) for v in W]
        for i in range(2):
            st[i][0] = pick(lane == 0, cin[i].reshape(W[i].shape)[0],
                            p[i][0])
        if nw > 1:
            h = [gb[i, :nw - 1][:, None] for i in range(2)]   # gb[w - 1]
            m = apply(K["Q"], h[0], h[1], p[0][1:], p[1][1:])
            for i in range(2):
                st[i][1:] = pick(lane == 0, np.broadcast_to(
                    h[i], m[i].shape), m[i])
        return [v.reshape(e[0].shape) for v in st]

    load(0, 0, min(tile_n, T) * fps)
    with np.errstate(all="ignore"):
        for t, t0 in enumerate(range(0, T, tile_n)):
            n = min(tile_n, T - t0)
            cur = t & 1
            g = (np.arange(NT)[:, None] * C + np.arange(C)) * fps
            g = g[..., None] + np.arange(fps) if cplx else g
            v = ring[cur][_phys(g)]            # [NT, C(, 2)]
            if t > 0:                          # tile t - 1's outputs out
                store(1 - cur, (t0 - tile_n) * fps, tile_n * fps)
            if t0 + tile_n < T:               # the next tile, ahead
                load(1 - cur, (t0 + tile_n) * fps,
                     min(tile_n, T - t0 - tile_n) * fps)
            full = n == tile_n and not predicate_all
            cnt = np.clip(n - np.arange(NT) * C, 0, C)
            ends = np.flatnonzero((cnt > 0) & (np.arange(NT) * C + cnt == n))

            def take(i, new, old):
                return new if full else pick(i < cnt, new, old)

            cin = [np.zeros((NT,) + zero.shape, F32) for _ in range(2)]
            cin[0][0], cin[1][0] = car[0]
            e = [c.copy() for c in cin]
            for i in range(C):
                n_ = step(e, v[:, i], sec[0])
                e = [take(i, n_[j], e[j]) for j in range(2)]
            for k, K in enumerate(sec):
                st = combine(e, cin, K)
                fused = k + 1 < len(sec)
                if fused:
                    cin[0][0], cin[1][0] = car[k + 1]
                    f = [c.copy() for c in cin]
                for i in range(C):
                    u = v[:, i].copy()
                    yv = madd(K["b0"], u, st[0])
                    n_ = step(st, u, K)
                    if fused:
                        m_ = step(f, yv, sec[k + 1])
                        f = [take(i, m_[j], f[j]) for j in range(2)]
                    st = [take(i, n_[j], st[j]) for j in range(2)]
                    v[:, i] = take(i, yv, u)
                if fused:
                    e = f
                car[k] = [st[0][ends[0]], st[1][ends[0]]]
            ring[cur][_phys(g)] = v            # the outputs into the tile
        store(cur, t0 * fps, n * fps)          # the last tile's, after it
    cr = np.array(car, F32)
    if cplx:
        return yw.view(np.complex64), cr.view(np.complex64)[..., 0]
    return yw, cr


def _pscan_case(rng, cplx, R, T, ns):
    """Stable biquads (poles inside 0.95; complex ones rotated by e^{jw}),
    unit input, a random carry."""
    dt = np.complex64 if cplx else F32

    def draw(*shape, scale=1.0):
        z = rng.standard_normal(shape) * scale
        if cplx:
            z = z + 1j * rng.standard_normal(shape) * scale
        return z.astype(dt)

    r = rng.uniform(0.3, 0.95, ns)
    th = rng.uniform(0.1, 3.0, ns)
    a = np.stack([np.ones(ns), -2 * r * np.cos(th), r * r], 1).astype(dt)
    if cplx:
        a[:, 1:] *= np.exp(1j * rng.uniform(-0.3, 0.3, (ns, 1))
                           * np.array([1.0, 2.0]))
    return draw(R, T), draw(ns, 3, scale=0.5), a, draw(R, ns, 2)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("C,NT,T,ns", [(4, 8, 70, 1), (4, 8, 64, 3),
                                       (2, 4, 19, 2), (1, 2, 9, 1),
                                       (8, 1, 21, 2), (1, 1, 5, 1),
                                       (2, 16, 5, 2), (1, 32, 70, 3),
                                       (2, 64, 300, 2), (1, 128, 300, 2),
                                       (2, 1024, 2100, 2),
                                       (4, 512, 2100, 2)])
def test_pscan_kernel_walk_equals_plain_version(C, NT, T, ns, cplx):
    # several tiles with a ragged last one (70 = 2 x 32 + 6), whole tiles
    # only (64), chunks of one sample, a tile of one chunk, a tile mostly
    # empty (5 of 32); one whole warp (32 threads), then 2, 4, 32 and 16
    # warps (the totals' scan over the warps), each with a ragged last
    # tile: bit-equal outputs and carries
    x, b, a, s = _pscan_case(np.random.default_rng(C * 100 + NT + T), cplx,
                             2, T, ns)
    y_ref, s_ref = iir_pscan_reference(
        *(torch.from_numpy(v) for v in (x, b, a, s)), chunk=C, threads=NT)
    for r in range(2):
        y, st = pscan_walk(x[r], b, a, s[r], cplx, C, NT)
        np.testing.assert_array_equal(y, y_ref[r].numpy())
        np.testing.assert_array_equal(st, s_ref[r].numpy())


@pytest.mark.parametrize("cplx", [False, True])
def test_pscan_walk_at_the_kernels_chunk_and_threads(cplx):
    # the kernel's own C and NT, one whole tile and a ragged second one
    C = CHUNK[cplx]
    x, b, a, s = _pscan_case(np.random.default_rng(7), cplx, 1,
                             C * THREADS + 37, 1)
    y_ref, s_ref = iir_pscan_reference(
        *(torch.from_numpy(v) for v in (x, b, a, s)))
    y, st = pscan_walk(x[0], b, a, s[0], cplx, C, THREADS)
    np.testing.assert_array_equal(y, y_ref[0].numpy())
    np.testing.assert_array_equal(st, s_ref[0].numpy())


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("C,NT,tiles", [(4, 64, 2), (2, 32, 3)])
def test_pscan_full_tile_path_equals_predicated_path(C, NT, tiles, cplx):
    # whole tiles only: the unpredicated path (the kernel's for a full
    # tile) and the predicated one (a ragged tile's, every step's count
    # C) give the same bits, and both the plain version's
    x, b, a, s = _pscan_case(np.random.default_rng(C + NT), cplx, 1,
                             tiles * C * NT, 3)
    y_ref, s_ref = iir_pscan_reference(
        *(torch.from_numpy(v) for v in (x, b, a, s)), chunk=C, threads=NT)
    y1, s1 = pscan_walk(x[0], b, a, s[0], cplx, C, NT)
    y2, s2 = pscan_walk(x[0], b, a, s[0], cplx, C, NT, predicate_all=True)
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(y1, y_ref[0].numpy())
    np.testing.assert_array_equal(s1, s_ref[0].numpy())


@pytest.mark.parametrize("cplx", [False, True])
def test_pscan_tile_layout_is_conflict_free(cplx):
    # the kernel's swizzled tile (16-byte unit f at f ^ ((f / upt) & 7);
    # a tile of 4096 units, a chunk of upt = 4096 / THREADS units for real
    # and complex rows alike): a permutation inside
    # each 128-byte line; a 16-byte access is served a quarter warp (8
    # lanes) at a time, and each quarter warp's 16-byte copies in (unit
    # tid + THREADS k), chunk reads and writes (units upt tid + q) and
    # output reads (as the copies) fall in 8 distinct 16-byte bank groups;
    # the 4-byte copies of a row that is not 16-byte aligned (float
    # tid + THREADS k) in 32 distinct banks
    C, fps = CHUNK[cplx], 2 if cplx else 1
    units, upt = 4096, C * fps // 4
    assert upt * THREADS == units
    f = np.arange(units)
    assert sorted(_swz(f)) == list(f)
    assert (_swz(f) >> 3 == f >> 3).all()
    tid = np.arange(THREADS)
    for k in range(upt):
        groups = _swz(tid + THREADS * k).reshape(-1, 8) % 8
        assert all(len(set(grp)) == 8 for grp in groups), k
        groups = _swz(upt * tid + k).reshape(-1, 8) % 8
        assert all(len(set(grp)) == 8 for grp in groups), k
    for k in range(4 * upt):
        banks = _phys(tid + THREADS * k).reshape(-1, 32) % 32
        assert all(len(set(grp)) == 32 for grp in banks), k
