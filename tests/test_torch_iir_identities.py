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
* `csrc/iir_pscan.cu`'s block on a row (a tile of C * NT samples loaded
  by coalesced loads into a padded shared tile, a chunk of C a thread;
  per section the walk from zero, thread 0 from the carry; the
  Kogge-Stone combine with the squared powers of M, all writes of a phase
  before its reads; the re-walk from each chunk's true start; the carry
  from the thread with the tile's last sample) in float32 numpy equals
  `iir_pscan_reference` bit for bit at several chunks and tiles, and the
  padded tile's reads and writes of a warp fall in distinct banks.

Change a kernel's loop only together with its walk here."""
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch thread cap)
from liquid_dsp_tpu_torch.design.iirdes import iirdes, iirdes_sos
from liquid_dsp_tpu_torch.ops import iir
from liquid_dsp_tpu_torch.ops.kernels.iir_block_state import (
    iir_block_state_reference)
from liquid_dsp_tpu_torch.ops.kernels.iir_pscan import (CHUNK, THREADS,
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


def pscan_walk(x, b, a, s, cplx, C, NT):
    """csrc/iir_pscan.cu's block on one row, in float32 numpy, thread by
    thread: the sections' constants and squared powers (thread k for
    section k, one squaring past the last kept), per tile the coalesced
    loads into the padded tile and each thread's chunk out of it, per
    section the walk, the combine (each phase's writes before its reads:
    the barrier), the re-walk and the carry, then the outputs through the
    tile."""
    mul, add, sub = _ops(cplx)
    neg = (lambda v: (-v[0], -v[1])) if cplx else (lambda v: -v)
    zero, one = _val(0, cplx), _val(1, cplx)
    lc, lt = C.bit_length() - 1, NT.bit_length() - 1
    pad = 16 if cplx else 32

    def padded(g):
        return g + g // pad

    sec = []
    for k in range(b.shape[0]):
        b0, b1, b2 = (_val(b[k, i], cplx) for i in range(3))
        a1, a2 = _val(a[k, 1], cplx), _val(a[k, 2], cplx)
        m, pw = (neg(a1), one, neg(a2), zero), []
        for i in range(lc + lt):
            if i >= lc:
                pw.append(m)
            m00, m01, m10, m11 = m
            m = (add(mul(m00, m00), mul(m01, m10)),
                 add(mul(m00, m01), mul(m01, m11)),
                 add(mul(m10, m00), mul(m11, m10)),
                 add(mul(m10, m01), mul(m11, m11)))
        sec.append((b0, sub(b1, mul(a1, b0)), sub(b2, mul(a2, b0)),
                    neg(a1), neg(a2), pw))
    car = [(_val(s[k, 0], cplx), _val(s[k, 1], cplx))
           for k in range(b.shape[0])]
    T, tile_n = len(x), C * NT
    tile = [zero] * (tile_n + tile_n // pad)
    y = [None] * T
    for t0 in range(0, T, tile_n):
        n = min(tile_n, T - t0)
        for tid in range(NT):
            for i in range(C):
                g = tid + NT * i
                if g < n:
                    tile[padded(g)] = _val(x[t0 + g], cplx)
        v = [[tile[padded(tid * C + i)] for i in range(C)]
             for tid in range(NT)]
        cnt = [max(0, min(C, n - tid * C)) for tid in range(NT)]
        for k, (b0, c1, c2, na1, na2, pw) in enumerate(sec):
            def step(e, u):
                return (add(mul(na1, e[0]), add(e[1], mul(c1, u))),
                        add(mul(na2, e[0]), mul(c2, u)))

            cin = [car[k] if tid == 0 else (zero, zero) for tid in range(NT)]
            e = list(cin)
            for tid in range(NT):
                for i in range(cnt[tid]):
                    e[tid] = step(e[tid], v[tid][i])
            for d in range(lt):
                buf = list(e)                      # the phase's writes
                o, p = 1 << d, pw[d]
                for tid in range(o, NT):           # then its reads
                    f0, f1 = buf[tid - o]
                    e[tid] = (add(add(mul(p[0], f0), mul(p[1], f1)),
                                  e[tid][0]),
                              add(add(mul(p[2], f0), mul(p[3], f1)),
                                  e[tid][1]))
            cin = [cin[0]] + e[:-1]
            for tid in range(NT):
                st = cin[tid]
                for i in range(cnt[tid]):
                    u = v[tid][i]
                    v[tid][i] = add(mul(b0, u), st[0])
                    st = step(st, u)
                if cnt[tid] > 0 and tid * C + cnt[tid] == n:
                    car[k] = st
        for tid in range(NT):
            for i in range(C):
                tile[padded(tid * C + i)] = v[tid][i]
        for g in range(n):
            y[t0 + g] = tile[padded(g)]
    if cplx:
        return (np.array([complex(*u) for u in y], np.complex64),
                np.array([[complex(*u) for u in c] for c in car],
                         np.complex64))
    return np.array(y, F32), np.array(car, F32)


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
                                       (2, 16, 5, 2)])
def test_pscan_kernel_walk_equals_plain_version(C, NT, T, ns, cplx):
    # several tiles with a ragged last one (70 = 2 x 32 + 6), whole tiles
    # only (64), chunks of one sample, a tile of one chunk, a tile mostly
    # empty (5 of 32): bit-equal outputs and carries
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
def test_pscan_tile_layout_is_conflict_free(cplx):
    # the kernel's padded tile (one pad a 32 floats, a 16 float2): a warp's
    # coalesced writes and its 32 chunk reads at each i fall in distinct
    # banks (4-byte words) or, for float2, distinct bank pairs in each
    # half warp; the padded index is one-to-one
    C, pad = CHUNK[cplx], 16 if cplx else 32
    words = 2 if cplx else 1

    def padded(g):
        return g + g // pad

    tile = C * THREADS
    assert len({padded(g) for g in range(tile)}) == tile

    def distinct(idx):
        groups = [idx[:16], idx[16:]] if cplx else [idx]
        return all(len({(words * p) % 32 for p in grp}) == len(grp)
                   for grp in groups)

    for w in range(THREADS // 32):
        lanes = range(32 * w, 32 * w + 32)
        for i in range(C):
            assert distinct([padded(j * C + i) for j in lanes]), (w, i)
            assert distinct([padded(j + THREADS * i) for j in lanes]), (w, i)
