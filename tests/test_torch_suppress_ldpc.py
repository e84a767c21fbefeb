"""Port parity for the two recurrences with kernels of their own: the
receivers' greedy suppression fold (`ops/kernels/suppress_scan.py`, inside
`framing/stream_rx._detect_refine` and `multichannel/ofdm.s0_detect_block`)
and LDPC belief propagation's iterations (`ops/kernels/ldpc_bp.py`, inside
`fec/ldpc.ldpc_decoder_device`), against the JAX package on the same
seeded inputs.  On the CPU each wrapper runs its plain version.

Tolerances: the keep masks, candidate counts, slot validity and slot
positions exactly (integer folds over the same detections); detection
peaks within 1e-4 relative (float32 from another matmul library); LDPC
decisions and parity exactly (tests/test_torch_rs_ldpc.py's tolerance).
"""
import numpy as np
import pytest
import torch

import _torch_port as tp
import jax.numpy as jnp
from liquid_dsp_tpu.fec import ldpc as jldpc
from liquid_dsp_tpu.framing import frame64 as jf
from liquid_dsp_tpu.framing import stream_rx as jrx
from liquid_dsp_tpu.multichannel import ofdm as jofdm
from liquid_dsp_tpu_torch.fec import ldpc
from liquid_dsp_tpu_torch.framing import stream_rx
from liquid_dsp_tpu_torch.framing.frame64 import (FRAME64_LEN, framegen64,
                                                  framesync64_stream)
from liquid_dsp_tpu_torch.modem import constellation
from liquid_dsp_tpu_torch.multichannel import ofdm
from liquid_dsp_tpu_torch.ops.kernels.ldpc_bp import (compact_maps, ldpc_bp,
                                                      ldpc_bp_reference,
                                                      posterior)
from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import (
    rank_reference, suppress_scan, suppress_scan_reference)

T = 4096
HIST = 1536
NEVER = -(1 << 30)          # the watermark's "never" (stream_rx._NEG)


def _frame64_buffers(rng, starts):
    """Two rows of one [HIST + T] buffer with frame64 frames at `starts`
    (buffer coordinates) in noise 0.005."""
    buf = 0.005 * tp.cnoise(rng, (2, HIST + T))
    for s in starts:
        h = rng.integers(0, 256, 8).astype(np.uint8)
        p = rng.integers(0, 256, 64).astype(np.uint8)
        buf[:, s:s + FRAME64_LEN] += framegen64(h, p)
    return buf.astype(np.complex64)


# frames 1500 apart (no overlap): with span 2000 the fold drops every
# second one, and which ones depends on the watermark; with the receiver's
# own span (1432) frames 700 apart overlap and the second of a pair falls
# inside the first's span
@pytest.mark.parametrize("starts,span", [((60, 1560, 3060), 2000),
                                         ((60, 760, 2300, 3000), None)])
def test_detect_refine_fold_matches_jax(starts, span):
    rng = np.random.default_rng(len(starts))
    buf = _frame64_buffers(rng, starts)
    proc = framesync64_stream(T).core
    span = proc.span if span is None else span
    R = jrx._rx_consts(T, jf._stream_cfg(), 4, HIST)
    # row 0 with no watermark, row 1 with one carried past the block head
    # (400 > 60: the first frame falls inside the last block's span)
    last_end = np.array([NEVER, 400], np.int32)
    tb = torch.from_numpy(buf)
    seg = stream_rx._detect_segments(tb, proc._dc(), 0.5, T, proc.starts)
    got = stream_rx._detect_refine(
        tb, torch.from_numpy(last_end), proc._dc(), 0.5, 4, T, proc.starts,
        span, front_pad=proc.Lb, win_len=proc.win_len)
    keep = got["cand"].numpy()
    # the fold dropped candidates, and not the same ones on both rows
    assert (seg["cand"].numpy().sum(1) > keep.sum(1)).all()
    assert not np.array_equal(keep[0], keep[1])
    for r in range(2):
        want = jrx._detect_refine(
            jnp.asarray(buf[r]), jnp.int32(last_end[r]), R["dc"], 0.5, 4, T,
            R["starts"], span, front_pad=R["Lb"], win_len=R["win_len"])
        np.testing.assert_array_equal(keep[r], np.asarray(want["cand"]))
        assert keep[r].sum() == int(np.asarray(want["cand"]).sum())
        v = np.asarray(want["valid"])
        np.testing.assert_array_equal(got["valid"][r].numpy(), v)
        np.testing.assert_array_equal(got["n0"][r].numpy()[v],
                                      np.asarray(want["n0"])[v])
        np.testing.assert_allclose(got["peak"][r].numpy()[v],
                                   np.asarray(want["peak"])[v], rtol=1e-4)
    # the fold itself is one suppress_scan over the segments
    np.testing.assert_array_equal(
        suppress_scan(torch.from_numpy(last_end), seg["cand"],
                      seg["n0_seg"], span).numpy(), keep)


@pytest.mark.parametrize("span", [304, 1500])
def test_s0_detect_block_fold_matches_jax(span):
    # OFDM frames 1000 apart: span 1500 drops the middle one on row 0 and
    # the outer ones on row 1, whose watermark reaches past the block head;
    # 304 is the receiver's default (3 (M + cp) + M)
    rng = np.random.default_rng(5)
    par = ofdm.ofdm_params(64, 16)
    table = constellation("qpsk").astype(np.complex64)
    data = table[rng.integers(0, 4, (4, par.M_data))]
    f = ofdm.ofdm_generate_frame(par, data)
    buf = 0.01 * tp.cnoise(rng, (2, HIST + T))
    for s in (300, 1300, 2300):
        buf[:, s:s + len(f)] += f * np.exp(1j * 0.002 * np.arange(len(f)))
    buf = buf.astype(np.complex64)
    n_chunk = (HIST + T - 64) // 256
    last_end = np.array([NEVER, 600], np.int32)
    got = ofdm.s0_detect_block(torch.from_numpy(buf),
                               torch.from_numpy(last_end), 64, 0.7, span, T,
                               n_chunk, 4)
    valid, d0, _, peak, keep, pos, n_cand = (t.numpy() for t in got)
    if span == 1500:
        assert keep.sum(1).tolist() == [2, 1]
    for r in range(2):
        want = [np.asarray(w) for w in jofdm.s0_detect_block(
            jnp.asarray(buf[r]), jnp.int32(last_end[r]), 64, 0.7, span, T,
            n_chunk, 4)]
        np.testing.assert_array_equal(keep[r], want[4])
        np.testing.assert_array_equal(pos[r], want[5])
        assert n_cand[r] == int(want[6])
        np.testing.assert_array_equal(valid[r], want[0])
        np.testing.assert_array_equal(d0[r][valid[r]], want[1][want[0]])
        np.testing.assert_allclose(peak[r][valid[r]], want[3][want[0]],
                                   rtol=1e-4)


def _irregular_h(m, n, seed):
    """Rows and columns of several weights (pads on both sides of the slot
    maps), columns of weight 1 to 5, no empty row."""
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        w = int(rng.choice([1, 2, 3, 3, 3, 4, 5]))
        H[rng.choice(m, size=w, replace=False), j] = 1
    for i in np.nonzero(H.sum(axis=1) == 0)[0]:
        H[i, rng.integers(0, n)] = 1
    return H


@pytest.mark.parametrize("code", ["regular", "irregular"])
@pytest.mark.parametrize("min_sum", [False, True])
def test_ldpc_decoder_device_matches_jax(code, min_sum):
    import jax
    H = (jldpc.make_regular_ldpc(96, 48, col_weight=3, seed=1)
         if code == "regular" else _irregular_h(40, 80, 2))
    m, n = H.shape
    _, _, wr, wc, *_ = ldpc._slot_maps(H)
    if code == "irregular":
        rows, cols = H.sum(1), H.sum(0)
        assert rows.min() < wr and cols.min() < wc      # pads both sides
    rng = np.random.default_rng(11)
    sigma = 0.8 if code == "regular" else 0.6
    llr = (2 * (1.0 + sigma * rng.standard_normal((12, n))) / sigma ** 2
           ).astype(np.float32)
    jh, jok = jax.jit(jldpc.ldpc_decoder_device(H, 25, min_sum))(
        jnp.asarray(llr))
    th, tok = ldpc.ldpc_decoder_device(H, 25, min_sum, device="cpu")(llr)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.any()


def test_ldpc_decoder_calls_ldpc_bp_once(monkeypatch):
    H = _irregular_h(20, 40, 4)
    calls = []

    def spy(*a):
        calls.append(a[0].shape)
        return ldpc_bp(*a)

    monkeypatch.setattr(ldpc, "ldpc_bp", spy)
    llr = np.random.default_rng(0).standard_normal((2, 3, 40)).astype(
        np.float32)
    hard, ok = ldpc.ldpc_decoder_device(H, 7, device="cpu")(llr)
    assert calls == [(6, 40)]
    assert hard.shape == (2, 3, 40) and ok.shape == (2, 3)


def test_wrappers_take_the_plain_version_on_the_cpu_and_raise_elsewhere():
    rng = np.random.default_rng(1)
    le = torch.tensor([NEVER, 300, 5000])
    cand = torch.from_numpy(rng.random((3, 40)) < 0.4)
    pos = torch.arange(40) * 256 + torch.from_numpy(
        rng.integers(0, 256, (3, 40)))
    n0 = suppress_scan.launches
    keep = suppress_scan(le, cand, pos, 700)
    assert suppress_scan.launches == n0           # no kernel on the CPU
    assert torch.equal(keep, suppress_scan_reference(le, cand, pos, 700))
    assert torch.equal(suppress_scan(le.int(), cand, pos.int(), 700), keep)
    meta = [t.to("meta") for t in (le, cand, pos)]
    with pytest.raises(ValueError, match="CUDA .* or CPU"):
        suppress_scan(*meta, 700)
    with pytest.raises(ValueError):
        suppress_scan(le, cand, pos.float(), 700)

    H = jldpc.make_regular_ldpc(40, 20, col_weight=2, seed=0)
    m, n, wr, wc, c2v, v2c, cvar, _ = ldpc._slot_maps(H)
    maps = [torch.from_numpy(a.astype(np.int32)) for a in (c2v, v2c, cvar)]
    llr = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    n0 = ldpc_bp.launches
    rv = ldpc_bp(llr, *maps, m, n, wr, wc, 5, False)
    assert ldpc_bp.launches == n0
    assert rv.shape == (3, n * wc + 1) and float(rv[:, -1].abs().max()) == 0
    assert torch.equal(rv, ldpc_bp_reference(llr, *maps, m, n, wr, wc, 5,
                                             False))
    with pytest.raises(ValueError, match="CUDA .* or CPU"):
        ldpc_bp(llr.to("meta"), *(a.to("meta") for a in maps), m, n, wr, wc,
                5, False)
    with pytest.raises(ValueError):
        ldpc_bp(llr[:, 1:], *maps, m, n, wr, wc, 5, False)


@pytest.mark.parametrize("P", [1, 4, 40])
def test_fold_ranking_matches_jax_nonzero(P):
    # suppress_scan(..., P=)'s plain ranking against the JAX package's
    # jnp.nonzero(keep, size=P, fill_value=0) on the same keep masks
    rng = np.random.default_rng(P)
    S = 33
    le = torch.tensor([NEVER, 300, 5000, NEVER])
    cand = torch.from_numpy(rng.random((4, S)) < np.array(
        [0.3, 0.6, 0.5, 0.0])[:, None])
    pos = torch.arange(S) * 256 + torch.from_numpy(rng.integers(0, 256,
                                                               (4, S)))
    keep, sel, n_cand = suppress_scan(le, cand, pos, 700, P=P)
    assert torch.equal(keep, suppress_scan(le, cand, pos, 700))
    assert sel.shape == (4, P) and sel.dtype == n_cand.dtype == torch.int64
    for r in range(4):
        want = np.asarray(jnp.nonzero(jnp.asarray(keep[r].numpy()), size=P,
                                      fill_value=0)[0])
        np.testing.assert_array_equal(sel[r].numpy(), want)
        assert int(n_cand[r]) == int(keep[r].sum())
    assert int(n_cand[3]) == 0 and not bool(sel[3].any())
    assert torch.equal(sel, rank_reference(keep, P)[0])


@pytest.mark.parametrize("code", ["regular", "irregular", "648"])
def test_compact_maps_follow_h(code):
    # the real edges' maps against H: each check's edges are its row's
    # columns in slot order (ascending), each variable's edges its column's
    # rows in vslot order (ascending), degrees as H's; the kernel reads H's
    # weight of edge e at cw[echk*wr + e - cstart[echk]]
    H = {"regular": jldpc.make_regular_ldpc(96, 48, col_weight=3, seed=1),
         "irregular": _irregular_h(40, 80, 2),
         "648": ldpc.make_regular_ldpc(648, 324, 3, seed=0)}[code].copy()
    if code == "irregular":
        H[0, np.nonzero(H[0])[0][0]] = 3       # an odd weight other than 1
        H[1, np.nonzero(H[1])[0][0]] = 2       # an even one: no parity
    m, n, wr, wc, c2v, v2c, cvar, cw = ldpc._slot_maps(H)
    cstart, evar, echk, vstart, vedge = compact_maps(
        c2v, v2c, cvar, m, n, wr, wc)
    E = int((H != 0).sum())
    assert all(a.dtype == np.int32 for a in (cstart, evar, echk, vstart,
                                             vedge))
    assert len(evar) == len(echk) == len(vedge) == E
    np.testing.assert_array_equal(np.diff(cstart), (H != 0).sum(1))
    np.testing.assert_array_equal(np.diff(vstart), (H != 0).sum(0))
    assert cstart[0] == vstart[0] == 0 and cstart[-1] == vstart[-1] == E
    for c in range(m):
        e = np.arange(cstart[c], cstart[c + 1])
        np.testing.assert_array_equal(evar[e], np.nonzero(H[c])[0])
        assert (echk[e] == c).all()
        # the edge is the check's slot k: cvar holds its variable there
        np.testing.assert_array_equal(cvar[c * wr + np.arange(len(e))],
                                      evar[e])
    for v in range(n):
        e = vedge[vstart[v]:vstart[v + 1]]
        assert (evar[e] == v).all()
        np.testing.assert_array_equal(echk[e], np.nonzero(H[:, v])[0])
        # vslot j of v points at edge e's check slot
        np.testing.assert_array_equal(
            v2c[v * wc + np.arange(len(e))], echk[e] * wr + e - cstart[echk[e]])
    e = np.arange(E)
    np.testing.assert_array_equal(cw[echk * wr + e - cstart[echk]],
                                  H[echk, evar])
    with pytest.raises(ValueError, match="pad slot before"):
        bad = cvar.copy()
        bad[0] = n                              # a pad before a real slot
        compact_maps(c2v, v2c, bad, m, n, wr, wc)


def _decode_as_before(H, iters, min_sum, llr):
    """The decoder's steps as they were: the plain iterations, then the
    posterior, the decisions and the exact syndrome as separate steps."""
    m, n, wr, wc, c2v, v2c, cvar, cw = ldpc._slot_maps(H)
    maps = [torch.from_numpy(a.astype(np.int32)) for a in (c2v, v2c, cvar)]
    x = torch.from_numpy(llr)
    Rv = ldpc_bp_reference(x, *maps, m, n, wr, wc, iters, min_sum)
    hard = (posterior(x, Rv, n, wc) < 0).to(torch.int32)
    hard_p = torch.nn.functional.pad(hard, (0, 1))
    syn = (hard_p.index_select(1, maps[2]).to(torch.int64)
           * torch.from_numpy(cw)).reshape(-1, m, wr).sum(dim=-1)
    return hard, (syn % 2 == 0).all(dim=-1), Rv


@pytest.mark.parametrize("code", ["regular", "irregular"])
@pytest.mark.parametrize("min_sum", [False, True])
def test_ldpc_decisions_from_the_launch_match_before(code, min_sum):
    # the decoder's (hard, ok), now from ldpc_bp's one call with the
    # decisions, equal to the steps it took before, on the CPU; and the
    # wrapper's three outputs with `messages`
    H = (jldpc.make_regular_ldpc(96, 48, col_weight=3, seed=1)
         if code == "regular" else _irregular_h(40, 80, 2))
    m, n, wr, wc, c2v, v2c, cvar, cw = ldpc._slot_maps(H)
    rng = np.random.default_rng(3)
    llr = (2 * (1.0 + 0.7 * rng.standard_normal((16, n))) / 0.7 ** 2
           ).astype(np.float32)
    hb, okb, Rvb = _decode_as_before(H, 5, min_sum, llr)
    hard, ok = ldpc.ldpc_decoder_device(H, 5, min_sum, device="cpu")(llr)
    assert torch.equal(hard, hb) and torch.equal(ok, okb)
    assert 0 < int(ok.sum()) or code == "irregular"
    maps = [torch.from_numpy(a.astype(np.int32)) for a in (c2v, v2c, cvar)]
    out = ldpc_bp(torch.from_numpy(llr), *maps, m, n, wr, wc, 5, min_sum,
                  torch.from_numpy(cw), messages=True)
    assert len(out) == 3 and torch.equal(out[0], Rvb)
    assert torch.equal(out[1], hb) and torch.equal(out[2], okb)
