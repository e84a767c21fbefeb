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
* symsync_pll_lms (both walks above on two warps): pll_lms's walk run
  chunk by chunk with the state and the running dot handed on equals one
  pass bit for bit; the two warps' hand-off through a ring of NBUF tiles
  with two named barriers a buffer never writes a full buffer, never reads
  a stale one, never leaves an arrive unmet and never sticks, under any
  interleaving tried; the PLL warp's groups cover each slot once, in order.
* branch_bank and symsync_pll_lms's filter warp (csrc/branch_dot.cuh):
  the register walk of 4 outputs over groups of 4 taps (the first product
  alone, a partial last group) sums each output in the plain version's
  order, so it gives `branch_bank_reference`'s bits at every tap count;
  the fused kernel's chain, reading a branch from the filter warp's
  window (a tile ahead, placed by the branch of the tile before) or
  filtering it on the chain when the window misses it, gives
  `symsync_scan_reference`'s outputs and state over `branch_bank`'s
  rows bit for bit, at the full bank with no miss; each tile's window
  cells are written once; and the chain and the filter warp's hand-off
  (READY and FREE of two stage buffers, four input buffers, the window
  published a tile ahead) never overwrites what is still to be read and
  never sticks, under any interleaving tried.

* fir_real and mix_fir_decim (csrc/fir_window.cuh and the two sources):
  the padded shared-memory map is a bijection that keeps every group of R
  words whole and 16-byte aligned, and puts the 8 lanes of a quarter warp
  on distinct banks; the circular register window with its 4-tap steps and
  guarded tail, walked in numpy, is the direct correlation; the strided FIR
  is the sum of `down` unit-stride correlations of the polyphase
  components (held to the plain version); the constant address steps of
  the mix pass and of fir_real's inner tiles equal the general map; a
  block's walk over several tiles, with the raw window copied in 16-byte
  pieces from an aligned base, reproduces each tile's window and tile 0's
  halo from the carry; and the kernel's per-tile phase, formed with the
  plain version's float32 roundings, equals `tile_phases` bit for bit;
* the tensor-core form that `chip_kernel_bench.py --mma-probe` measures:
  the product with overlapped rows A[m][k] = w[16 m + k] and the banded
  taps B[k][n] = g[k - n] is the direct strided FIR, and the three-product
  TF32 split (TF32 rounding emulated on the mantissa bits) stays under
  1e-6 of rms at 144 taps where one TF32 product alone does not.

* viterbi_acs's block form (csrc/viterbi_acs.cu, kept for ns of 32, 512
  and 1024): one thread per next state reads its
  two predecessors p0 = s >> 1 and p0 + ns/2; the metrics stay
  unnormalized in a double buffer and the state max M of the last step
  is subtracted when they are read, which is the plain version's
  normalized metric with the same roundings; the warps' maxima give M;
  the decisions packed by warp (word s >> 5, bit s & 31, one word per
  warp and step) and the traceback's read of them, walked in numpy over
  64-step tiles, give the plain version's packed decisions and bits;
* viterbi_acs's warp form (64 <= ns <= 256): lane l and register i hold
  state l + 32 i, the predecessors come by shuffle from lanes
  (l >> 1) + 16 (i & 1), registers i >> 1 and (i >> 1) + ns/64, the
  new metric as the max of the two candidates, the state max as the
  larger, as floats, of the int max and min of the lanes' float maxima
  as bits, the decisions by one ballot per register, the
  tiles in runs of 8 steps that step on past T on zero metrics, and the
  traceback's rotation of every word (left by log2(ns/2) at its load,
  right by the state) that puts the state's bit on the bit of ns/2, its
  select of the word by the state's high bits and its 32 bits gathered
  in one word, lane l writing bit l: the
  same bits and packed decisions as the plain version, on +-0 metrics
  too.

* suppress_scan (csrc/suppress_scan.cu): a warp a row, 32 segments a
  turn, each turn's loads issued a turn ahead (indices past the row read
  its last segment again), each lane holding one segment a turn (a
  non-candidate as -2^40, its end pos + span), every lane walking the 32
  broadcast values with the watermark in int64 and lane i keeping step
  i's verdict; the tail turn's lanes past S never keep and never move the
  watermark: the plain version's keep mask on no candidate, all
  candidates, S = 1 and S around the turns, with int32 and int64
  inputs.  The ranking after each turn (a ballot of the verdicts, a
  popc of the lanes below plus a running count; rank < P writes its
  segment; zeros from the count to P) equals `rank_reference`'s cumsum
  and scatter.
* ldpc_bp (csrc/ldpc_bp.cu): over the real edges of `compact_maps` only,
  per edge (Q, tanh, one log kept with t's sign), per check (the slot-
  order sum of the edges' logs, then wr - deg adds of the pad's constant,
  the negatives counted; min-sum's m1, m2 and first over real edges),
  per edge (the message from the stored log), per variable (the sum over
  its edges in vslot order, one add of +0 for its pads): the plain
  version's messages bit for bit, and its decisions and parity.

Inputs are seeded numpy; T <= 1024.
"""
import numpy as np
import pytest
import torch

from liquid_dsp_tpu_torch.modem import constellation
from liquid_dsp_tpu_torch.ops.kernels import branch_bank as bk
from liquid_dsp_tpu_torch.ops.kernels import mix_fir_decim as mfd
from liquid_dsp_tpu_torch.ops.kernels import pll_lms as pk
from liquid_dsp_tpu_torch.ops.kernels import symsync_scan as sk
from liquid_dsp_tpu_torch.ops.kernels import viterbi_acs as vk

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


def _kernel_walk(sym, valid, st, table, qpsk, alpha, beta2, mu, P0=None):
    """csrc/pll_lms.cu's walk over one channel in float64: valid slots
    only, the window kept shifted ahead, P' = A + g e C, invalid slots from
    the state latched at the last valid slot.  P0: the dot as a run left it
    (symsync_pll_lms's carried "dot"), else summed anew; the final state
    holds the running dot under "P"."""
    L = len(st["w"])
    w, theta, dtheta = st["w"].copy(), st["theta"], st["dtheta"]
    sb = np.append(st["buf"][1:], 0)          # sb_j = buf_{j+1}, newest 0
    old, x2, n = st["buf"][0], st["x2"], st["n"]
    P = np.sum(np.conj(w) * sb) if P0 is None else P0
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
                    "x2": x2, "n": n, "P": P}


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


def _st64(st, b):
    return {"theta": float(st["theta"][b]), "dtheta": float(st["dtheta"][b]),
            "w": (st["ew_re"][b] + 1j * st["ew_im"][b]).numpy().astype(
                complex),
            "buf": (st["eb_re"][b] + 1j * st["eb_im"][b]).numpy().astype(
                complex),
            "x2": float(st["eq_x2"][b]), "n": int(st["eq_n"][b])}


@pytest.mark.parametrize("ms,L,cuts", [
    ("qpsk", 13, (0, 288, 300, 768)), ("qam16", 32, (0, 3, 96, 97, 768)),
    ("qpsk", 1, (0, 400, 768))])
def test_chunks_with_the_dot_carried_equal_one_pass(ms, L, cuts):
    # symsync_pll_lms runs pll_lms's walk one chunk of slots at a time: with
    # the state and the running dot handed on (summed anew at the block's
    # first chunk only), the chunks' outputs and state are one pass's over
    # the block, bit for bit (float64 here, the same operations in turn)
    s_re, s_im, valid, st, tab, qpsk = _pll_case(31 + L, 1, 768, L, ms,
                                                 1 / 6)
    table = (tab[0] + 1j * tab[1]).numpy().astype(complex)
    sym = (s_re[0] + 1j * s_im[0]).numpy().astype(complex)
    v = valid[0].numpy()
    y, d, fin = _kernel_walk(sym, v, _st64(st, 0), table, qpsk, **PLL_KW)
    state, P, ys, ds = _st64(st, 0), None, [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        yc, dc, state = _kernel_walk(sym[a:b], v[a:b], state, table, qpsk,
                                     **PLL_KW, P0=P)
        P = state["P"]
        ys.append(yc)
        ds.append(dc)
    np.testing.assert_array_equal(np.concatenate(ys), y)
    np.testing.assert_array_equal(np.concatenate(ds), d)
    for key in fin:
        np.testing.assert_array_equal(state[key], fin[key], err_msg=key)


NBUF = 4           # csrc/symsync_pll_lms.cu: tiles in the two warps' ring


def _ring_walk(ntiles, rng):
    """csrc/symsync_pll_lms.cu's hand-off between its two warps under a
    random interleaving.  The timing warp waits on EMPTY(u) for tile
    n >= NBUF, writes tile n into buffer u = n % NBUF, arrives on FULL(u);
    the PLL warp waits on FULL(u), reads and zeroes the tile, and arrives on
    EMPTY(u) when n + NBUF < ntiles.  A named barrier of the two warps
    completes on one arrive and one wait, so a second arrive before the
    wait would complete it alone: the walk asserts that never happens,
    that a buffer is written only when empty and read only when it holds
    its tile, that neither warp is stuck, and that no arrive is left over.
    Returns the tiles the PLL warp read, in order."""
    pending = {}                      # barrier id -> arrives not yet met
    buf = [None] * NBUF
    prod, cons = [0, "wait"], [0, "wait"]
    read = []

    def full(u):
        return ("full", u)

    def empty(u):
        return ("empty", u)

    def arrive(bar):
        assert pending.get(bar, 0) == 0, f"second arrive on {bar}"
        pending[bar] = 1

    def met(bar):
        if pending.get(bar, 0):
            pending[bar] = 0
            return True
        return False

    def step_prod():
        n, stage = prod
        u = n % NBUF
        if stage == "wait":
            if n >= NBUF and not met(empty(u)):
                return False
            prod[1] = "write"
        elif stage == "write":
            assert buf[u] is None, f"tile {n} over tile {buf[u]}"
            buf[u] = n
            prod[1] = "arrive"
        else:
            arrive(full(u))
            prod[:] = [n + 1, "wait"]
        return True

    def step_cons():
        n, stage = cons
        u = n % NBUF
        if stage == "wait":
            if not met(full(u)):
                return False
            cons[1] = "read"
        elif stage == "read":
            assert buf[u] == n, f"buffer {u} holds {buf[u]}, not tile {n}"
            read.append(n)
            buf[u] = None
            cons[1] = "arrive"
        else:
            if n + NBUF < ntiles:
                arrive(empty(u))
            cons[:] = [n + 1, "wait"]
        return True

    while prod[0] < ntiles or cons[0] < ntiles:
        movers = [f for f, w in ((step_prod, prod), (step_cons, cons))
                  if w[0] < ntiles]
        rng.shuffle(movers)
        assert any(f() for f in movers), f"stuck at {prod}, {cons}"
    assert not any(pending.values()), pending
    return read


@pytest.mark.parametrize("ntiles", [1, 3, NBUF, NBUF + 1, 9, 128])
def test_symsync_pll_lms_ring_hand_off(ntiles):
    for seed in range(20):
        assert _ring_walk(ntiles, np.random.default_rng(seed)) == list(
            range(ntiles))


@pytest.mark.parametrize("Tc,max_out", [(4096, 3), (509, 3), (31, 3),
                                        (300, 4), (33, 2)])
def test_symsync_pll_lms_groups_cover_each_slot_once(Tc, max_out):
    # the PLL warp walks each tile of TILE steps as groups of 32 slots from
    # the tile's start (the last group of a ragged tile partly empty): every
    # slot of the chunk once, in the order pll_lms walks the block
    TILE = 32
    order = []
    for t0 in range(0, Tc, TILE):
        ns = min(TILE, Tc - t0) * max_out
        for g in range(0, ns, 32):
            order += [t0 * max_out + i for i in range(g, min(g + 32, ns))]
    assert order == list(range(Tc * max_out))


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
                  locked, fetch=None, tile_start=None):
    """csrc/symsync_scan.cu's chain, one channel after the other, in the
    plain version's arithmetic (float32 ops rounded one by one, `fma32` at
    the three contraction points).  fetch(ch, t, bc) -> (mf_re, dmf_re,
    mf_im, dmf_im) gives an active emit's branch values (ma's by default);
    tile_start(ch, n, bi) is told the branch index each 32-step tile
    starts on."""
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
            if tile_start is not None and t % 32 == 0:
                tile_start(ch, t // 32, bi)
            e = 0
            if bi >= npfb:
                tau = f32(tau + f32(0.0))
                ran = max(ran, f32(0.0))
                bf = f32(tau * f32(npfb))
                bi = int(np.rint(bf))
                e = 1
            while e < max_out and bi < npfb:
                bc = max(bi, 0)
                if fetch is None:
                    mf_re, dmf_re = m[0, ch, bc, t], m[0, ch, npfb + bc, t]
                    mf_im = dmf_im = f32(0.0)
                    if P == 2:
                        mf_im, dmf_im = m[1, ch, bc, t], m[1, ch, npfb + bc,
                                                           t]
                else:
                    mf_re, dmf_re, mf_im, dmf_im = fetch(ch, t, bc)
                if P == 2:
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


# --- branch_bank and symsync_pll_lms's filter warp (csrc/branch_dot.cuh) ---

TILE = 32          # steps a tile (csrc/symsync_step.cuh)
RCH = 8            # rows a pass of branch_bank.cu
FUSED_RCH = 4      # rows a pass of symsync_pll_lms.cu's filter warp


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _dots4(x, taps, off, Lb):
    """branch_dot::dots4 walked as the kernels run it: len(off) rows x 4
    outputs from x (x[0 .. 4 (Lb // 4 + 2)) readable), row r's taps at
    taps[off[r]:], the window sliding by 4 a group (lo carried, one new
    16-byte load), the group holding tap 0 taking its product first, a
    partial last group of Lb % 4 taps.  x, taps float32 tensors; returns
    acc [RCH, 4] float32."""
    G, rem = Lb >> 2, Lb & 3
    kk_rows = torch.stack([taps[o:o + 4 * (G + 1)] for o in off])
    acc = torch.zeros(len(off), 4)

    def group(first, g, nu):
        nonlocal acc
        w = x[4 * g:4 * g + 8]
        for u in range(nu):
            xs = torch.stack([w[i + u] for i in range(4)])[None, :]
            kk = kk_rows[:, 4 * g + u][:, None]
            acc = (xs * kk if first and u == 0
                   else sk.fma32(xs.expand_as(acc), kk.expand_as(acc), acc))

    if G > 0:
        group(True, 0, 4)
    for g in range(1, G):
        group(False, g, 4)
    if rem:
        group(G == 0, G, rem)
    return acc


@pytest.mark.parametrize("Lb", [1, 2, 3, 4, 5, 7, 20, 28, 31, 64])
def test_dots4_walk_is_branch_banks_sum(Lb):
    # the group walk sums each output in the plain version's order, so it
    # gives branch_bank_reference's bits at every tap count
    rng = np.random.default_rng(Lb)
    R, Tc = 2 * RCH, 12
    kern = torch.from_numpy(rng.standard_normal((R, Lb)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(Tc + Lb - 1).astype(np.float32))
    want = bk.branch_bank_reference(x[None, None], kern)[0, 0]
    kp = bk.tap_pitch(Lb)
    taps = torch.zeros(R * kp + 4)
    for r in range(R):
        taps[r * kp:r * kp + Lb] = kern[r]
    xs = torch.cat([x, torch.zeros(4 * (Lb // 4 + 3))])
    for t0 in range(0, Tc, 4):
        for r0 in range(0, R, RCH):
            got = _dots4(xs[t0:], taps, [(r0 + r) * kp for r in range(RCH)],
                         Lb)
            assert torch.equal(got, want[r0:r0 + RCH, t0:t0 + 4])


def _window_start(bi, npfb, win):
    c = 0 if bi < 0 else bi % npfb
    r0 = c - win // 2
    return r0 + npfb if r0 < 0 else r0


def _filter_tile(planes_ch, taps, kp, Lb, npfb, win, r0, n):
    """symsync_pll_lms.cu's filter warp on tile n of one channel: the
    staged input tile (TILE + kp + 4 samples a plane, zeros past the row),
    its work items (lane it: a pass of FUSED_RCH rows of one plane and filter
    at 4 steps), the rows (r0 + jw) mod npfb of the window, written into
    the stage [2P][win][TILE] as flat floats.  Returns (stage, the staged
    input [P][XT], the (pg, jw, step) cells written)."""
    P, n_in = planes_ch.shape
    XT = TILE + kp + 4
    t0 = n * TILE
    xin = torch.zeros(P, XT)
    m = max(0, min(XT, n_in - t0))
    xin[:, :m] = planes_ch[:, t0:t0 + m]
    stage = torch.full((2 * P * win * TILE,), float("nan"))
    cpp = -(-win // FUSED_RCH)
    cells = []
    for it in range(2 * P * cpp * 8):
        tq, c = it & 7, it >> 3
        pg = c // cpp
        jw0 = (c - pg * cpp) * FUSED_RCH
        off = []
        for r in range(FUSED_RCH):
            jw = min(jw0 + r, win - 1)
            rr = r0 + jw if r0 + jw < npfb else r0 + jw - npfb
            off.append(((pg & 1) * npfb + rr) * kp)
        acc = _dots4(xin[pg >> 1, 4 * tq:], taps, off, Lb)
        for r in range(FUSED_RCH):
            if jw0 + r < win:
                o = (pg * win + jw0 + r) * TILE + 4 * tq
                stage[o:o + 4] = acc[r]
                cells += [(pg, jw0 + r, 4 * tq + i) for i in range(4)]
    return stage, xin, cells


def _fused_walk(planes, kern, fs, is_, win, **kw):
    """The fused kernel's timing chain (`_kernel_emits`) reading its branch
    values as symsync_pll_lms.cu does: tile n's window starts at
    window_start(the branch tile n - 1 started on) (tile 0's, and tile 1's,
    at the loop's first branch), a row in the window from the filter
    warp's stage, any other branch filtered on the chain from the staged
    input by branch_dot::dot (a miss).  Returns (the chain's outputs, the
    misses, the cells each tile's filter wrote)."""
    P, B, n_in = planes.shape
    npfb, Lb = kw["npfb"], kern.shape[1]
    kp = bk.tap_pitch(Lb)
    taps = torch.zeros(2 * npfb * kp + 4)
    for r in range(2 * npfb):
        taps[r * kp:r * kp + Lb] = kern[r]
    starts, tiles, misses, written = {}, {}, [0], []

    def tile_start(ch, n, bi):
        # tile n + 1's window from where tile n starts (tile 0's from the
        # first branch too)
        if n == 0:
            starts[ch, 0] = _window_start(bi, npfb, win)
        starts[ch, n + 1] = _window_start(bi, npfb, win)

    def fetch(ch, t, bc):
        n, tl = divmod(t, TILE)
        r0 = starts[ch, n]
        if (ch, n) not in tiles:
            tiles[ch, n] = _filter_tile(planes[:, ch], taps, kp, Lb, npfb,
                                        win, r0, n)
            written.append(tiles[ch, n][2])
        stage, xin, _ = tiles[ch, n]
        j = (bc - r0) % npfb
        if j < win:
            idx = [(pg * win + j) * TILE + tl for pg in range(2 * P)]
            v = [stage[i] for i in idx]
        else:
            misses[0] += 1
            v = []
            for pl in range(P):
                for row in (bc, npfb + bc):
                    x = xin[pl, tl:tl + Lb]
                    k_ = taps[row * kp:row * kp + Lb]
                    acc = x[:1] * k_[:1]
                    for jj in range(1, Lb):
                        acc = sk.fma32(x[jj:jj + 1], k_[jj:jj + 1], acc)
                    v.append(acc[0])
        v = [np.float32(float(a)) for a in v] + [np.float32(0.0)] * (4 - len(v))
        if P == 1:
            return v[0], v[1], np.float32(0.0), np.float32(0.0)
        return tuple(v)

    out = _kernel_emits(bk.branch_bank_reference(planes, kern), fs, is_,
                        **kw, fetch=fetch, tile_start=tile_start)
    return out, misses[0], written


@pytest.mark.parametrize("P,win,warm", [(2, 32, True), (2, 8, False),
                                        (1, 8, False), (2, 3, False)])
def test_fused_window_and_misses_give_branch_banks_values(P, win, warm):
    # the filter warp's window (a tile ahead, from the branch of the tile
    # before) and the chain's miss path read every active emit's branch
    # values with branch_bank's bits: the chain's outputs and state equal
    # symsync_scan_reference's; the full bank (win = npfb) never misses;
    # every stage cell of a window is written once
    from liquid_dsp_tpu_torch.ops.symsync import (branch_kernel,
                                                  symsync_banks)
    npfb, Lb_m, B, Tc = 32, 7, 2, 100
    mf, dmf = symsync_banks("arkaiser", 2, Lb_m, 0.3, npfb)
    kern = branch_kernel(mf, dmf, "cpu")
    rng = np.random.default_rng(P * win)
    planes = torch.from_numpy((rng.standard_normal((P, B, Tc + 27))
                               * 0.6).astype(np.float32))
    _, fs, is_ = _sync_case(5 + win, P, B, Tc, npfb, 2, not warm)
    fs[2, 1] += 0.07        # channel 1 drifts 2.2 branches a step
    kw = dict(npfb=npfb, max_out=3, k=2, k_out=1, bw=0.3 if not warm
              else 0.02, locked=False)
    want = sk.symsync_scan_reference(bk.branch_bank_reference(planes, kern),
                                     fs, is_, **kw)
    got, misses, written = _fused_walk(planes, kern, fs, is_, win, **kw)
    assert int(want[2].sum()) > Tc // 3
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(got[3].view(np.int32),
                                  want[3].numpy().view(np.int32))
    np.testing.assert_array_equal(got[4], want[4].numpy())
    if win == npfb:
        assert misses == 0
    else:
        assert misses > 0
    for cells in written:
        assert sorted(cells) == [(pg, jw, t) for pg in range(2 * P)
                                 for jw in range(win) for t in range(TILE)]


def _filter_hand_off_walk(ntiles, rng):
    """symsync_pll_lms.cu's hand-off between the timing chain (warp 0) and
    the filter warp (warp 2) under a random interleaving.  The chain
    publishes tile 0's window and arrives on FREE(0); at tile n it
    publishes tile n + 1's window into r0s[(n + 1) & 1] and arrives on
    FREE((n + 1) & 1) (n + 1 < ntiles), waits on READY(n & 1), reads stage
    buffer n & 1 and input buffer n % 4.  The filter warp stages input
    tiles 0 and 1, then at tile n waits on FREE(n & 1), reads r0s[n & 1],
    stages input tile n + 2 into buffer (n + 2) % 4, filters tile n from
    input buffer n % 4 into stage buffer n & 1 and arrives on READY(n & 1).
    A named barrier of the two warps completes on one arrive and one
    wait: the walk asserts no second arrive before the wait, that nothing
    is written while a tile still to be read holds it, that each read
    finds its own tile and window, and that neither warp sticks."""
    pending = {}
    r0s, stage, xbuf = [None] * 2, [None] * 2, [None] * 4
    chain, filt = [0, "publish0"], [0, "stage01"]
    done = []

    def arrive(bar):
        assert not pending.get(bar), f"second arrive on {bar}"
        pending[bar] = True

    def met(bar):
        if pending.get(bar):
            pending[bar] = False
            return True
        return False

    def step_chain():
        n, st = chain
        if st == "publish0":
            r0s[0] = ("window", 0)
            arrive(("free", 0))
            chain[1] = "publish"
        elif st == "publish":
            if n + 1 < ntiles:
                assert r0s[(n + 1) & 1] in (None, ("read", n - 1))
                r0s[(n + 1) & 1] = ("window", n + 1)
                arrive(("free", (n + 1) & 1))
            chain[1] = "wait"
        elif st == "wait":
            if not met(("ready", n & 1)):
                return False
            chain[1] = "read"
        else:
            assert stage[n & 1] == ("rows", n), (n, stage)
            assert xbuf[n % 4] == ("input", n), (n, xbuf)
            done.append(n)
            chain[:] = [n + 1, "publish"]
        return True

    def step_filt():
        n, st = filt
        if st == "stage01":
            xbuf[0], xbuf[1] = ("input", 0), ("input", 1)
            filt[1] = "wait"
        elif st == "wait":
            if not met(("free", n & 1)):
                return False
            assert r0s[n & 1] == ("window", n)
            r0s[n & 1] = ("read", n)
            filt[1] = "stage"
        elif st == "stage":
            if n + 2 < ntiles:
                # the chain has left tile n - 2, whose buffer this is
                assert not chain[0] < n - 1, (n, chain)
                xbuf[(n + 2) % 4] = ("input", n + 2)
            filt[1] = "filter"
        elif st == "filter":
            assert xbuf[n % 4] == ("input", n)
            assert chain[0] >= n - 1, (n, chain)
            stage[n & 1] = ("rows", n)
            filt[1] = "arrive"
        else:
            arrive(("ready", n & 1))
            filt[:] = [n + 1, "wait"]
        return True

    while chain[0] < ntiles or filt[0] < ntiles:
        movers = [f for f, w in ((step_chain, chain), (step_filt, filt))
                  if w[0] < ntiles]
        rng.shuffle(movers)
        assert any(f() for f in movers), f"stuck at {chain}, {filt}"
    assert not any(pending.values()), pending
    return done


@pytest.mark.parametrize("ntiles", [1, 2, 3, 4, 5, 9, 64])
def test_symsync_pll_lms_filter_hand_off(ntiles):
    for seed in range(20):
        assert _filter_hand_off_walk(ntiles, np.random.default_rng(seed)) \
            == list(range(ntiles))


# --- fir_real and mix_fir_decim: the shared window loop and its layouts ---

PAD = 4            # csrc/fir_window.cuh
THREADS = 128      # both kernels
DOWN_R = {1: 16, 2: 16, 4: 8, 8: 8}   # mix_fir_decim.cu's launch_down


def padded(k, R):
    return k + k // R * PAD


def layout(L, down, R):
    """mix_fir_decim.cu's Layout: (no, A4, Ap, K, Ks)."""
    no = mfd.TILE // down
    A = -(-L // down)
    Ap = -(-A // R) * R
    K = no + Ap
    return no, -(-A // 4) * 4, Ap, K, K // R * (R + PAD)


@pytest.mark.parametrize("R", [8, 16])
def test_padded_map_is_a_bijection_that_keeps_groups_whole(R):
    k = np.arange(4096)
    at = padded(k, R)
    assert (np.diff(at) >= 1).all()                     # injective, ordered
    assert at[-1] < (len(k) // R) * (R + PAD)           # inside Ks words
    starts = at[::R]
    assert (starts % 4 == 0).all()                      # 16-byte aligned
    assert (at.reshape(-1, R) == starts[:, None] + np.arange(R)).all()


@pytest.mark.parametrize("R", [8, 16])
@pytest.mark.parametrize("offset", [0, 4, 8, 12, 20, 36])
def test_quarter_warp_loads_hit_distinct_banks(R, offset):
    # lane l reads 16 bytes at word l*(R+PAD) + offset; the hardware serves
    # a 16-byte load a quarter warp (8 lanes) at a time
    lanes = np.arange(32)
    words = (lanes * (R + PAD) + offset)[:, None] + np.arange(4)
    banks = words % 32
    for quarter in banks.reshape(4, 8 * 4):
        assert len(set(quarter.tolist())) == 32
    # the tensor-core form's fragment loads: lane (g, t) reads one word at
    # g*(16+PAD) + t + offset, all 32 lanes at once
    if R == 16:
        g, t = lanes // 4, lanes % 4
        assert len(set(((g * (R + PAD) + t + offset) % 32).tolist())) == 32


def correlate_walk(w_padded, g, A4, o0, R):
    """fir_window.cuh's `correlate`: whole groups of R taps, then guarded
    4-tap steps; the window of R registers with its static indices."""
    acc = np.zeros(R)
    at = padded(o0, R)
    xw = w_padded[at:at + R].copy()

    def step4(a0, c):
        nxt = w_padded[at + 4 * c:at + 4 * c + 4]
        for s in range(4):
            j = 4 * c + s
            for k in range(R):
                acc[k] += g[a0 + j] * xw[(j + k) % R]
            xw[j] = nxt[s]

    a0 = 0
    while a0 + R <= A4:
        at += R + PAD
        for c in range(R // 4):
            step4(a0, c)
        a0 += R
    at += R + PAD
    for c in range(R // 4 - 1):
        if a0 + 4 * c < A4:
            step4(a0, c)
    return acc


@pytest.mark.parametrize("R", [8, 16])
@pytest.mark.parametrize("A", [1, 4, 13, 41, 72, 144, 257])
def test_register_window_walk_is_the_direct_correlation(R, A):
    rng = np.random.default_rng(A + R)
    A4, Ap = -(-A // 4) * 4, -(-A // R) * R
    n_out = 4 * R
    K = n_out + Ap
    w = rng.standard_normal(K)
    g = np.zeros(Ap)
    g[:A] = rng.standard_normal(A)
    wp = np.full(K // R * (R + PAD), np.nan)    # pad words are never read
    wp[padded(np.arange(K), R)] = w
    for o0 in range(0, n_out, R):
        got = correlate_walk(wp, g, A4, o0, R)
        want = [np.dot(g[:A], w[o0 + k:o0 + k + A]) for k in range(R)]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("down", [1, 2, 4, 8, 256])
@pytest.mark.parametrize("L", [1, 41, 144, 257])
def test_strided_fir_is_a_sum_of_polyphase_correlations(down, L):
    # y[o] = sum_j h[j] m[down o + L-1 - j] = sum_p sum_a g_p[a] m_p[o + a],
    # m_p[k] = m[down k + p], g_p[a] = h[L-1 - down a - p]: the kernel's
    # layout of taps and window, against the plain version's conv1d
    rng = np.random.default_rng(down + L)
    R = DOWN_R.get(down, 8)
    no, A4, Ap, K, _ = layout(L, down, R)
    h = rng.standard_normal(L)
    m = np.zeros(down * K)
    W = mfd.TILE + L - 1
    m[:W] = rng.standard_normal(W)
    i = np.arange(down * Ap)
    j = L - 1 - (down * (i % Ap) + i // Ap)
    g = np.where(j >= 0, h[np.clip(j, 0, L - 1)], 0.0).reshape(down, Ap)
    assert (g[:, A4:] == 0).all()               # the loop stops at A4
    mp = m.reshape(K, down).T                   # [down, K] components
    y = np.zeros(no)
    for p in range(down):
        for a in range(A4):
            y += g[p, a] * mp[p, a:a + no]
    from liquid_dsp_tpu_torch.ops.dotprod import conv1d_real
    want = conv1d_real(torch.from_numpy(m[:W]), torch.from_numpy(h),
                       stride=down).numpy()
    assert want.shape == (no,)
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-11)


@pytest.mark.parametrize("down", [1, 2, 4, 8])
@pytest.mark.parametrize("L", [1, 144, 257])
def test_mix_pass_address_steps_equal_the_general_map(down, L):
    # sample q = tid + THREADS i: component tid % down, entry
    # tid // down + (THREADS // down) i, whole groups further on per step
    R = DOWN_R[down]
    _, _, _, K, Ks = layout(L, down, R)
    step = THREADS // down // R * (R + PAD)
    W = mfd.TILE + L - 1
    tid = np.arange(THREADS)
    at0 = (tid % down) * Ks + padded(tid // down, R)
    seen = set()
    for i in range(-(-W // THREADS)):
        q = tid + THREADS * i
        general = (q % down) * Ks + padded(q // down, R)
        assert (at0 + step * i == general).all()
        seen.update(general[q < W].tolist())
    assert len(seen) == W                       # every sample its own word


def test_fir_real_inner_tile_address_steps_equal_the_general_map():
    R = 16
    tid = np.arange(THREADS)
    for i in range(R):
        assert (padded(tid, R) + i * (THREADS // R * (R + PAD))
                == padded(tid + THREADS * i, R)).all()


@pytest.mark.parametrize("L", [1, 2, 41, 144, 257])
@pytest.mark.parametrize("vec", [4, 8])     # f32 and bf16 planes
@pytest.mark.parametrize("tiles,nt", [(1, 1), (2, 2), (3, 2), (8, 4)])
def test_tile_walk_reproduces_each_window_and_halo(L, vec, tiles, nt):
    # a block walks tiles [x nt, min((x+1) nt, tiles)); tile t's raw window
    # is copied in pieces of `vec` samples from the piece that holds sample
    # max(start, 0), start = t TILE - (L-1); tile 0 takes its halo from
    # the carry.  Against the plain version's windows of [carry | x].
    rng = np.random.default_rng(L + vec + tiles)
    TILE, SUB = mfd.TILE, mfd.SUB
    T = tiles * TILE
    x = rng.standard_normal(T)
    carry = rng.standard_normal(SUB)
    W = TILE + L - 1
    xp = np.concatenate([carry[SUB - (L - 1):], x])
    done = []
    for bx in range(-(-tiles // nt)):
        for t in range(bx * nt, min((bx + 1) * nt, tiles)):
            start = t * TILE - (L - 1)
            first = max(start, 0)
            e0 = first - first % vec
            pieces = -(-(t * TILE + TILE - e0) // vec)
            assert e0 % vec == 0 and e0 + pieces * vec <= T   # inside the row
            assert pieces * vec <= (TILE + L + 5) // 4 * 4 * (vec // 4)
            raw = x[e0:e0 + pieces * vec]
            halo = max(-start, 0)
            assert halo == (L - 1 if t == 0 else 0)
            win = np.empty(W)
            q = np.arange(W)
            win[:halo] = carry[SUB + start + q[:halo]]
            win[halo:] = raw[start - e0 + q[halo:]]
            np.testing.assert_array_equal(win, xp[t * TILE:t * TILE + W])
            done.append(t)
    assert done == list(range(tiles))


def kernel_tile_phase(theta, step, t):
    """csrc/mix_fir_decim.cu's tile_phase in numpy float32: separately
    rounded product and sums, fmodf, then the sign fix of a remainder."""
    f = np.float32
    a = f(f(f(theta) + f(f(step) * f(t))) + f(np.pi))
    r = f(np.fmod(a, f(2 * np.pi)))
    if r < 0:
        r = f(r + f(2 * np.pi))
    return f(r - f(np.pi))


@pytest.mark.parametrize("theta", [0.0, 2.9, -3.1, 3.1415925])
@pytest.mark.parametrize("dphi", [0.125, 0.31, -0.7, 2.0, 1e-4])
def test_kernel_tile_phase_equals_tile_phases(theta, dphi):
    T = 128 * mfd.TILE
    step = mfd.tile_step(dphi)
    assert step == float(np.float32(step)) and 0 <= step < 2 * np.pi
    c, s = mfd.tile_phases(torch.tensor(theta, dtype=torch.float32), dphi, T)
    ph = torch.tensor([kernel_tile_phase(theta, step, t)
                       for t in range(T // mfd.TILE)])
    assert torch.equal(torch.cos(ph), c) and torch.equal(torch.sin(ph), s)


# --- the tensor-core form of chip_kernel_bench.py --mma-probe ---

def tf32(v):
    """cvt.rna.tf32.f32 on float32 values: 10 mantissa bits kept, ties
    away from zero."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x1000) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("down", [1, 2, 4, 8, 256])
@pytest.mark.parametrize("L", [1, 41, 144, 257])
def test_overlapped_row_product_is_the_strided_fir(down, L):
    # per polyphase component: Y[m][n] = sum_k A[m][k] B[k][n] with
    # A[m][k] = w[16 m + k] (rows overlap) and B[k][n] = g[k - n]; then
    # Y[m][n] is output 16 m + n of the unit-stride correlation
    rng = np.random.default_rng(3 * down + L)
    A = -(-L // down)
    h = rng.standard_normal(L)
    n_out = 64
    m = rng.standard_normal(down * (n_out + A))
    want = np.array([sum(h[j] * m[down * o + L - 1 - j] for j in range(L))
                     for o in range(n_out)])
    Kb = -(-(A + 15) // 8) * 8                          # k-steps of 8
    y = np.zeros((n_out // 16, 16))
    for p in range(down):
        idx = L - 1 - down * np.arange(A) - p
        g = np.where(idx >= 0, h[np.clip(idx, 0, L - 1)], 0.0)
        w = np.concatenate([m[p::down], np.zeros(Kb)])
        Am = np.stack([w[16 * r:16 * r + Kb] for r in range(n_out // 16)])
        k, n = np.arange(Kb)[:, None], np.arange(16)[None, :]
        Bm = np.where((k - n >= 0) & (k - n < A),
                      g[np.clip(k - n, 0, A - 1)], 0.0)
        y += Am @ Bm
    np.testing.assert_allclose(y.reshape(-1), want, rtol=0, atol=1e-11)


def test_three_tf32_products_hold_1e_6_where_one_does_not():
    rng = np.random.default_rng(144)
    L, n_out = 144, 4096
    g = (rng.standard_normal(L) / L ** 0.5).astype(np.float32)
    w = rng.standard_normal(n_out + L).astype(np.float32)
    win = np.lib.stride_tricks.sliding_window_view(w, L)[:n_out]
    exact = win.astype(np.float64) @ g.astype(np.float64)
    rms = np.sqrt(np.mean(exact ** 2))
    gh, wh = tf32(g), tf32(win)
    gl, wl = tf32(g - gh), tf32(win - wh)
    assert np.abs(gl).max() < 2.0 ** -10 and np.abs(wl).max() < 2.0 ** -8
    d = np.float64
    one = wh.astype(d) @ gh.astype(d)
    three = (wl.astype(d) @ gh.astype(d) + wh.astype(d) @ gl.astype(d)
             + wh.astype(d) @ gh.astype(d))
    assert np.abs(three - exact).max() / rms < 1e-6
    assert np.abs(one - exact).max() / rms > 1e-4



def _viterbi_walk(obs, exp, nout, tile=64):
    """csrc/viterbi_acs.cu's block form for one codeword in float32 numpy:
    (bits [nout], packed decisions [T, ns/32] int32)."""
    T, R = obs.shape
    ns = exp.shape[0]
    half, nw = ns // 2, ns // 32
    s = np.arange(ns)
    p0, p1, b = s >> 1, (s >> 1) + half, s & 1
    e0, e1 = exp[p0, b], exp[p1, b]                     # registers
    f32 = np.float32
    pm = np.zeros((2, ns), f32)
    pm[0] = np.where(s == 0, f32(0), f32(vk.NEG))
    M, cur = f32(0), 0
    dec = np.zeros((T, nw), np.uint32)
    for t0 in range(0, T, tile):                        # staged tiles
        ob = obs[t0:t0 + tile]
        for tt in range(len(ob)):
            bm0, bm1 = e0[:, 0] * ob[tt, 0], e1[:, 0] * ob[tt, 0]
            for k in range(1, R):
                bm0 = (bm0 + e0[:, k] * ob[tt, k]).astype(f32)
                bm1 = (bm1 + e1[:, k] * ob[tt, k]).astype(f32)
            c0 = ((pm[cur, p0] - M).astype(f32) + bm0).astype(f32)
            c1 = ((pm[cur, p1] - M).astype(f32) + bm1).astype(f32)
            j = c1 > c0
            nxt = cur ^ 1
            pm[nxt] = np.where(j, c1, c0)
            wmax = pm[nxt].reshape(nw, 32).max(axis=1)  # warp shuffles
            # __ballot_sync: lane l's vote is bit l of its warp's word
            dec[t0 + tt] = (j.reshape(nw, 32).astype(np.uint64)
                            << np.arange(32, dtype=np.uint64)).sum(1)
            M, cur = wmax.max(), nxt                    # after the sync
    bits = np.zeros(T, np.int32)
    st = 0
    for t in range(T - 1, -1, -1):                      # thread 0
        w = int(dec[t, st >> 5])
        bits[t] = st & 1
        st = (st >> 1) + ((w >> (st & 31)) & 1) * half
    return bits[:nout], dec.view(np.int32)


@pytest.mark.parametrize("scheme,dec_len,sigma", [
    ("v27", 9, 1.0), ("v27", 9, None), ("v29", 8, 2.0), ("v39", 8, 0.8),
    ("v29p34", 9, 1.5), ("v27p78", 10, None)])
def test_viterbi_acs_walk_equals_plain(scheme, dec_len, sigma):
    from liquid_dsp_tpu_torch.fec.conv import conv_encode
    from liquid_dsp_tpu_torch.fec.device import conv_soft_decoder
    rng = np.random.default_rng(dec_len)
    dec_fn, _ = conv_soft_decoder(scheme, dec_len)
    rows = []
    for _ in range(3):
        bits = np.unpackbits(conv_encode(
            scheme, rng.integers(0, 256, dec_len).astype(np.uint8)))
        llr = np.zeros(len(bits), np.float32) if sigma is None else (
            (2.0 * bits - 1.0) * 4 + sigma * rng.standard_normal(len(bits))
        ).astype(np.float32)
        rows.append(llr)
    obs = dec_fn.obs(torch.from_numpy(np.stack(rows)))
    assert obs.shape[1] > 64                  # more than one staged tile
    ref_bits, ref_dec = vk.viterbi_acs_reference(obs, dec_fn.exp,
                                                 dec_fn.nout, decisions=True)
    for n in range(3):
        bits, dec = _viterbi_walk(obs[n].numpy(), dec_fn.exp.numpy(),
                                  dec_fn.nout)
        np.testing.assert_array_equal(bits, ref_bits[n].numpy())
        np.testing.assert_array_equal(dec, ref_dec[n].numpy())
    np.testing.assert_array_equal(ref_bits.numpy(),
                                  dec_fn(torch.from_numpy(np.stack(rows))))


def _redux_max(x):
    """csrc/viterbi_acs.cu's state max of float32 values `x` from the two
    int reductions over their bits: the larger of the int max and the int
    min as floats (the int max where it is >= 0, else the int min)."""
    b = np.asarray(x, np.float32).view(np.int32)
    return np.fmax(b.max().view(np.float32), b.min().view(np.float32))


def _viterbi_warp_walk(obs, exp, nout, run=8):
    """csrc/viterbi_acs.cu's warp form for one codeword in float32 numpy:
    lane l, register i hold state l + 32 i.  Returns (bits [nout], packed
    decisions [T, ns/32] int32)."""
    T, R = obs.shape
    ns = exp.shape[0]
    NR, H = ns // 32, ns // 64
    f32 = np.float32
    lane = np.arange(32)[:, None]
    reg = np.arange(NR)[None, :]
    p0 = (lane >> 1) + 16 * reg                         # [32, NR]
    e0 = exp[p0, lane & 1]                              # [32, NR, R]
    e1 = exp[p0 + ns // 2, lane & 1]
    pm = np.full((32, NR), f32(vk.NEG), f32)
    pm[0, 0] = 0
    M = f32(0)
    dec = np.zeros((T, NR), np.uint32)
    src_a, src_b = np.arange(32) >> 1, (np.arange(32) >> 1) + 16
    for t0 in range(0, T, 32):
        n_run = -(-min(32, T - t0) // run) * run        # whole runs of 8
        tile = np.zeros((32, R), f32)
        tile[:min(32, T - t0)] = obs[t0:t0 + 32]       # zeros past T
        for tt in range(n_run):
            o = tile[tt]                                # shuffle from lane tt
            qa, qb = pm[src_a], pm[src_b]               # [32, NR] each
            q0 = np.where(reg & 1, qb[:, reg[0] >> 1], qa[:, reg[0] >> 1])
            q1 = np.where(reg & 1, qb[:, (reg[0] >> 1) + H],
                          qa[:, (reg[0] >> 1) + H])
            bm0, bm1 = e0[..., 0] * o[0], e1[..., 0] * o[0]
            for k in range(1, R):
                bm0 = (bm0 + e0[..., k] * o[k]).astype(f32)
                bm1 = (bm1 + e1[..., k] * o[k]).astype(f32)
            c0 = ((q0 - M).astype(f32) + bm0).astype(f32)
            c1 = ((q1 - M).astype(f32) + bm1).astype(f32)
            j = c1 > c0
            pm = np.fmax(c0, c1)
            if t0 + tt < T:                             # ballot, register i
                dec[t0 + tt] = (j.astype(np.uint64) << np.arange(
                    32, dtype=np.uint64)[:, None]).sum(0)
            mx = pm.max(axis=1)                         # the lane's max
            M = _redux_max(mx)                          # REDUX max, min
    def rotl(v, sh):
        sh %= 32
        return ((v << sh) | (v >> (32 - sh))) & 0xffffffff

    bits = np.zeros(T, np.int32)
    st, keep = 0, 0
    log_half = (ns // 2).bit_length() - 1
    for t in range(T - 1, -1, -1):
        loaded = [rotl(int(v), log_half) for v in dec[t]]   # at the load
        x = [rotl(v, -st) for v in loaded]              # right by st
        span = 1
        while span < NR:                                # select by st >> 5
            hi = (st >> 5) & span
            for i in range(0, NR - span, 2 * span):
                x[i] = x[i + span] if hi else x[i]
            span <<= 1
        keep = ((keep << 1) | (st & 1)) & 0xffffffff
        st = (st >> 1) | (x[0] & (ns // 2))
        if t % 32 == 0:                                 # lane l writes bit l
            for l in range(min(32, T - t)):
                bits[t + l] = (keep >> l) & 1
    return bits[:nout], dec.view(np.int32)


def _metrics(scheme, dec_len, sigma, rng, rows=3):
    """(decoder, depunctured metrics [rows, T, r], the soft bits): rows
    codewords of random bytes, +-4 metrics with noise `sigma`; None: all
    zero; "pm0": zeros of both signs."""
    from liquid_dsp_tpu_torch.fec.conv import conv_encode
    from liquid_dsp_tpu_torch.fec.device import conv_soft_decoder
    dec_fn, _ = conv_soft_decoder(scheme, dec_len)
    llrs = []
    for _ in range(rows):
        bits = np.unpackbits(conv_encode(
            scheme, rng.integers(0, 256, dec_len).astype(np.uint8)))
        if sigma is None:
            llr = np.zeros(len(bits), np.float32)
        elif sigma == "pm0":
            llr = np.where(rng.random(len(bits)) < 0.5, np.float32(-0.0),
                           np.float32(0.0)).astype(np.float32)
        else:
            llr = ((2.0 * bits - 1.0) * 4 + sigma * rng.standard_normal(
                len(bits))).astype(np.float32)
        llrs.append(llr)
    llr = np.stack(llrs)
    return dec_fn, dec_fn.obs(torch.from_numpy(llr)), llr


@pytest.mark.parametrize("scheme,dec_len,sigma", [
    ("v27", 9, 0.8), ("v27", 9, 0.0), ("v27", 9, None), ("v27", 9, "pm0"),
    ("v27", 3, 0.8), ("v29", 8, 0.8), ("v29", 8, 0.0), ("v29", 8, None),
    ("v29", 8, "pm0"), ("v39", 8, 0.8), ("v39", 8, 0.0), ("v39", 8, None),
    ("v39", 5, "pm0"), ("v27p23", 9, 0.8), ("v27p78", 10, None),
    ("v29p34", 9, 0.8), ("v29p78", 9, "pm0")])
def test_viterbi_acs_warp_walk_equals_plain(scheme, dec_len, sigma):
    rng = np.random.default_rng(dec_len + 7)
    dec_fn, obs, llr = _metrics(scheme, dec_len, sigma, rng)
    if sigma == "pm0":
        assert np.signbit(obs.numpy()[obs.numpy() == 0]).any()
    ref_bits, ref_dec = vk.viterbi_acs_reference(obs, dec_fn.exp,
                                                 dec_fn.nout, decisions=True)
    for n in range(obs.shape[0]):
        bits, dec = _viterbi_warp_walk(obs[n].numpy(), dec_fn.exp.numpy(),
                                       dec_fn.nout)
        np.testing.assert_array_equal(bits, ref_bits[n].numpy())
        np.testing.assert_array_equal(dec, ref_dec[n].numpy())
    np.testing.assert_array_equal(ref_bits.numpy(),
                                  dec_fn(torch.from_numpy(llr)))


@pytest.mark.parametrize("seed", range(4))
def test_redux_pair_gives_the_float_max(seed):
    # the int max and min of float bits give the float max, numerically,
    # over sets of both signs, all negative, all positive, with +-0, -1e9
    # (the start metric) and infinities; a zero's sign may differ
    rng = np.random.default_rng(seed)
    pool = np.array([-np.inf, -1e9, -3.5, -1e-40, -0.0, 0.0, 1e-40, 2.0,
                     1e9, np.inf], np.float32)
    for _ in range(500):
        v = rng.choice(pool, rng.integers(1, 33))
        if rng.random() < 0.5:
            v = np.concatenate([v, (rng.standard_normal(rng.integers(
                1, 33)) * 10.0 ** rng.integers(-3, 4)).astype(np.float32)])
        for part in (v, v[v <= 0], v[v >= 0], v[v < 0]):
            if part.size:
                assert _redux_max(part) == part.max()


def _suppress_warp_walk(last_end, cand, pos, span, P=0):
    """csrc/suppress_scan.cu in numpy: a row a warp, turns of 32 segments;
    each turn's loads issued a turn ahead (indices clamped to the row),
    then the 32 broadcast steps every lane takes and the ranking by a
    ballot of the verdicts.  -> (keep, sel [B, P], n_cand)."""
    B, S = cand.shape
    keep = np.zeros((B, S), bool)
    sel = np.full((B, P), -7, np.int64)              # unwritten: -7
    n_cand = np.zeros(B, np.int64)
    lanes = np.arange(32)
    for b in range(B):
        le = np.int64(last_end[b])
        cnt = 0
        idx = np.minimum(lanes, S - 1)
        p, c = pos[b, idx].astype(np.int64), cand[b, idx]
        for st in range(0, S, 32):
            nxt = np.minimum(st + 32 + lanes, S - 1)   # the next turn's
            pn, cn = pos[b, nxt].astype(np.int64), cand[b, nxt]
            n = min(32, S - st)
            pc = np.where((lanes < n) & c, p, -(1 << 40))
            pe = p + span
            mine = np.zeros(32, bool)
            for i in range(32):                      # __shfl_sync from i
                ki = (i < n) and pc[i] >= le
                le = pe[i] if ki else le
                mine[i] = ki                         # lane i's verdict
            keep[b, st:st + n] = mine[:n]
            bal = sum(1 << int(i) for i in np.flatnonzero(mine))
            for lane in np.flatnonzero(mine):
                r = cnt + bin(bal & ((1 << int(lane)) - 1)).count("1")
                if r < P:
                    sel[b, r] = st + lane
            cnt += bin(bal).count("1")
            p, c = pn, cn
        sel[b, cnt:] = 0
        n_cand[b] = cnt
    return keep, sel, n_cand


@pytest.mark.parametrize("S", [1, 31, 32, 33, 64, 65, 129, 161, 330])
@pytest.mark.parametrize("share", [0.0, 0.35, 1.0])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_suppress_scan_walk_equals_plain(S, share, dtype):
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import (
        suppress_scan_reference)
    rng = np.random.default_rng(S * 10 + int(share * 10))
    B = 5
    pos = (np.arange(S) * 256 + rng.integers(0, 256, (B, S))).astype(dtype)
    cand = rng.random((B, S)) < share
    # never, before the head, past the head, past the whole block
    last_end = np.array([-(1 << 30), -50, 400, 1300, 256 * S + 999], dtype)
    for span in (0, 700, 1432):
        want = suppress_scan_reference(
            torch.from_numpy(last_end), torch.from_numpy(cand),
            torch.from_numpy(pos), span).numpy()
        np.testing.assert_array_equal(
            _suppress_warp_walk(last_end, cand, pos, span)[0], want)
        if share == 0.0:
            assert not want.any()
        if share == 1.0 and span == 0:
            # every candidate at or past the watermark fires
            assert (want == (pos >= last_end[:, None])).all()
    assert not want[-1].any()       # a watermark past the block keeps none


@pytest.mark.parametrize("S", [1, 31, 32, 33, 129, 132])
@pytest.mark.parametrize("P", ["1", "8", "S+1"])
def test_suppress_scan_ballot_ranking_equals_cumsum(S, P):
    # the kernel's ranking a turn at a time (ballot, popc below, running
    # count) against the plain version's cumsum and scatter, on the keep
    # masks of the plain fold
    from liquid_dsp_tpu_torch.ops.kernels.suppress_scan import (
        rank_reference, suppress_scan_reference)
    P = {"1": 1, "8": 8, "S+1": S + 1}[P]
    rng = np.random.default_rng(S * 3 + P)
    B = 6
    pos = (np.arange(S) * 256 + rng.integers(0, 256, (B, S))).astype(np.int64)
    share = np.array([0.0, 0.2, 0.5, 0.8, 1.0, 1.0])[:, None]
    cand = rng.random((B, S)) < share
    last_end = np.array([-(1 << 30), -50, 400, 1300, -(1 << 30),
                         256 * S + 999], np.int64)
    for span in (0, 300):
        keep, sel, n_cand = _suppress_warp_walk(last_end, cand, pos, span, P)
        want = suppress_scan_reference(
            torch.from_numpy(last_end), torch.from_numpy(cand),
            torch.from_numpy(pos), span)
        wsel, wn = rank_reference(want, P)
        np.testing.assert_array_equal(keep, want.numpy())
        np.testing.assert_array_equal(sel, wsel.numpy())
        np.testing.assert_array_equal(n_cand, wn.numpy())
    assert n_cand[0] == 0 and (sel[0] == 0).all()
    if span == 0:
        assert n_cand[4] == S       # all candidates, no watermark: all kept


# --- ldpc_bp over the real edges ---------------------------------------

def _ldpc_edge_walk(llr, cm, m, n, wr, wc, iters, min_sum, cw):
    """csrc/ldpc_bp.cu's iteration in numpy float32 over `compact_maps`'s
    real edges (torch's float32 tanh, log, exp and atanh, the plain
    version's functions on the CPU): per edge, per check over its edges
    in slot order and its pads' constant, per edge, per variable; the
    parity from H's weights `cw` at each edge's check slot.
    -> (Rv [R, n*wc + 1] in the padded layout, hard, ok)."""
    from liquid_dsp_tpu_torch.ops.kernels.ldpc_bp import (CAP, NEUTRAL_SP,
                                                          SAT, TINY)
    f32 = np.float32
    fn = {k: (lambda v, g=getattr(torch, k): g(torch.from_numpy(
        np.ascontiguousarray(v, f32))).numpy())
        for k in ("tanh", "log", "exp", "atanh")}
    cstart, evar, echk, vstart, vedge = cm
    E = len(evar)
    R = llr.shape[0]
    deg_c, deg_v = np.diff(cstart), np.diff(vstart)
    kc = np.arange(E) - cstart[echk]               # an edge's check slot
    sat, tiny = f32(SAT), f32(TINY)
    # the pad's constant from its own expression
    tp = np.clip(fn["tanh"](np.array([NEUTRAL_SP * 0.5], f32)), -sat, sat)
    padc = fn["log"](np.maximum(np.abs(tp), tiny))[0]
    padneg = int(tp[0] < 0)
    msg = np.zeros((R, E), f32)
    post = llr.astype(f32).copy()
    for _ in range(iters):
        q = (post[:, evar] - msg).astype(f32)                    # 1.
        if min_sum:
            a = np.abs(q)
            m1 = np.full((R, m), np.inf, f32)
            m2 = m1.copy()
            first = np.zeros((R, m), np.int64)
            tot = np.zeros((R, m), np.int64)
            for k in range(wr):                                  # 2.
                on = deg_c > k
                e = cstart[:-1][on] + k
                ak = a[:, e]
                lo = ak < m1[:, on]
                nxt2 = np.where(lo, m1[:, on],
                                np.where(ak < m2[:, on], ak, m2[:, on]))
                m1[:, on] = np.where(lo, ak, m1[:, on])
                m2[:, on] = nxt2
                first[:, on] = np.where(lo, k, first[:, on])
                tot[:, on] += q[:, e] < 0
            other = (tot[:, echk] - (q < 0)) & 1                 # 3.
            pick = np.where(kc == first[:, echk], m2[:, echk], m1[:, echk])
            msg = (np.where(other == 1, f32(-1), f32(1))
                   * np.minimum(pick, f32(CAP))).astype(f32)
        else:
            t = np.clip(fn["tanh"](q * f32(0.5)), -sat, sat)
            lt = fn["log"](np.maximum(np.abs(t), tiny))
            sv = np.where(t < 0, -lt, lt)                       # kept
            lsum = np.zeros((R, m), f32)
            tot = np.zeros((R, m), np.int64)
            for k in range(wr):                                  # 2.
                on = deg_c > k
                e = cstart[:-1][on] + k
                ltk = -np.abs(sv[:, e])
                lsum[:, on] = ltk if k == 0 else lsum[:, on] + ltk
                tot[:, on] += sv[:, e] > 0
            for k in range(wr):                                  # the pads
                on = deg_c <= k
                lsum[:, on] = padc if k == 0 else lsum[:, on] + padc
                tot[:, on] += padneg
            other = (tot[:, echk] - (sv > 0)) & 1                # 3.
            r = (np.where(other == 1, f32(-1), f32(1))
                 * fn["exp"](lsum[:, echk] - (-np.abs(sv)))).astype(f32)
            msg = (f32(2) * fn["atanh"](np.clip(r, -sat, sat))).astype(f32)
        s = np.zeros((R, n), f32)                                # 4.
        for j in range(wc):
            on = deg_v > j
            rj = msg[:, vedge[vstart[:-1][on] + j]]
            s[:, on] = rj if j == 0 else s[:, on] + rj
        pads = (deg_v > 0) & (deg_v < wc)
        s[:, pads] = s[:, pads] + f32(0)
        post = (llr + s).astype(f32)
    hard = (post < 0).astype(np.int32)
    par = np.zeros((R, m), np.int64)
    odd = np.asarray(cw, np.int64)[echk * wr + kc] & 1    # the kernel's read
    np.add.at(par.T, echk, (hard[:, evar] & odd).T)
    rv = np.zeros((R, n * wc + 1), f32)
    slot = np.repeat(np.arange(n) * wc, deg_v) + (
        np.arange(E) - np.repeat(vstart[:-1], deg_v))
    rv[:, slot] = msg[:, vedge]
    return rv, hard, ~(par & 1).any(axis=1)


@pytest.mark.parametrize("code", ["96", "648"])
@pytest.mark.parametrize("min_sum", [False, True])
@pytest.mark.parametrize("iters", [1, 2, 5])
def test_ldpc_edge_walk_equals_plain(code, min_sum, iters):
    from liquid_dsp_tpu_torch.fec.ldpc import _slot_maps, make_regular_ldpc
    from liquid_dsp_tpu_torch.ops.kernels.ldpc_bp import (
        compact_maps, ldpc_bp_reference, ldpc_decide_reference)
    H, R, sigma = {"96": (make_regular_ldpc(96, 48, 3, seed=1), 12, 0.8),
                   "648": (make_regular_ldpc(648, 324, 3, seed=0), 64,
                           0.7)}[code]
    m, n, wr, wc, c2v, v2c, cvar, cw = _slot_maps(H)
    cm = compact_maps(c2v, v2c, cvar, m, n, wr, wc)
    if code == "648":                  # a heavy check: many pads elsewhere
        assert wr >= 12 and np.diff(cm[0]).min() < wr
    rng = np.random.default_rng(R + iters)
    llr = (2 * (1.0 + sigma * rng.standard_normal((R, n))) / sigma ** 2
           ).astype(np.float32)
    rv, hard, ok = _ldpc_edge_walk(llr, cm, m, n, wr, wc, iters, min_sum,
                                   cw)
    maps = [torch.from_numpy(a) for a in (c2v, v2c, cvar)]
    x = torch.from_numpy(llr)
    want = ldpc_bp_reference(x, *maps, m, n, wr, wc, iters, min_sum)
    wh, wok = ldpc_decide_reference(x, want, maps[2], torch.from_numpy(cw),
                                    m, n, wr, wc)
    assert rv.tobytes() == want.numpy().tobytes()
    np.testing.assert_array_equal(hard, wh.numpy())
    np.testing.assert_array_equal(ok, wok.numpy())
