"""Port parity: symtrack's fused route, the PLL + LMS step inside the
symsync timing loop (`ops/kernels/symsync_pll_lms`; its plain version on
the CPU), against the JAX package's fused route on the same seeded inputs,
and against the port's own sequential route; the wrapper's checks, the
card's route rule (`framing/symtrack._use_fused`) and the refusal of a
foreign post hook on CUDA (`ops/symsync._fused_kernel`).

Tolerance: the reference's own stream tolerance, symbols within 2e-4 with
decisions equal (tests/test_framing_extras.py:56-58); valid masks, the
timing loop's integer state and eq_n equal, the other carries within 2e-4.
Both sides compute the PLL's cos/sin/atan2 and the LMS dots in float32 with
their own libraries and summation orders, and the branch outputs in their
own orders (the JAX package's conv, the port's `branch_bank` sums).  The
port's fused and sequential plain routes run the same step on the same
slots, so they are bit-equal.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu.design.firdes import firdes_prototype
from liquid_dsp_tpu.modem import constellation, modulate
from liquid_dsp_tpu.ops.fir import firinterp
from liquid_dsp_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from liquid_dsp_tpu_torch.ops import symsync as pss
from liquid_dsp_tpu_torch.ops.kernels import branch_bank as bk
from liquid_dsp_tpu_torch.ops.kernels import pll_lms as pk
from liquid_dsp_tpu_torch.ops.kernels import symsync_pll_lms as fk
from liquid_dsp_tpu_torch.ops.kernels import symsync_scan as sk

jst = importlib.import_module("liquid_dsp_tpu.framing.symtrack")
pst = importlib.import_module("liquid_dsp_tpu_torch.framing.symtrack")

TOL = 2e-4
KW = dict(npfb=32, max_out=3, k=2, k_out=1, bw=0.02, locked=False)


def _stream(B, n, ms, seed):
    """B channels of `ms` symbols at 2 samples/symbol through
    arkaiser(2, 7, 0.3), a gain and carrier phase each, noise 0.004."""
    rng = np.random.default_rng(seed)
    table = constellation(ms)
    tx = firinterp(2, firdes_prototype("arkaiser", 2, 7, 0.3))
    X = np.empty((B, 2 * n), np.complex64)
    for ch in range(B):
        syms = np.asarray(modulate(table, jnp.asarray(
            rng.integers(0, len(table), n)))).astype(np.complex64)
        x, _ = tx(jnp.asarray(syms), batch_shape=())
        X[ch] = (rng.uniform(0.3, 1.5) * np.exp(1j * rng.uniform(0, 6.28))
                 * np.asarray(x) + 0.004 * (rng.standard_normal(2 * n)
                                            + 1j * rng.standard_normal(2 * n)))
    return X


@pytest.mark.parametrize("ms,L", [("qpsk", 13), ("qpsk", 32), ("qam16", 13),
                                  ("qam16", 32)])
def test_fused_route_matches_jax_fused_route(monkeypatch, ms, L):
    # both packages on their fused route over two carried blocks; the
    # port's is the hoisted loop's plain version with PllLmsPost as its post
    monkeypatch.setenv("LIQUID_SYMTRACK_FUSED", "1")
    T, B = 512, 3
    X = _stream(B, T, ms, seed=L)
    jp = jst.symtrack_stream(ms=ms, eq_len=L)
    pp = pst.symtrack_stream(ms=ms, eq_len=L)
    cj = jp.init((B,))
    cp = carry_from_numpy(tp.to_numpy(cj))
    for b in range(2):
        blk = X[:, b * T:(b + 1) * T]
        (yj, dj, vj), cj = jp.apply((), cj, jnp.asarray(blk))
        (yp, dp, vp), cp = pp(cp, torch.from_numpy(blk.copy()))
        vj = np.asarray(vj)
        assert vj.sum() > B * T // 3
        np.testing.assert_array_equal(vp.numpy(), vj)
        np.testing.assert_allclose(yp.numpy()[vj], np.asarray(yj)[vj],
                                   rtol=0, atol=TOL)
        np.testing.assert_array_equal(dp.numpy()[vj], np.asarray(dj)[vj])
    got, want = carry_to_numpy(cp), tp.to_numpy(cj)
    for key in ("theta", "dtheta", "eq_w", "eq_buf", "eq_x2"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                                   atol=TOL, err_msg=key)
    np.testing.assert_array_equal(got["eq_n"], np.asarray(want["eq_n"]))
    for key in ("b", "decim"):
        np.testing.assert_array_equal(got["ss"][key],
                                      np.asarray(want["ss"][key]))
    for key in ("tau", "bf", "rate", "del", "v0", "v1", "win"):
        np.testing.assert_allclose(got["ss"][key], np.asarray(
            want["ss"][key]), rtol=0, atol=TOL, err_msg=key)


def _run_route(monkeypatch, fused, X, T, ms):
    """symtrack_stream over the blocks of X on one route, the CPU forced
    to the hoisted loop (the card's formulation) on both."""
    monkeypatch.setenv("LIQUID_SYMTRACK_FUSED", "1" if fused else "0")
    monkeypatch.setenv("LIQUID_SYMSYNC_KERNEL", "1")
    run = pss.symsync_run
    with monkeypatch.context() as m:
        m.setattr(pss, "symsync_run",
                  lambda *a, **kw: run(*a, **kw, hoist=True))
        st = pst.symtrack_stream(ms=ms)
        c = st.init(batch_shape=(X.shape[0],))
        outs = []
        for b in range(X.shape[1] // T):
            out, c = st(c, torch.from_numpy(X[:, b * T:(b + 1) * T].copy()))
            outs.append(out)
    return outs, c


@pytest.mark.parametrize("ms", ["qpsk", "qam16"])
def test_fused_and_sequential_plain_routes_are_bit_equal(monkeypatch, ms):
    X = _stream(2, 512, ms, seed=5)
    so, sc = _run_route(monkeypatch, False, X, 512, ms)
    fo, fc = _run_route(monkeypatch, True, X, 512, ms)
    assert len(so) == 2
    for a, b in zip(so, fo):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    flat_s, flat_f = carry_to_numpy(sc), carry_to_numpy(fc)
    for key in flat_s:
        if isinstance(flat_s[key], dict):
            for k2 in flat_s[key]:
                np.testing.assert_array_equal(flat_s[key][k2],
                                              flat_f[key][k2])
        else:
            np.testing.assert_array_equal(flat_s[key], flat_f[key])


def _case(B=3, Tc=40, L=13, ms="qpsk", seed=0):
    """A chunk of random input planes with the tracker's bank, a loop state
    (the loop drifts, branches wrap) and the tracker's PLL state."""
    g = torch.Generator().manual_seed(seed)
    st = pst.symtrack_stream(ms=ms, eq_len=L)
    kern = pss.branch_kernel(st.ss.mf, st.ss.dmf, "cpu")
    planes = torch.randn(2, B, Tc + kern.shape[1] - 1, generator=g) * 0.5
    fs = torch.zeros(6, B)
    fs[0] = torch.rand(B, generator=g)
    fs[1] = fs[2] = 2.0
    fs[4] = fs[0] * 32
    is_ = torch.stack([torch.round(fs[4]).int(),
                       torch.ones(B, dtype=torch.int32)])
    return (planes, kern, fs, is_,
            st.pll_state(st.init(batch_shape=(B,)), B), st.post)


def test_plain_version_is_the_scan_reference_with_its_post():
    planes, kern, fs, is_, pc, post = _case()
    got = fk.symsync_pll_lms(planes, kern, fs, is_, pc, post, **KW)
    ma = bk.branch_bank_reference(planes, kern)
    ref = sk.symsync_scan_reference(ma, fs, is_, **KW, post=post,
                                    post_carry=pc)
    for a, b in zip((got.valid, got.fstate, got.istate), ref[2:5]):
        assert torch.equal(a, b)
    for a, b in zip((got.y_re, got.y_im, got.dec), ref[5]):
        assert torch.equal(a, b)
    assert got.dec.dtype == torch.int32 and int(got.valid.sum()) > 0
    assert set(got.pll_state) == set(pk.STATE_KEYS)
    for key in pk.STATE_KEYS:
        assert torch.equal(got.pll_state[key], ref[6][key])
    # a carried dot is the kernel's own: the plain version sums it anew
    again = fk.symsync_pll_lms(planes, kern, fs, is_,
                               dict(pc, dot=torch.ones(2, 3)), post, **KW)
    assert torch.equal(again.y_re, got.y_re)
    assert torch.equal(again.dec, got.dec)


def test_plain_version_takes_an_empty_chunk():
    planes, kern, fs, is_, pc, post = _case(Tc=0)
    out = fk.symsync_pll_lms(planes, kern, fs, is_, pc, post, **KW)
    assert out.y_re.shape == out.dec.shape == out.valid.shape == (3, 0)
    assert out.dec.dtype == torch.int32 and torch.equal(out.fstate, fs)


def test_plain_version_equals_the_two_plain_kernels():
    # the timing loop's slots, then the PLL + LMS over them: the same step
    # on the same slots, bit for bit (what the card's fused kernel rests on)
    planes, kern, fs, is_, pc, post = _case(B=2, Tc=60, L=5, ms="qam16",
                                            seed=3)
    got = fk.symsync_pll_lms(planes, kern, fs, is_, pc, post, **KW)
    ma = bk.branch_bank(planes, kern)
    y_re, y_im, valid, fs2, is2 = sk.symsync_scan_reference(ma, fs, is_,
                                                            **KW)
    r_re, r_im, dec, pc2 = pk.pll_lms_reference(y_re, y_im, valid, pc,
                                                post.tab_re, post.tab_im,
                                                **post.kwargs())
    for a, b in ((got.valid, valid), (got.fstate, fs2), (got.istate, is2),
                 (got.y_re, r_re), (got.y_im, r_im), (got.dec, dec)):
        assert torch.equal(a, b)
    for key in pk.STATE_KEYS:
        assert torch.equal(got.pll_state[key], pc2[key])


def _bad(case):
    planes, kern, fs, is_, pc, post = _case()
    if case == "planes shape":
        planes = planes[None]
    elif case == "kern shape":
        kern = kern[:60]
    elif case == "state shape":
        fs = fs[:5]
    elif case == "pll key":
        pc = {k: v for k, v in pc.items() if k != "eq_x2"}
    elif case == "pll shape":
        pc = dict(pc, ew_re=pc["ew_re"][:, :4].contiguous())
    elif case == "dot shape":
        pc = dict(pc, dot=torch.zeros(3, 2))
    elif case == "dtype":
        planes = planes.double()
    elif case == "istate dtype":
        is_ = is_.long()
    elif case == "contiguous":
        planes = planes.mT.contiguous().mT
    elif case == "device":
        post = pst.symtrack_stream().post.to("meta")
    elif case == "npfb":
        return (planes, kern, fs, is_, pc, post), dict(KW, max_out=0)
    elif case == "win":
        return (planes, kern, fs, is_, pc, post), dict(KW, win=33)
    return (planes, kern, fs, is_, pc, post), KW


@pytest.mark.parametrize("case", ["planes shape", "kern shape",
                                  "state shape", "pll key", "pll shape",
                                  "dot shape", "dtype", "istate dtype",
                                  "contiguous", "device", "npfb", "win"])
def test_wrapper_checks(case):
    args, kw = _bad(case)
    with pytest.raises(ValueError):
        fk.symsync_pll_lms(*args, **kw)


def test_wrapper_takes_its_post_as_pll_lms_post():
    planes, kern, fs, is_, pc, post = _case()
    with pytest.raises(TypeError, match="PllLmsPost"):
        fk.symsync_pll_lms(planes, kern, fs, is_, pc, lambda *a: a, **KW)


def test_wrapper_refuses_other_devices():
    # neither the CPU (plain version) nor CUDA (the kernel): refused
    planes, kern, fs, is_, pc, post = _case()
    meta = [t.to("meta") for t in (planes, kern, fs, is_)]
    pcm = {k: v.to("meta") for k, v in pc.items()}
    with pytest.raises(ValueError, match="runs on CUDA"):
        fk.symsync_pll_lms(*meta, pcm, post.to("meta"), **KW)


def test_post_follows_the_tracker_and_keeps_its_state_dict():
    st = pst.symtrack_stream(ms="qam16")
    assert isinstance(st.post, fk.PllLmsPost) and st.post.qpsk is None
    assert not any(k.startswith("post.") for k in st.state_dict())
    st = st.double()
    assert st.post.tab_re.dtype == torch.float64      # a submodule: moved
    assert st.pll_kwargs() == st.post.kwargs()
    assert pst.symtrack_stream().post.qpsk is not None   # the sign slicer


@pytest.mark.parametrize("env,device,batch,want", [
    ("1", "cpu", (2,), True), ("1", "cuda", (300,), True),
    ("0", "cuda", (300,), False), ("0", "cpu", (2,), False),
    (None, "cpu", (), False), (None, "cpu", (300,), False),
    (None, "cuda", (), True), (None, "cuda", (1,), True),
    (None, "cuda", (8, 32), True), (None, torch.device("cuda", 0), (256,),
                                    True)])
def test_use_fused_rule(monkeypatch, env, device, batch, want):
    # the override, the CPU's sequential default, the card's fused route
    # at every channel count (its measured crossover is below one)
    if env is None:
        monkeypatch.delenv("LIQUID_SYMTRACK_FUSED", raising=False)
    else:
        monkeypatch.setenv("LIQUID_SYMTRACK_FUSED", env)
    assert pst._use_fused(batch, device) is want


def test_foreign_post_is_refused_on_cuda():
    # the decision, taken before any tensor reaches the card: symtrack's
    # PllLmsPost runs in the fused kernel, any other callable raises there
    # (Not carried over), and on the CPU every hook runs in the plain loop
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    post = pst.symtrack_stream().post
    assert pss._fused_kernel(post, cuda) is True
    assert pss._fused_kernel(post, cpu) is False
    assert pss._fused_kernel(None, cuda) is False
    with pytest.raises(NotImplementedError, match="Not carried over"):
        pss._fused_kernel(lambda pc, yr, yi, vm: (pc, ()), cuda)
    with pytest.raises(NotImplementedError, match="Not carried over"):
        pss._fused_kernel(pk.pll_lms_step, cuda)
    assert pss._fused_kernel(lambda *a: a, cpu) is False


def test_hoisted_run_with_a_post_returns_no_timing_slots():
    # with a post hook the hoisted run returns the hook's outputs, the mask
    # and both carries, and y None (the fused kernel keeps the timing
    # loop's slots to itself; the CPU returns what the card returns)
    q = pss.symsync(k=2, m=7, bw=0.02)
    st = pst.symtrack_stream()
    x = torch.from_numpy(_stream(2, 300, "qpsk", 9))
    c = q.init((2,))
    pc = st.pll_state(st.init(batch_shape=(2,)), 2)
    y, v, c2, ex, pc2 = pss._symsync_run_hoisted(
        q.mf, q.dmf, c, x, 2, 1, 0.02, post=st.post, post_carry=pc)
    ys, vs, cs = pss._symsync_run_hoisted(q.mf, q.dmf, c, x, 2, 1, 0.02)
    assert y is None and v.shape == (2, 1800) and torch.equal(v, vs)
    assert [e.shape for e in ex] == [(2, 1800)] * 3
    for key in cs:
        assert torch.equal(c2[key], cs[key]), key
    assert set(pc2) == set(pk.STATE_KEYS)
