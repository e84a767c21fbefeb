"""Port parity: symsync of liquid_dsp_tpu_torch against the JAX package on
the same seeded inputs, with the tolerances of the reference's own tests.

* design (prototypes, banks, loop constants): bit-equal, the same float64
  numpy formulas;
* the timing-loop kernel's plain version against the JAX package's Pallas
  kernel in interpret mode on the same branch outputs and states:
  bit-equal (tests/test_symsync_misc.py:419-445 holds the kernel to the
  scan at atol 0);
* the hoisted path against the JAX package's hoisted path: bit-equal
  (same conv sums on the CPU, same loop arithmetic);
* the scan-body path and the golden of the compiled reference: valid
  masks equal, symbols within 1e-5 (tests/test_symsync_misc.py:201-216;
  the per-step window dots are summed in another order).
"""
import pathlib
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu.design import firdes as jfirdes
from liquid_dsp_tpu.ops import symsync as jss
from liquid_dsp_tpu.ops.kernels.pallas_symsync import symsync_scan_pallas
from liquid_dsp_tpu_torch.convert import carry_from_numpy, carry_to_numpy
from liquid_dsp_tpu_torch.design import firdes
from liquid_dsp_tpu_torch.ops import symsync as ss
from liquid_dsp_tpu_torch.ops.kernels import symsync_scan as sk

GOLDEN = pathlib.Path(__file__).parent / "golden" / "flexframe_golden.npz"


def _stream(seed, shape, scale=0.5):
    return tp.cnoise(np.random.default_rng(seed), shape) * scale


@pytest.mark.parametrize("ftype", ["kaiser", "arkaiser", "rkaiser", "rrcos",
                                   "rrc", "ARKAISER"])
@pytest.mark.parametrize("k,m,beta,dt", [(2, 5, 0.3, 0.0), (2, 7, 0.3, 0.25),
                                         (4, 3, 0.5, -0.4), (64, 5, 0.3, 0.0)])
def test_firdes_prototype_bit_equal(ftype, k, m, beta, dt):
    h = firdes.firdes_prototype(ftype, k, m, beta, dt)
    ref = jfirdes.firdes_prototype(ftype, k, m, beta, dt)
    assert h.dtype == ref.dtype
    np.testing.assert_array_equal(h, ref)


def test_firdes_rrcos_and_unported_prototypes():
    for beta in (0.0, 0.25, 0.3, 1.0):
        np.testing.assert_array_equal(firdes.firdes_rrcos(4, 3, beta),
                                      jfirdes.firdes_rrcos(4, 3, beta))
    np.testing.assert_array_equal(firdes.firdes_prototype("rcos", 2, 5, 0.3),
                                  jfirdes.firdes_prototype("rcos", 2, 5, 0.3))


@pytest.mark.parametrize("ftype,k,m,beta", [("arkaiser", 2, 5, 0.3),
                                            ("rrcos", 2, 5, 0.3),
                                            ("rkaiser", 2, 7, 0.35),
                                            ("arkaiser", 4, 3, 0.5)])
def test_banks_bit_equal(ftype, k, m, beta):
    for got, ref in zip(ss.symsync_banks(ftype, k, m, beta, 32),
                        jss.symsync_banks(ftype, k, m, beta, 32)):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_kaiser_banks_and_loop_constants_bit_equal():
    for got, ref in zip(ss.symsync_kaiser_banks(2, 5, 32),
                        jss.symsync_kaiser_banks(2, 5, 32)):
        np.testing.assert_array_equal(got, ref)
    for bw in (0.01, 0.02, 0.3):
        C = jss._lf_consts(bw)
        assert sk.loop_consts(bw) == tuple(float(np.float32(v)) for v in (
            C["B0"] / C["A0"], -(C["A1"] / C["A0"]), C["rate_adj"]))


def _state(rng, B):
    fs = np.zeros((6, B), np.float32)
    fs[0] = rng.uniform(-0.3, 0.9, B)
    fs[1] = fs[2] = 2.0
    fs[3] = rng.uniform(-0.01, 0.01, B)
    fs[4] = fs[0] * 32
    is_ = np.stack([np.round(fs[4]), rng.integers(1, 3, B)]).astype(np.int32)
    return fs, is_


@pytest.mark.parametrize("G,bw,locked,k,k_out", [
    (4, 0.02, False, 2, 1), (2, 0.02, False, 2, 1), (4, 0.3, False, 2, 1),
    (4, 0.02, True, 2, 1), (4, 0.05, False, 3, 2)])
def test_kernel_plain_version_bit_equal_to_pallas(G, bw, locked, k, k_out):
    rng = np.random.default_rng(G + int(100 * bw) + k)
    T, B, npfb = 256, 3, 32
    max_out = int(np.ceil(k / k_out)) + 1
    ma = (rng.standard_normal((T, B, G * npfb)) * 0.7).astype(np.float32)
    fs, is_ = _state(rng, B)
    want = [np.asarray(o) for o in symsync_scan_pallas(
        jnp.asarray(ma), jnp.asarray(fs), jnp.asarray(is_), npfb=npfb, G=G,
        max_out=max_out, k=k, k_out=k_out, bw=bw, locked=locked,
        interpret=True)]
    # the TPU kernel's ma[t, b, g*npfb + j] is ma[g//2, b, (g%2)*npfb + j, t]
    nat = torch.from_numpy(ma).reshape(T, B, G // 2, 2 * npfb).permute(
        2, 1, 3, 0).contiguous()
    launches = sk.symsync_scan.launches
    y_re, y_im, valid, fs2, is2 = sk.symsync_scan(
        nat, torch.from_numpy(fs), torch.from_numpy(is_), npfb=npfb,
        max_out=max_out, k=k, k_out=k_out, bw=bw, locked=locked)
    assert sk.symsync_scan.launches == launches      # the plain version
    flat = [w.transpose(1, 0, 2).reshape(B, -1) for w in want[:3]]
    np.testing.assert_array_equal(y_re.numpy(), flat[0])
    np.testing.assert_array_equal(y_im.numpy(), flat[1])
    np.testing.assert_array_equal(valid.numpy(), flat[2] > 0.5)
    np.testing.assert_array_equal(fs2.numpy(), want[3])
    np.testing.assert_array_equal(is2.numpy(), want[4])


def _round_f32(e):
    """The float32 nearest the exact Fraction e, ties to even."""
    lo = np.float32(float(e))
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - e),
                                     int(np.float32(v).view(np.int32)) & 1))


def test_fma32_rounds_once():
    # a*b + c lands 2^-60 off a float32 midpoint: the float64 sum rounds
    # onto the midpoint, and one rounding must still go the exact side
    a = 2.0 ** -12 * (1 + 2.0 ** -18)
    b = 2.0 ** -12 * (1 - 2.0 ** -18)
    c = 1 + 2.0 ** -23
    got = sk.fma32(torch.tensor([a, a]), torch.tensor([b, -b]),
                   torch.tensor([c, c]))
    assert got.tolist() == [c, c]
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy((rng.standard_normal(2000) * 10.0 ** rng.integers(
        -3, 3, 2000)).astype(np.float32)) for _ in range(3)]
    got = sk.fma32(*xs).numpy()
    for i in range(0, 2000, 7):
        e = (Fraction(float(xs[0][i])) * Fraction(float(xs[1][i]))
             + Fraction(float(xs[2][i])))
        assert got[i] == _round_f32(e), i


def test_wrapper_checks_and_never_falls_back_off_cpu(monkeypatch):
    ma = torch.zeros(2, 3, 64, 10)
    fs, is_ = torch.zeros(6, 3), torch.zeros(2, 3, dtype=torch.int32)
    kw = dict(npfb=32, max_out=3, k=2, k_out=1, bw=0.02, locked=False)
    with pytest.raises(ValueError, match="ma"):
        sk.symsync_scan(torch.zeros(3, 3, 64, 10), fs, is_, **kw)
    with pytest.raises(ValueError, match="int32"):
        sk.symsync_scan(ma, fs, is_.float(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sk.symsync_scan(ma.transpose(0, 1).contiguous().transpose(0, 1),
                        fs, is_, **kw)

    def plain(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(sk, "symsync_scan_reference", plain)
    with pytest.raises(ValueError, match="device"):
        sk.symsync_scan(ma.to("meta"), fs, is_, **kw)
    with pytest.raises(ValueError, match="device"):
        sk.symsync_scan(ma.to("meta"), fs.to("meta"), is_.to("meta"), **kw)


def _jax_run(q, c0, x, hoist, monkeypatch, kernel):
    monkeypatch.setenv("LIQUID_SYMSYNC_KERNEL", kernel)
    mf, dmf = q.params["mf"], q.params["dmf"]
    y, v, c = jss.symsync_run(np.asarray(mf), np.asarray(dmf), c0,
                              jnp.asarray(x), 2, bw=0.02, hoist=hoist)
    return np.asarray(y), np.asarray(v), tp.to_numpy(c)


def _port_run(q, c0, x, hoist):
    y, v, c = ss.symsync_run(q.mf, q.dmf, carry_from_numpy(tp.to_numpy(c0)),
                             torch.from_numpy(x), 2, bw=0.02, hoist=hoist)
    return y.numpy(), v.numpy(), carry_to_numpy(c)


@pytest.mark.parametrize("kernel", ["0", "1"])
@pytest.mark.parametrize("batch,T", [((2,), 1024), ((), 768)])
def test_hoisted_bit_equal_to_jax(monkeypatch, kernel, batch, T):
    # LIQUID_SYMSYNC_KERNEL drives both packages: the JAX package's Pallas
    # kernel (interpret mode) or its scan, the port's kernel wrapper (its
    # plain version here) or its loop
    x = _stream(T, batch + (T,))
    jq = jss.symsync("arkaiser", 2, 5, 0.3, bw=0.02)
    pq = ss.symsync("arkaiser", 2, 5, 0.3, bw=0.02)
    c0 = jq.init(batch)
    yj, vj, cj = _jax_run(jq, c0, x, True, monkeypatch, kernel)
    yp, vp, cp = _port_run(pq, c0, x, True)
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_array_equal(yp, yj)
    for key in cj:
        np.testing.assert_array_equal(cp[key], cj[key], err_msg=key)


@pytest.mark.parametrize("dtype,T", [(np.complex64, 512), (np.float32, 300)])
def test_scan_path_matches_jax(monkeypatch, dtype, T):
    x = _stream(7, (2, T))
    x = x if dtype == np.complex64 else np.ascontiguousarray(x.real)
    jq = jss.symsync("arkaiser", 2, 5, 0.3, bw=0.02)
    pq = ss.symsync("arkaiser", 2, 5, 0.3, bw=0.02)
    c0 = jq.init((2,), dtype=jnp.dtype(dtype))
    yj, vj, cj = _jax_run(jq, c0, x, False, monkeypatch, "0")
    yp, vp, cp = _port_run(pq, c0, x, False)
    assert yp.dtype == yj.dtype
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_allclose(yp, yj, rtol=0, atol=1e-5)
    for key in cj:
        # bf = tau * npfb carries tau's difference times 32
        np.testing.assert_allclose(cp[key], cj[key], rtol=0,
                                   atol=32e-5 if key == "bf" else 1e-5,
                                   err_msg=key)


def test_golden_sample_exact():
    g = dict(np.load(GOLDEN))
    p = ss.symsync("rrcos", 2, 5, 0.3, npfb=32)
    (y, v), _ = p(p.init(), torch.from_numpy(g["symsync_x"]))
    y = y[v].numpy()
    assert len(y) == len(g["symsync_y"])
    assert np.abs(y - g["symsync_y"]).max() < 1e-5


@pytest.mark.parametrize("hoist", [None, True])
def test_streaming_matches_oneshot(monkeypatch, hoist):
    x = _stream(4, (1024,))
    q = ss.symsync("arkaiser", 2, 5, 0.3, bw=0.02)
    run = ss.symsync_run
    monkeypatch.setattr(ss, "symsync_run",
                        lambda *a, **kw: run(*a, **kw, hoist=hoist))
    (y1, v1), _ = q(q.init(), torch.from_numpy(x))
    c, ys = q.init(), []
    for blk in x.reshape(4, -1):
        (yb, vb), c = q(c, torch.from_numpy(blk.copy()))
        ys.append(yb[vb])
    np.testing.assert_allclose(torch.cat(ys).numpy(), y1[v1].numpy(),
                               rtol=0, atol=1e-5)


def test_ragged_chunks_match_equal_chunks(monkeypatch):
    # the card's chunking (at most CUDA_CHUNK steps, ragged last chunk) on
    # the CPU against the JAX package's equal chunks
    x = _stream(9, (2, 1000))
    q = ss.symsync("arkaiser", 2, 5, 0.3, bw=0.02)
    c0 = q.init((2,))
    y1, v1, c1 = ss._symsync_run_hoisted(q.mf, q.dmf, c0,
                                         torch.from_numpy(x), 2, bw=0.02)
    assert ss._chunks(1000, False) == [(0, 1000)]
    monkeypatch.setattr(ss, "CUDA_CHUNK", 384)
    assert ss._chunks(1000, True) == [(0, 384), (384, 384), (768, 232)]
    chunks = ss._chunks
    monkeypatch.setattr(ss, "_chunks", lambda T, cuda: chunks(T, True))
    y2, v2, c2 = ss._symsync_run_hoisted(q.mf, q.dmf, c0,
                                         torch.from_numpy(x), 2, bw=0.02)
    assert torch.equal(v1, v2)
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), rtol=0, atol=1e-6)
    for key in c1:
        np.testing.assert_allclose(c2[key].numpy(), c1[key].numpy(),
                                   rtol=0, atol=1e-6, err_msg=key)


def test_symsync_kaiser_matches_jax():
    x = _stream(5, (700,))
    jq = jss.symsync_kaiser(2, 5, bw=0.02)
    pq = ss.symsync_kaiser(2, 5, bw=0.02)
    (yj, vj), _ = jq(jnp.asarray(x), batch_shape=())
    (yp, vp), _ = pq(pq.init(), torch.from_numpy(x))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=0, atol=1e-5)


def test_jax_carry_continues_in_the_port():
    x = _stream(6, (2, 1024))
    jq = jss.symsync("arkaiser", 2, 5, 0.3, bw=0.02)
    pq = ss.symsync("arkaiser", 2, 5, 0.3, bw=0.02)
    (_, _), cj = jq.apply(jq.params, jq.init((2,)), jnp.asarray(x[:, :512]))
    (yj, vj), cj2 = jq.apply(jq.params, cj, jnp.asarray(x[:, 512:]))
    cp = carry_from_numpy(tp.to_numpy(cj))
    assert cp["b"].dtype == torch.int32 and cp["win"].dtype == torch.complex64
    (yp, vp), cp2 = pq(cp, torch.from_numpy(x[:, 512:].copy()))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=0, atol=1e-5)
    # and back: the port's carry continues in the JAX package
    back = {k: jnp.asarray(v) for k, v in carry_to_numpy(cp2).items()}
    (yj3, _), _ = jq.apply(jq.params, back, jnp.asarray(x[:, :256]))
    (yj4, _), _ = jq.apply(jq.params, cj2, jnp.asarray(x[:, :256]))
    np.testing.assert_allclose(np.asarray(yj3), np.asarray(yj4), rtol=0,
                               atol=1e-5)


def test_kernel_policy(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("LIQUID_SYMSYNC_KERNEL", raising=False)
    assert ss._use_scan_kernel(cuda, None)
    assert not ss._use_scan_kernel(cuda, lambda *a: a)
    assert not ss._use_scan_kernel(cpu, None)
    monkeypatch.setenv("LIQUID_SYMSYNC_KERNEL", "1")
    assert ss._use_scan_kernel(cpu, None)
    assert not ss._use_scan_kernel(cpu, lambda *a: a)
