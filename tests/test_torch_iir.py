"""Port parity for `ops/iir.py`: the IIR filters against the JAX package
on the CPU and against the reference C library's goldens.

Tolerances: the goldens at 1e-3 absolute (tests/test_agc_eq_iir.py, the
reference autotest's tol); the port's scan against the JAX scan, and the
port's block form against the JAX block form, at 1e-5 absolute on unit
inputs (the same float32 recurrence; the JAX package's own block-versus-
scan bound is 1e-4, tests/test_agc_eq_iir.py::TestBlockIIR); the factory
goldens at 1e-3 of the response scale (tests/test_iir_factory.py).  On the
CPU both backends run the kernels' plain versions (`ops/kernels/
iir_scan.py`, `ops/kernels/iir_block_state.py`)."""
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from liquid_dsp_tpu.design.iirdes import iirdes, iirdes_sos
from liquid_dsp_tpu.ops import iir as J
from liquid_dsp_tpu_torch.convert import carry_from_numpy, load_jax_params
from liquid_dsp_tpu_torch.ops import iir as P

GOLDEN = pathlib.Path(__file__).parent / "golden"
STEMS = [f"iirfilt_{k}_data_h{n}x64" for k in ("rrrf", "crcf", "cccf")
         for n in (3, 5, 7)]


def _golden(stem):
    d = np.load(GOLDEN / f"{stem}.npz")
    return {k[len(stem) + 1:]: d[k] for k in d.files}


def _close(y, ref, tol, what=""):
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape, (what, y.shape, ref.shape)
    err = float(np.abs(y - ref).max()) if y.size else 0.0
    assert err <= tol, f"{what}: max|err| {err:.3e} > {tol:.0e}"


@pytest.mark.parametrize("backend", ["scan", "block"])
@pytest.mark.parametrize("stem", STEMS)
def test_golden(stem, backend):
    d = _golden(stem)
    q = P.iirfilt(d["b"], d["a"], backend=backend)
    y, _ = q(q.init(dtype=torch.from_numpy(d["x"]).dtype),
             torch.from_numpy(d["x"]))
    _close(y.numpy(), d["y"], 1e-3, stem)


@pytest.mark.parametrize("backend", ["scan", "block"])
@pytest.mark.parametrize("ftype,order", [("butter", 3), ("butter", 7),
                                         ("ellip", 5), ("cheby2", 4)])
def test_sos_matches_jax(ftype, order, backend):
    B, A = iirdes_sos(ftype, order, 0.17)
    x = tp.cnoise(np.random.default_rng(order), (2, 1000))
    jq, pq = (m.iirfilt_sos(B, A, backend=backend) for m in (J, P))
    yj, cj = tp.run_jax(jq, [x], (2,))
    yt, ct = tp.run_torch(pq, [x], (2,))
    _close(yt, yj, 1e-5, "y")
    _close(ct.numpy(), np.asarray(cj), 1e-5, "carry")


@pytest.mark.parametrize("backend", ["scan", "block"])
@pytest.mark.parametrize("T", [100, 1000])   # 100 < L: the remainder only
def test_tf_matches_jax(T, backend):
    b = np.array([0.2, 0.3, 0.1, 0.05])
    a = np.array([1.0, -0.5, 0.2, -0.04])
    x = np.random.default_rng(3).standard_normal((1, T)).astype(np.float32)
    jq, pq = (m.iirfilt(b, a, backend=backend) for m in (J, P))
    yj, cj = tp.run_jax(jq, [x[0]], (), carry=jq.init(dtype=jnp.float32))
    pc = pq.init(dtype=torch.float32)
    yt, ct = pq(pc, torch.from_numpy(x[0]))
    _close(yt.numpy(), yj, 1e-5, "y")
    _close(ct.numpy(), np.asarray(cj), 1e-5, "carry")


def test_block_and_scan_agree_with_ragged_blocks_on_cccf():
    d = _golden("iirfilt_cccf_data_h7x64")
    x = tp.cnoise(np.random.default_rng(5), (3, 700))
    ys = {}
    for backend in ("scan", "block"):
        q = P.iirfilt(d["b"], d["a"], backend=backend, block_size=32)
        ys[backend] = tp.run_torch(q, [x[:, :45], x[:, 45:333], x[:, 333:]],
                                   (3,))
    _close(ys["block"][0], ys["scan"][0], 1e-4, "y")
    _close(ys["block"][1].numpy(), ys["scan"][1].numpy(), 1e-4, "carry")


def test_block_streaming_odd_splits_matches_jax_one_shot():
    B, A = iirdes_sos("butter", 5, 0.2)
    x = np.random.default_rng(7).standard_normal(1000).astype(np.float32)
    jq = J.iirfilt_sos(B, A, backend="block")
    y_once, _ = jq(jnp.asarray(x), batch_shape=(), dtype=jnp.float32)
    q = P.iirfilt_sos(B, A, backend="block")
    c, ys = q.init(dtype=torch.float32), []
    for blk in np.split(x, [130, 390, 517]):    # none a multiple of L
        yb, c = q(c, torch.from_numpy(blk))
        ys.append(yb.numpy())
    _close(np.concatenate(ys), np.asarray(y_once), 1e-5)


@pytest.mark.parametrize("backend", ["block", "auto", "scan"])
def test_unstable_filter_pins_scan(backend):
    q = P.iirfilt([1.0], [1.0, -1.5], backend=backend)
    jq = J.iirfilt([1.0], [1.0, -1.5], backend=backend)
    assert q.backend == "scan" and set(q.param_spec) == set(jq.params)
    assert not q.uses_block(types.SimpleNamespace(
        device=torch.device("cuda")))
    x = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    y, _ = q(q.init(dtype=torch.float32), torch.from_numpy(x))
    yj, _ = jq(jnp.asarray(x), batch_shape=(), dtype=jnp.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5)


def test_auto_picks_by_the_inputs_device():
    on = types.SimpleNamespace
    cuda, cpu = on(device=torch.device("cuda")), on(device=torch.device("cpu"))
    B, A = iirdes_sos("butter", 7, 0.2)        # 8 states
    assert P.iirfilt_sos(B, A).uses_block(cuda)
    assert not P.iirfilt_sos(B, A).uses_block(cpu)
    assert not P.iirfilt_sos(B, A, backend="scan").uses_block(cuda)
    assert P.iirfilt_sos(B, A, backend="block").uses_block(cpu)
    B9, A9 = iirdes_sos("butter", 9, 0.2)      # 10 states: the block form
    assert P.iirfilt_sos(B9, A9).uses_block(cuda)
    assert not P.iirfilt_sos(B9, A9).uses_block(cpu)
    B33, A33 = iirdes_sos("butter", 33, 0.2)   # 34 states: above the limit
    assert not P.iirfilt_sos(B33, A33).uses_block(cuda)


@pytest.mark.parametrize("form,order", [("sos", 9), ("sos", 12), ("sos", 16),
                                        ("tf", 9)])
def test_explicit_block_takes_up_to_32_states(form, order):
    # the state pass's kernel gives each state a lane: an explicit 'block'
    # above 8 states builds and runs, streamed across blocks, and matches
    # the JAX package's block form and its scan
    if form == "sos":
        B, A = iirdes_sos("butter", order, 0.2)
        make = (lambda m, be: m.iirfilt_sos(B, A, backend=be))
    else:
        b, a = iirdes("butter", order, 0.2)
        make = (lambda m, be: m.iirfilt(b, a, backend=be))
    q = make(P, "block")
    assert q.backend == "block" and q.p == order + (order % 2) * (
        form == "sos")
    x = tp.cnoise(np.random.default_rng(order), (2, 700))
    blocks = [x[:, :130], x[:, 130:390], x[:, 390:]]   # none a multiple of L
    yt, ct = tp.run_torch(q, blocks, (2,))
    for be in ("block", "scan"):
        yj, cj = tp.run_jax(make(J, be), blocks, (2,))
        _close(yt, yj, 1e-5, f"y vs the JAX {be}")
        _close(ct.numpy(), np.asarray(cj), 1e-5, f"carry vs the JAX {be}")


def test_explicit_block_refuses_more_than_32_states():
    # the block form's 32-state limit is the state pass kernel's, so it is
    # checked on CUDA tensors only, at the call (tests/test_torch_cuda.py):
    # the filter builds, and 'auto' still keeps the card on the scan
    B, A = iirdes_sos("butter", 33, 0.2)       # 34 states, stable
    q = P.iirfilt_sos(B, A, backend="block")
    assert q.backend == "block" and q.p == 34
    assert q.uses_block(types.SimpleNamespace(device=torch.device("cpu")))
    assert P.iirfilt_sos(B, A).backend == "auto"
    assert not P.iirfilt_sos(B, A).uses_block(types.SimpleNamespace(
        device=torch.device("cuda")))


def _queue3_tf(order):
    """ROADMAP queue 3's input case: a = [1, 0, ..., 0, -0.5] (poles at
    radius 0.5 ** (1 / order), stable), b seeded normal x 0.1."""
    b = np.random.default_rng(order).standard_normal(order + 1) * 0.1
    a = np.zeros(order + 1)
    a[0], a[-1] = 1.0, -0.5
    return b, a


def _close_rel(y, ref, rtol, what=""):
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape and np.isfinite(y).all(), what
    err = float(np.abs(y - ref).max() / np.abs(ref).max())
    assert err <= rtol, f"{what}: max|err| / max|ref| {err:.3e} > {rtol:.0e}"


@pytest.mark.parametrize("order", [17, 33, 40])
def test_high_order_tf_matches_jax(order):
    # above the 16th order the kernel once held in registers: the scan's
    # plain version on the CPU against the JAX scan, a carried block pair,
    # 1e-5 of the output's scale (the same float32 recurrence)
    b, a = _queue3_tf(order)
    x = tp.cnoise(np.random.default_rng(order + 1), (2, 512))
    blocks = [x[:, :256], x[:, 256:]]
    yj, cj = tp.run_jax(J.iirfilt(b, a), blocks, (2,))
    yt, ct = tp.run_torch(P.iirfilt(b, a), blocks, (2,))
    _close_rel(yt, yj, 1e-5, "y")
    _close_rel(ct.numpy(), np.asarray(cj), 1e-5, "carry")


@pytest.mark.parametrize("ns", [9, 17, 20])
def test_long_sos_cascade_matches_jax(ns):
    # more second-order sections than one launch takes on the card: the
    # plain version on the CPU against the JAX scan, 1e-5 of the scale
    B = np.tile([0.2, 0.4, 0.2], (ns, 1))
    A = np.tile([1.0, -0.5, 0.2], (ns, 1))
    x = tp.cnoise(np.random.default_rng(ns), (2, 512))
    blocks = [x[:, :300], x[:, 300:]]
    yj, cj = tp.run_jax(J.iirfilt_sos(B, A), blocks, (2,))
    yt, ct = tp.run_torch(P.iirfilt_sos(B, A), blocks, (2,))
    _close_rel(yt, yj, 1e-5, "y")
    _close_rel(ct.numpy(), np.asarray(cj), 1e-5, "carry")


def test_block_form_of_40_states_on_the_cpu():
    # an explicit 'block' above the state pass kernel's 32 lanes runs on
    # the CPU (its plain version takes any order) and matches the JAX
    # package's block form (1e-5 of the scale) and its scan (1e-4, the JAX
    # package's own block-versus-scan bound)
    b, a = _queue3_tf(40)
    x = tp.cnoise(np.random.default_rng(41), (2, 700))
    blocks = [x[:, :130], x[:, 130:390], x[:, 390:]]
    q = P.iirfilt(b, a, backend="block")
    assert q.backend == "block" and q.p == 40
    yt, ct = tp.run_torch(q, blocks, (2,))
    for be, tol in (("block", 1e-5), ("scan", 1e-4)):
        yj, cj = tp.run_jax(J.iirfilt(b, a, backend=be), blocks, (2,))
        _close_rel(yt, yj, tol, f"y vs the JAX {be}")
        _close_rel(ct.numpy(), np.asarray(cj), tol, f"carry vs the JAX {be}")


def test_remaining_backend_refusals():
    # 'pscan' is SOS-only, as in the JAX package (iirfilt raises), and an
    # unknown backend raises in both constructors; iirfilt_sos takes pscan
    B, A = iirdes_sos("butter", 3, 0.2)
    for make in (lambda: P.iirfilt([1.0, 0.5], [1.0, -0.5], backend="pscan"),
                 lambda: J.iirfilt([1.0, 0.5], [1.0, -0.5], backend="pscan"),
                 lambda: P.iirfilt_sos(B, A, backend="fast"),
                 lambda: P.iirfilt([1.0, 0.5], [1.0, -0.5], backend="fast")):
        with pytest.raises(ValueError):
            make()
    assert P.iirfilt_sos(B, A, backend="pscan").backend == "pscan"


@pytest.mark.parametrize("backend", ["auto", "scan", "block"])
def test_params_load_from_a_jax_proc(backend):
    b, a = iirdes("cheby1", 4, 0.2)
    jq = J.iirfilt(b, a, backend=backend)
    q = P.iirfilt(*iirdes("butter", 4, 0.3), backend=backend)
    load_jax_params(q, tp.jax_params(jq))   # every buffer overwritten
    x = tp.cnoise(np.random.default_rng(2), (2, 300))
    jc = jq.init(batch_shape=(2,))
    y1, jc = jq.apply(jq.params, jc, jnp.asarray(x[:, :150]))
    yj, _ = jq.apply(jq.params, jc, jnp.asarray(x[:, 150:]))
    yt, _ = q(carry_from_numpy(tp.to_numpy(jc)), torch.from_numpy(
        x[:, 150:]))
    _close(yt.numpy(), np.asarray(yj), 1e-5)


def test_carry_moves_between_backends():
    B, A = iirdes_sos("butter", 4, 0.1)
    rng = np.random.default_rng(11)
    x1, x2 = (torch.from_numpy(rng.standard_normal(300).astype(np.float32))
              for _ in range(2))
    qs = P.iirfilt_sos(B, A, backend="scan")
    qb = P.iirfilt_sos(B, A, backend="block")
    _, c = qs(qs.init(dtype=torch.float32), x1)
    _close(qb(c, x2)[0].numpy(), qs(c, x2)[0].numpy(), 1e-5)


def test_planar_forward_equals_complex_forward():
    B, A = iirdes_sos("ellip", 5, 0.15)
    q = P.iirfilt_sos(B, A)
    x = torch.from_numpy(tp.cnoise(np.random.default_rng(4), (3, 200)))
    y, c = q(q.init(batch_shape=(3,)), x)
    (yr, yi), (cr, ci) = q.forward_planar(q.init_planar(batch_shape=(3,)),
                                          (x.real, x.imag))
    np.testing.assert_array_equal(torch.complex(yr, yi).numpy(), y.numpy())
    np.testing.assert_array_equal(torch.complex(cr, ci).numpy(), c.numpy())
    assert P.iirfilt(_golden("iirfilt_cccf_data_h3x64")["b"], [1.0, 0.2]
                     ).forward_planar is None


@pytest.mark.parametrize("make", ["integrator", "differentiator",
                                  "dc_blocker", "pll"])
def test_factory_filters_match_jax(make):
    args = {"dc_blocker": (0.05,), "pll": (0.02, 0.7071, 1000.0)}.get(make,
                                                                      ())
    jq = getattr(J, f"iirfilt_{make}")(*args)
    q = getattr(P, f"iirfilt_{make}")(*args)
    t = np.arange(1000)
    x = np.exp(2j * np.pi * (0.01 + 2e-4 * t) * t).astype(np.complex64)
    yj, _ = tp.run_jax(jq, [x[:600], x[600:]], ())
    yt, _ = tp.run_torch(q, [x[:600], x[600:]], ())
    scale = max(1.0, float(np.abs(yj).max()))
    _close(yt / scale, yj / scale, 1e-5, make)


@pytest.mark.parametrize("tag", ["dcblock", "pll"])
def test_factory_goldens(tag):
    g = np.load(GOLDEN / "iirfactory_golden.npz")
    q = {"dcblock": lambda: P.iirfilt_dc_blocker(0.05),
         "pll": lambda: P.iirfilt_pll(0.02, 0.7071, 1000.0)}[tag]()
    x = torch.from_numpy(g["input"])
    y, _ = q(q.init(dtype=x.dtype), x)
    scale = max(1.0, float(np.max(np.abs(g[tag]))))
    assert np.max(np.abs(y.numpy() - g[tag])) / scale < 1e-3


def test_factory_parameters_are_checked():
    for bad in ((1.5, 0.7, 1.0), (0.1, 1.5, 1.0), (0.1, 0.7, -1.0)):
        with pytest.raises(ValueError):
            P.iirfilt_pll(*bad)
    with pytest.raises(ValueError):
        P.iirfilt_dc_blocker(1.5)


def test_frequency_response_and_group_delay_match_jax():
    b, a = [0.2, 0.4, 0.2], [1.0, -0.3, 0.1]
    f = np.linspace(-0.5, 0.5, 41)
    np.testing.assert_array_equal(P.iir_freqresponse(b, a, f),
                                  J.iir_freqresponse(b, a, f))
    np.testing.assert_array_equal(P.iir_group_delay(b, a, f),
                                  J.iir_group_delay(b, a, f))
    fg = np.load(GOLDEN / "flexframe_golden.npz")
    assert abs(P.iir_group_delay(b, a, 0.1) - np.real(fg["gdelay_iir"])[0]) \
        < 1e-3


@pytest.mark.parametrize("sos", [False, True])
def test_init_matches_jax(sos):
    B, A = iirdes_sos("cheby2", 5, 0.2)
    b, a = iirdes("cheby2", 5, 0.2)
    jq = J.iirfilt_sos(B, A) if sos else J.iirfilt(b, a)
    q = P.iirfilt_sos(B, A) if sos else P.iirfilt(b, a)
    cj, c = jq.init(batch_shape=(4, 2)), q.init(batch_shape=(4, 2))
    assert tuple(c.shape) == cj.shape and str(c.dtype)[6:] == str(cj.dtype)


def test_apply_functions_match_jax():
    rng = np.random.default_rng(9)
    b = np.array([0.3, -0.2, 0.1], np.float32)
    a = np.array([1.0, -0.4, 0.2], np.float32)
    x = rng.standard_normal((2, 50)).astype(np.float32)
    c = rng.standard_normal((2, 2)).astype(np.float32)
    yj, sj = J.iir_apply_tf(jnp.asarray(b), jnp.asarray(a), jnp.asarray(c),
                            jnp.asarray(x))
    yt, st = P.iir_apply_tf(*(torch.from_numpy(v) for v in (b, a, c, x)))
    _close(yt.numpy(), yj, 1e-5)
    _close(st.numpy(), sj, 1e-5)
    Bs, As = (np.stack([v, v[::-1] * [1, 0.5, 0.25]]).astype(np.float32)
              for v in (b, a))
    As[:, 0] = 1.0
    cs = rng.standard_normal((2, 2, 2)).astype(np.float32)
    yj, sj = J.iir_apply_sos(jnp.asarray(Bs), jnp.asarray(As),
                             jnp.asarray(cs), jnp.asarray(x))
    yt, st = P.iir_apply_sos(*(torch.from_numpy(v)
                               for v in (Bs, As, cs, x)))
    _close(yt.numpy(), yj, 1e-5)
    _close(st.numpy(), sj, 1e-5)
