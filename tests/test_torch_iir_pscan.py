"""Port parity for `iirfilt_sos(backend="pscan")` and `iir_apply_sos_pscan`
(`ops/iir.py`, on `ops/kernels/iir_pscan.py`'s plain version on the CPU)
against the JAX package's associative scan and its scan.

Tolerance: 1e-4 of max|ref| (`test_torch_iir.py`'s `_close_rel`), y and
carry.  Both packages evaluate the cascade parallel in time in float32, in
different orders (the port by chunks of 16 or 8 samples and a scan over
the chunks, the JAX package by lax.associative_scan), so neither is the
other's bits; against float64 scipy the JAX package's pscan reads 1.2e-7
(butter 3) to 2.0e-5 (cheby1 8 at 0.05) of max|ref| at T = 1024, the
port's alike.  The plain version at other chunks and tiles is held to
float64 scipy at the same 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import sosfilt

import _torch_port as tp
from liquid_dsp_tpu.design.iirdes import iirdes_sos
from liquid_dsp_tpu.ops import iir as J
from liquid_dsp_tpu_torch.convert import carry_from_numpy, load_jax_params
from liquid_dsp_tpu_torch.ops import iir as P
from liquid_dsp_tpu_torch.ops.kernels.iir_pscan import (iir_pscan,
                                                        iir_pscan_reference)

RTOL = 1e-4


def _close_rel(y, ref, what=""):
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape and np.isfinite(y).all(), what
    err = float(np.abs(y - ref).max() / np.abs(ref).max())
    assert err <= RTOL, f"{what}: max|err| / max|ref| {err:.3e} > {RTOL:.0e}"


def _run_jax(B, A, backend, blocks, carry):
    """A JAX iirfilt_sos Proc over blocks from `carry`, jitted (the JAX
    package's associative scan runs eagerly four times slower; blocks of
    one length compile once)."""
    q = J.iirfilt_sos(B, A, backend=backend)
    ys = []
    for xb in blocks:
        y, carry = q.jitted(q.params, carry, jnp.asarray(xb))
        ys.append(np.asarray(y))
    return np.concatenate(ys, axis=-1), np.asarray(carry)


def _vs_jax(B, A, blocks, batch, backends=("pscan", "scan")):
    """The port's pscan Proc over blocks against the JAX package's Procs
    under `backends`, y and carry."""
    q = P.iirfilt_sos(B, A, backend="pscan")
    assert q.backend == "pscan"
    dt = blocks[0].dtype        # complex64 or float32, the carry's too
    yt, ct = tp.run_torch(q, blocks, batch, carry=q.init(
        batch, dtype=torch.from_numpy(np.zeros(0, dt)).dtype))
    for be in backends:
        yj, cj = _run_jax(B, A, be, blocks,
                          jnp.zeros(batch + (B.shape[0], 2), dt))
        _close_rel(yt, yj, f"y vs the JAX {be}")
        _close_rel(ct.numpy(), cj, f"carry vs the JAX {be}")
    return yt, ct


@pytest.mark.parametrize("backend", ["pscan", "scan"])
@pytest.mark.parametrize("order", [3, 5, 7])
def test_pscan_matches_jax(order, backend):
    # tests/test_agc_eq_iir.py::TestPScan's case: butter at 0.2, complex
    # (2, 256), against the JAX package's pscan and its scan
    B, A = iirdes_sos("butter", order, 0.2)
    x = tp.cnoise(np.random.default_rng(order), (2, 256))
    _vs_jax(B, A, [x], (2,), backends=(backend,))


@pytest.mark.parametrize("blocks", [1, 4])
def test_pscan_streaming_matches_jax(blocks):
    # TestPScan's streaming case: ellip 5 at 0.15, 512 real samples in one
    # call and in 4 carried blocks; the port against the JAX package's
    # pscan in one call
    B, A = iirdes_sos("ellip", 5, 0.15)
    x = np.random.default_rng(9).standard_normal(512).astype(np.float32)
    q = P.iirfilt_sos(B, A, backend="pscan")
    c = q.init(dtype=torch.float32)
    ys = []
    for blk in x.reshape(blocks, -1):
        y, c = q(c, torch.from_numpy(blk.copy()))
        ys.append(y.numpy())
    yj, cj = _run_jax(B, A, "pscan", [x], jnp.zeros((B.shape[0], 2)))
    _close_rel(np.concatenate(ys), yj, "y")
    _close_rel(c.numpy(), cj, "carry")


@pytest.mark.parametrize("design", [("cheby1", 8, 0.05), ("butter", 16, 0.2),
                                    ("ellip", 6, 0.3)])
def test_pscan_high_order_matches_jax(design):
    # cheby1 8 at 0.05 (poles near the unit circle: the JAX pscan reads
    # 2.0e-5 against float64) and butter 16 (8 sections), 3 carried blocks
    # of 1024 samples in all
    B, A = iirdes_sos(*design)
    x = tp.cnoise(np.random.default_rng(design[1]), (2, 1023))
    _vs_jax(B, A, np.split(x, 3, axis=1), (2,))


def test_pscan_planar_route_matches_jax():
    # real coefficients on a complex stream's two float planes (the planar
    # route, `forward_planar`: each plane its own call) against the JAX
    # package on the complex stream, and bit-equal to the port's complex
    # route (the same rows, the same arithmetic)
    B, A = iirdes_sos("butter", 5, 0.1)
    x = tp.cnoise(np.random.default_rng(5), (3, 600))
    q = P.iirfilt_sos(B, A, backend="pscan")
    yc, cc = tp.run_torch(q, np.split(x, 2, axis=1), (3,))
    carry, ys = q.init_planar(batch_shape=(3,)), []
    for xb in np.split(x, 2, axis=1):
        (yr, yi), carry = q.forward_planar(carry, (
            torch.from_numpy(xb.real.copy()), torch.from_numpy(xb.imag.copy())))
        ys.append(yr.numpy() + 1j * yi.numpy())
    yp = np.concatenate(ys, axis=-1)
    assert np.array_equal(yp, yc)
    assert torch.equal(carry[0], cc.real) and torch.equal(carry[1], cc.imag)
    yj, cj = _run_jax(B, A, "pscan", np.split(x, 2, axis=1),
                      jnp.zeros((3, B.shape[0], 2), jnp.complex64))
    _close_rel(yp, yj, "y")
    _close_rel(cc.numpy(), cj, "carry")


def test_pscan_real_input_matches_jax():
    B, A = iirdes_sos("cheby2", 4, 0.25)
    x = np.random.default_rng(4).standard_normal((2, 700)).astype(np.float32)
    yt, _ = _vs_jax(B, A, np.split(x, 2, axis=1), (2,))
    assert yt.dtype == np.float32


def _shifted_butter(order=5, fc=0.1, w=0.6):
    """A complex-coefficient cascade: butter at fc, shifted by w rad/sample
    (section k's B and A times e^{j w [0, 1, 2]})."""
    B, A = iirdes_sos("butter", order, fc)
    rot = np.exp(1j * w * np.arange(3))
    return ((B * rot).astype(np.complex64), (A * rot).astype(np.complex64))


def test_pscan_complex_coefficients_match_jax():
    # complex coefficients on complex64 rows through the public function
    # (both packages' iirfilt_sos take real coefficients), against the JAX
    # package's pscan and its scan, two carried blocks
    B, A = _shifted_butter()
    x = tp.cnoise(np.random.default_rng(12), (2, 800))
    jfn = {"pscan": jax.jit(J.iir_apply_sos_pscan),
           "scan": jax.jit(J.iir_apply_sos)}
    ct = torch.zeros(2, B.shape[0], 2, dtype=torch.complex64)
    cj = {be: jnp.zeros((2, B.shape[0], 2), jnp.complex64) for be in jfn}
    yt, yj = [], {be: [] for be in jfn}
    for xb in np.split(x, 2, axis=1):
        y, ct = P.iir_apply_sos_pscan(torch.from_numpy(B),
                                      torch.from_numpy(A), ct,
                                      torch.from_numpy(xb))
        yt.append(y.numpy())
        for be, fn in jfn.items():
            y, cj[be] = fn(jnp.asarray(B), jnp.asarray(A), cj[be],
                           jnp.asarray(xb))
            yj[be].append(np.asarray(y))
    for be in jfn:
        _close_rel(np.concatenate(yt, -1), np.concatenate(yj[be], -1),
                   f"y vs the JAX {be}")
        _close_rel(ct.numpy(), np.asarray(cj[be]), f"carry vs the JAX {be}")


def test_unstable_cascade_keeps_pscan():
    # a pole at 1.0005 (unstable): the JAX package keeps pscan (only
    # 'block' falls back to the scan), and so does the port; both agree
    # over 256 samples, and with the scans
    B = np.array([[1.0, 0.5, 0.2], [0.3, 0.0, 0.0]])
    A = np.array([[1.0, -1.0005, 0.0], [1.0, -0.5, 0.1]])
    assert np.abs(np.roots(A[0])).max() > 1
    assert P.iirfilt_sos(B, A, backend="block").backend == "scan"
    assert P.iirfilt_sos(B, A, backend="pscan").backend == "pscan"
    x = tp.cnoise(np.random.default_rng(3), (2, 256))
    _vs_jax(B, A, np.split(x, 2, axis=1), (2,))


def test_load_jax_params_from_a_pscan_proc():
    # a JAX pscan Proc's params (B and A alone) load into the port's pscan
    # Proc unchanged, and the carry moves across
    B, A = iirdes_sos("ellip", 4, 0.2)
    jq = J.iirfilt_sos(B, A, backend="pscan")
    assert set(tp.jax_params(jq)) == {"B", "A"}
    q = P.iirfilt_sos(*iirdes_sos("butter", 4, 0.3), backend="pscan")
    assert set(q.param_spec) == {"B", "A"}
    load_jax_params(q, tp.jax_params(jq))
    x = tp.cnoise(np.random.default_rng(2), (2, 400))
    jc = jq.init(batch_shape=(2,))
    _, jc = jq.jitted(jq.params, jc, jnp.asarray(x[:, :200]))
    yj, cj = jq.jitted(jq.params, jc, jnp.asarray(x[:, 200:]))
    yt, ct = q(carry_from_numpy(tp.to_numpy(jc)),
               torch.from_numpy(x[:, 200:]))
    _close_rel(yt.numpy(), np.asarray(yj), "y")
    _close_rel(ct.numpy(), np.asarray(cj), "carry")


def test_iir_apply_sos_pscan_matches_jax():
    # the public function, carry [..., ns, 2] in the scan's convention,
    # batch shape (2, 3)
    B, A = iirdes_sos("butter", 6, 0.15)
    rng = np.random.default_rng(6)
    x = tp.cnoise(rng, (2, 3, 300))
    c = tp.cnoise(rng, (2, 3, B.shape[0], 2)) * np.float32(0.1)
    yj, cj = jax.jit(J.iir_apply_sos_pscan)(
        jnp.asarray(B), jnp.asarray(A), jnp.asarray(c), jnp.asarray(x))
    yt, ct = P.iir_apply_sos_pscan(torch.from_numpy(B.astype(np.float32)),
                                   torch.from_numpy(A.astype(np.float32)),
                                   torch.from_numpy(c), torch.from_numpy(x))
    assert yt.shape == (2, 3, 300) and ct.shape == (2, 3, B.shape[0], 2)
    _close_rel(yt.numpy(), np.asarray(yj), "y")
    _close_rel(ct.numpy(), np.asarray(cj), "carry")


def _scipy_case(cplx, seed):
    B, A = _shifted_butter(4, 0.15, 0.4) if cplx else iirdes_sos(
        "ellip", 5, 0.2)
    rng = np.random.default_rng(seed)
    x = tp.cnoise(rng, (3, 333)) if cplx else rng.standard_normal(
        (3, 333)).astype(np.float32)
    s = (tp.cnoise(rng, (3, B.shape[0], 2)) if cplx
         else rng.standard_normal((3, B.shape[0], 2)).astype(np.float32))
    dt = np.complex64 if cplx else np.float32
    return x, B.astype(dt), A.astype(dt), (0.1 * s).astype(dt)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("chunk,threads", [(1, 1), (1, 64), (2, 8), (4, 4),
                                           (16, 2), (32, 16), (None, 1024),
                                           (2, 32), (4, 64), (1, 128),
                                           (1, 1024), (1, 512), (1, 256)])
def test_plain_version_at_chunks_and_tiles_vs_float64(chunk, threads, cplx):
    # 333 samples: many tiles at small ones, a ragged last tile, a tile
    # longer than the row at the kernel's own; at the two-level combine's
    # edges: one warp of 32 chunks (tiles of 64, 5 and a ragged sixth), two
    # warps (tiles of 256), four, 32, 16 and the kernel's 8 with a single
    # ragged tile of one-sample chunks; from a random carry, y and the
    # carry against float64 scipy (sosfilt's zi is the same DF2T state)
    x, B, A, s = _scipy_case(cplx, 17)
    y, st = iir_pscan_reference(*(torch.from_numpy(v) for v in (x, B, A, s)),
                                chunk=chunk, threads=threads)
    sos = np.concatenate([B, A], 1).astype(np.complex128 if cplx
                                           else np.float64)
    ref, zf = sosfilt(sos, x.astype(sos.dtype), axis=-1,
                      zi=np.moveaxis(s.astype(sos.dtype), 0, 1))
    _close_rel(y.numpy(), ref, "y")
    _close_rel(st.numpy(), np.moveaxis(zf, 1, 0), "carry")


def test_wrapper_runs_the_plain_version_on_the_cpu():
    # a CPU tensor takes the plain version at the kernel's chunk and
    # threads, bit for bit, and launches nothing; another device raises
    x, B, A, s = _scipy_case(False, 3)
    args = [torch.from_numpy(v) for v in (x, B, A, s)]
    n0 = iir_pscan.launches
    y, st = iir_pscan(*args)
    yr, sr = iir_pscan_reference(*args)
    assert iir_pscan.launches == n0
    assert torch.equal(y, yr) and torch.equal(st, sr)
    with pytest.raises(ValueError, match="CUDA"):
        iir_pscan(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="power of two"):
        iir_pscan_reference(*args, chunk=3)
    with pytest.raises(ValueError, match="b, a"):
        iir_pscan(args[0], args[1][:, :2], args[2][:, :2], args[3])
