"""The port's mix_fir_decim (liquid_dsp_tpu_torch/ops/kernels) on the CPU:
its plain PyTorch version against the JAX Pallas kernel run in interpret
mode on the same inputs, over 3 streaming blocks with carries; the
out_dtype policy; and the wrapper's validation (a CUDA kernel cannot run
here, so only the checks in front of it are tested).

Tolerances: 2e-4 of rms in f32, the reference's own bound for the kernel
(tests/test_pallas_chain.py:49; the two differ by tile size and
summation order only); 3e-2 with bf16 output planes (:106).
"""
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import _torch_port as tp
from liquid_dsp_tpu.ops.kernels import pallas_chain as jpc
import liquid_dsp_tpu_torch as P
from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
from liquid_dsp_tpu_torch.ops import fir, nco, resample
from liquid_dsp_tpu_torch.ops.kernels import build
from liquid_dsp_tpu_torch.ops.kernels import mix_fir_decim as mfd

B = 8


def _headline_lti():
    return P.fuse(P.chain(nco.nco(dphi=0.125, direction="down"),
                          fir.firfilt(firdes_kaiser(64, 0.2, 60.0)),
                          fir.firfilt(firdes_kaiser(57, 0.3, 60.0)),
                          resample.msresamp(0.5, 60.0))).stages[1].lti


def _stream(taps_lti, T, dtype, sgn, dphi, theta0, seed, nblk=3):
    """Run nblk blocks through the JAX kernel (interpret mode) and the
    port's wrapper (CPU: plain version) with the same carries."""
    h = mfd.fold_offset(np.asarray(taps_lti.taps, np.float32), taps_lti.d)
    L, down = len(h), taps_lti.down
    jrc, jrs = jpc.make_ramp(L, dphi)
    band = jpc.make_band(h, down)
    rc, rs = (torch.from_numpy(r) for r in mfd.make_ramp(L, dphi))
    np.testing.assert_array_equal(rc.numpy(), jrc[0, :len(rc)])
    taps = torch.from_numpy(h)
    rng = np.random.default_rng(seed)
    cr = np.zeros((B, mfd.SUB), np.float32)
    ci = np.zeros((B, mfd.SUB), np.float32)
    theta = np.float32(theta0)
    outs_j, outs_t = [], []
    for _ in range(nblk):
        xr = jnp.asarray(rng.standard_normal((B, T)).astype(np.float32))
        xi = jnp.asarray(rng.standard_normal((B, T)).astype(np.float32))
        if dtype == "bf16":
            xr, xi = xr.astype(jnp.bfloat16), xi.astype(jnp.bfloat16)
        yr, yi = jpc.mix_fir_decim(
            xr, xi, jnp.asarray(cr), jnp.asarray(ci), jnp.float32(theta),
            jrc, jrs, band, L=L, down=down, sgn=sgn, dphi=dphi,
            interpret=True)
        outs_j.append(np.asarray(yr) + 1j * np.asarray(yi))
        x32 = (np.array(xr.astype(jnp.float32)),
               np.array(xi.astype(jnp.float32)))
        tr, ti = (torch.from_numpy(v) for v in x32)
        if dtype == "bf16":
            tr, ti = tr.bfloat16(), ti.bfloat16()
        zr, zi = mfd.mix_fir_decim(
            tr, ti, torch.from_numpy(cr), torch.from_numpy(ci),
            torch.tensor(theta), rc, rs, taps, down=down, sgn=sgn, dphi=dphi)
        outs_t.append(zr.numpy() + 1j * zi.numpy())
        cr, ci = x32[0][:, -mfd.SUB:].copy(), x32[1][:, -mfd.SUB:].copy()
        theta = np.float32(math.remainder(float(theta) + dphi * T, 2 * np.pi))
    return np.concatenate(outs_t, -1), np.concatenate(outs_j, -1)


@pytest.mark.parametrize("T,dtype,sgn", [(2048, "f32", -1.0),
                                         (4096, "f32", -1.0),
                                         (2048, "bf16", -1.0),
                                         (4096, "bf16", 1.0)])
def test_plain_matches_pallas_interpret(T, dtype, sgn):
    y, ref = _stream(_headline_lti(), T, dtype, sgn, 0.125, 0.3, seed=T)
    assert y.shape == ref.shape == (B, 3 * T // 2)
    assert tp.rel_err(y, ref) < 2e-4


def test_plain_matches_pallas_interpret_other_taps():
    # L=41, down=4, d=3 (two halfband decimators fused), general dphi
    lti = P.fuse(P.chain(resample.resamp2_decim(4),
                         resample.resamp2_decim(3))).lti
    y, ref = _stream(lti, 2048, "f32", -1.0, 0.7131, -2.5, seed=5)
    assert y.shape == ref.shape == (B, 3 * 2048 // 4)
    assert tp.rel_err(y, ref) < 2e-4


def _kernel_proc(out_dtype=None):
    fused = P.fuse(P.chain(nco.nco(dphi=0.125, direction="down"),
                           fir.firfilt(firdes_kaiser(64, 0.2, 60.0)),
                           fir.firfilt(firdes_kaiser(57, 0.3, 60.0)),
                           resample.msresamp(0.5, 60.0)))
    return P.planar(P.kernel_fuse(fused, out_dtype=out_dtype))


@pytest.mark.parametrize("out_dtype,in_dtype,want", [
    (None, torch.bfloat16, torch.float32),
    ("input", torch.bfloat16, torch.bfloat16),
    ("input", torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.bfloat16)])
def test_out_dtype_policy(out_dtype, in_dtype, want):
    p = _kernel_proc(out_dtype)
    c = p.init(batch_shape=(B,))
    x = torch.randn(B, 2048, generator=torch.Generator().manual_seed(0))
    (yr, yi), c2 = p(c, (x.to(in_dtype), x.to(in_dtype)))
    assert yr.dtype == yi.dtype == want and yr.shape == (B, 1024)
    # the carry stays float32 whatever the planes are
    assert c2["tr"].dtype == c2["theta"].dtype == torch.float32


def test_kernel_fuse_no_match_is_identity():
    p = P.chain(nco.nco(dphi=0.125, direction="down", table=True),
                fir.firfilt(firdes_kaiser(64, 0.2, 60.0)))
    assert P.kernel_fuse(p) is p          # table-mode NCO: no match
    q = fir.firfilt(firdes_kaiser(64, 0.2, 60.0))
    assert P.kernel_fuse(q) is q          # single stage: no match


def _args(B_=B, T=2048, L=144, dtype=torch.float32):
    rc, rs = (torch.from_numpy(r) for r in mfd.make_ramp(L, 0.125))
    return [torch.zeros(B_, T, dtype=dtype), torch.zeros(B_, T, dtype=dtype),
            torch.zeros(B_, mfd.SUB), torch.zeros(B_, mfd.SUB),
            torch.tensor(0.0), rc, rs, torch.ones(L)]


def _call(args, **kw):
    return mfd.mix_fir_decim(*args, down=kw.pop("down", 2), sgn=-1.0,
                             dphi=0.125, **kw)


@pytest.mark.parametrize("bad", ["T", "B", "taps", "carry", "dtype",
                                 "theta", "contiguous", "out_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = _args(T=3000 if bad == "T" else 2048, B_=6 if bad == "B" else B,
                 L=300 if bad == "taps" else 144,
                 dtype=torch.float64 if bad == "dtype" else torch.float32)
    kw = {}
    if bad == "carry":
        args[2] = torch.zeros(B, 100)
    if bad == "theta":
        args[4] = torch.zeros(B)
    if bad == "contiguous":
        args[0] = torch.zeros(2048, B).t()
    if bad == "out_dtype":
        kw["out_dtype"] = torch.float16
    with pytest.raises(ValueError):
        _call(args, **kw)


def test_wrapper_never_falls_back_off_cpu(monkeypatch):
    # a device mismatch raises, and a non-CPU tensor never reaches the
    # plain version (here "meta" stands in for a device with no kernel)
    def plain(*a, **k):
        raise AssertionError("plain version reached")

    args = _args()
    meta = [a.to("meta") for a in args]
    mixed = [args[0].to("meta")] + args[1:]
    monkeypatch.setattr(mfd, "mix_fir_decim_reference", plain)
    for bad in (meta, mixed):
        with pytest.raises(ValueError, match="device"):
            _call(bad)
    launches = mfd.mix_fir_decim.launches
    with pytest.raises(AssertionError, match="plain version reached"):
        _call(args)                       # CPU tensors take the plain path
    assert mfd.mix_fir_decim.launches == launches


def test_wrapper_rejects_planes_off_a_16_byte_boundary():
    # the kernel copies the raw window in 16-byte pieces
    args = _args()
    B, T = args[0].shape
    flat = torch.zeros(B * T + 1)
    args[0] = flat[1:].view(B, T)
    assert args[0].is_contiguous() and args[0].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        _call(args)


def test_tile_step_is_the_wrapped_float32_step():
    for dphi in (0.125, -0.7, 2.0, 1e-4):
        step = mfd.tile_step(dphi)
        assert step == float(np.float32(np.mod(dphi * mfd.TILE, 2 * np.pi)))
        assert 0.0 <= step < 2 * np.pi


def test_build_raises_with_nvcc_output(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build()
    assert not list(tmp_path.iterdir())   # no half-built library is left
    monkeypatch.setattr(build, "CSRC", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA sources"):
        build.build()
