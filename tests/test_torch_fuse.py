"""Port parity for LTI chain fusion (liquid_dsp_tpu_torch.fuse).

The fused taps, down and d must equal the JAX package's exactly (the
composition is the same numpy float64 code and only the final taps are
narrowed).  Fused equals unfused within 2e-4 of rms, the reference's
own bound (tests/test_fuse.py: one long f32 dot product vs a cascade)."""
import numpy as np
import pytest

import _torch_port as tp
import liquid_dsp_tpu as J
import liquid_dsp_tpu_torch as P
from liquid_dsp_tpu.design.firdes import firdes_kaiser
from liquid_dsp_tpu.ops import fftfilt as jfftfilt
from liquid_dsp_tpu.ops import fir as jfir
from liquid_dsp_tpu.ops import nco as jnco
from liquid_dsp_tpu.ops import resample as jresample
from liquid_dsp_tpu_torch.convert import load_jax_params
from liquid_dsp_tpu_torch.ops import fftfilt, fir, nco, resample


def _headline(m, c):
    return c.chain(m["nco"].nco(dphi=0.125, direction="down"),
                   m["fir"].firfilt(firdes_kaiser(64, 0.2, 60.0)),
                   m["fir"].firfilt(firdes_kaiser(57, 0.3, 60.0)),
                   m["resample"].msresamp(0.5, 60.0))


def _fir_cascade(m, c):
    return c.chain(m["fir"].firfilt(firdes_kaiser(21, 0.2, 60.0)),
                   m["fir"].firfilt(firdes_kaiser(33, 0.3, 60.0)))


def _fftfilt_fir(m, c):
    return c.chain(m["fftfilt"].fftfilt(firdes_kaiser(57, 0.3, 60.0)),
                   m["fir"].firfilt(firdes_kaiser(20, 0.25, 60.0)))


def _halfbands(m, c):
    return c.chain(m["resample"].resamp2_decim(4),
                   m["resample"].resamp2_decim(3))


def _multirate_front(m, c):
    # the multi-rate receive path's front end: 64 + 48 - 1 taps at down 4
    return c.chain(m["nco"].nco(dphi=0.125, direction="down"),
                   m["fir"].firfilt(firdes_kaiser(64, 0.2, 60.0)),
                   m["fir"].firdecim(4, firdes_kaiser(48, 0.1, 60.0)))


def _decim_cascade(m, c):
    return c.chain(m["fir"].firdecim(2, firdes_kaiser(21, 0.2, 60.0)),
                   m["fir"].firdecim(2, firdes_kaiser(17, 0.2, 60.0)))


JAX = {"nco": jnco, "fir": jfir, "fftfilt": jfftfilt, "resample": jresample}
PORT = {"nco": nco, "fir": fir, "fftfilt": fftfilt, "resample": resample}
# case: (chain builder, fused down, fused d, fused tap count)
CASES = {"headline": (_headline, 2, 1, 144),
         "fir_cascade": (_fir_cascade, 1, 0, 21 + 33 - 1),
         "fftfilt_fir": (_fftfilt_fir, 1, 0, 57 + 20 - 1),
         "halfbands": (_halfbands, 4, 3, 17 + 25 - 1),  # 13 taps, up 2
         "multirate_front": (_multirate_front, 4, 0, 64 + 48 - 1),
         "decim_cascade": (_decim_cascade, 4, 0, 21 + 2 * 16)}


def _fused_stage(p):
    return p.stages[-1] if isinstance(p, P.Chain) else p


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_taps_equal_reference(case):
    make, down, d, L = CASES[case]
    jf = J.fuse(make(JAX, J))
    pf = P.fuse(make(PORT, P))
    jl = (jf.children[-1] if jf.children else jf).lti
    pl = _fused_stage(pf).lti
    assert (pl.down, pl.d) == (jl.down, jl.d) == (down, d)
    assert pl.taps.dtype == jl.taps.dtype
    np.testing.assert_array_equal(pl.taps, jl.taps)
    assert pl.taps.shape == (L,)
    np.testing.assert_array_equal(_fused_stage(pf).h.numpy(), jl.taps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_equals_unfused(case):
    make = CASES[case][0]
    rng = np.random.default_rng(7)
    blocks = [tp.cnoise(rng, (2, 1024)) for _ in range(3)]
    p = make(PORT, P)
    y_ref, _ = tp.run_torch(p, blocks, (2,))
    y_fused, _ = tp.run_torch(P.fuse(p), blocks, (2,))
    assert tp.rel_err(y_fused, y_ref) < 2e-4


@pytest.mark.parametrize("planar", [False, True])
def test_fused_chain_matches_jax(planar):
    # same fused chain in both packages, params handed across
    rng = np.random.default_rng(8)
    blocks = [tp.cnoise(rng, (2, 1024)) for _ in range(3)]
    jf, pf = J.fuse(_headline(JAX, J)), P.fuse(_headline(PORT, P))
    if planar:
        jf, pf = J.planar(jf), P.planar(pf)
    load_jax_params(pf, tp.jax_params(jf))
    yj, _ = tp.run_jax(jf, blocks, (2,), planar=planar)
    yt, _ = tp.run_torch(pf, blocks, (2,), planar=planar)
    assert tp.rel_err(yt, yj) < 1e-5


def test_fuse_leaves_non_lti_alone():
    p = nco.nco(dphi=0.3, direction="up")
    assert P.fuse(p) is p
    f = fir.firfilt(firdes_kaiser(21, 0.2, 60.0))
    q = P.chain(nco.nco(dphi=0.125), f)
    assert P.fuse(q).stages[1] is f
