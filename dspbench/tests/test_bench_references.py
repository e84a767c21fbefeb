"""The plain references against the definitions they stand for: the
float64 down-converter against the port's unfused chain and its fused
kernel's plain version, on the CPU at small sizes; and the TF32
rounding of the control's reference."""
import torch

from dspbench.reference.ddc import DDCReference, round_tf32

CFG = {"nco": {"dphi": 0.125, "direction": "down"},
       "fir": [{"n": 64, "fc": 0.2, "as_db": 60.0},
               {"n": 57, "fc": 0.3, "as_db": 60.0}],
       "msresamp": {"rate": 0.5, "as_db": 60.0}}


def _chain():
    from liquid_dsp_tpu_torch import chain
    from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
    from liquid_dsp_tpu_torch.ops.fir import firfilt
    from liquid_dsp_tpu_torch.ops.nco import nco
    from liquid_dsp_tpu_torch.ops.resample import msresamp
    return chain(nco(dphi=0.125, direction="down"),
                 firfilt(firdes_kaiser(64, 0.2, 60.0)),
                 firfilt(firdes_kaiser(57, 0.3, 60.0)), msresamp(0.5, 60.0))


def test_ddc_reference_is_the_chain():
    from liquid_dsp_tpu_torch import fuse, kernel_fuse, planar
    ref = DDCReference(CFG)
    assert (ref.halo, ref.down) == (143, 2)
    B, T, H = 8, 4096, 256
    x = torch.randn(3, 2, B, T, generator=torch.Generator().manual_seed(1))
    for proc, tol in ((planar(_chain()), 3e-5),
                      (planar(kernel_fuse(fuse(_chain()))), 3e-6)):
        c = proc.init(batch_shape=(B,))
        for k in range(3):
            y, c = proc(c, (x[k, 0], x[k, 1]))
            prev = x[k - 1, ..., -H:] if k else torch.zeros(2, B, H)
            xin = torch.cat([prev, x[k]], -1).double()
            rr, ri = ref(xin[0], xin[1], k * T, T)
            err = ((y[0].double() - rr) ** 2 + (y[1].double() - ri) ** 2)
            rel = float(torch.sqrt(err.mean() / (rr ** 2 + ri ** 2).mean()))
            assert rel < tol, (type(proc).__name__, k, rel)



def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12), 3.0e-3, -7.5e5])
    y = round_tf32(x)
    # 10 mantissa bits kept, the rest rounded to nearest
    assert y.tolist()[:4] == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10,
                              -1.0]
    bits = y.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert float((y - x).abs().div(x.abs()).max()) <= 2.0 ** -11


def test_tf32_reference_departs_from_float64():
    """The control's reference reads about TF32's rounding against the
    float64 one, far above float32's."""
    ref, ref32 = DDCReference(CFG), DDCReference(CFG, tf32=True)
    B, T, H = 8, 4096, 256
    x = torch.randn(2, B, H + T, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    rr, ri = ref(x[0], x[1], 4 * T, T)
    yr, yi = ref32(x[0].float(), x[1].float(), 4 * T, T, dtype=torch.float32)
    e = float(torch.sqrt(((yr.double() - rr) ** 2 + (yi.double() - ri) ** 2)
                         .mean() / (rr ** 2 + ri ** 2).mean()))
    assert 1e-4 < e < 2e-3
