"""Port parity: liquid_dsp_tpu_torch.parallel (a mesh of torch devices in
one process) against the JAX package.

The JAX package's own tests (tests/test_parallel.py, tests/test_fuse.py,
tests/test_runtime.py) prove its sharded runs equal to its single-device
runs on 8 virtual CPU devices; here the port's sharded run, on the CPU
device repeated, is held to the JAX package's single-device output and to
the port on one device, at those tests' tolerances: max |err| 1e-5 for the
FIR cases (the golden 1e-5), 1e-4 for fftfilt and firdecim, 1e-3 for the
mixer chain (its closed-form start phase), 2e-4 of rms for the fused
chain and for the pipeline against the jitted JAX stages, 1e-6 for
carries; the port sharded against the port on one device bit for bit
where each output sample sums the same products in the same order.  The refusals are the JAX package's, plus the one
where it raises AttributeError (kernel_fuse's carry): the port says why.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
from conftest import assert_close
from liquid_dsp_tpu import chain as jchain
from liquid_dsp_tpu.design.firdes import firdes_kaiser as jkaiser
from liquid_dsp_tpu.fuse import fuse as jfuse
from liquid_dsp_tpu.fuse import kernel_fuse as jkernel_fuse
from liquid_dsp_tpu.ops import fftfilt as jfft
from liquid_dsp_tpu.ops import fir as jfir
from liquid_dsp_tpu.ops import nco as jnco
from liquid_dsp_tpu.ops import resample as jres
from liquid_dsp_tpu.parallel.mesh import stream_mesh as jstream_mesh
from liquid_dsp_tpu.parallel.pipeline import StagePipeline as JStagePipeline
from liquid_dsp_tpu.parallel.stream import run_time_sharded as jrun_sharded
from liquid_dsp_tpu_torch import chain, fuse, kernel_fuse
from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
from liquid_dsp_tpu_torch.ops.agc import agc
from liquid_dsp_tpu_torch.ops.fftfilt import fftfilt
from liquid_dsp_tpu_torch.ops.fir import firdecim, firfilt
from liquid_dsp_tpu_torch.ops.nco import nco
from liquid_dsp_tpu_torch.ops.resample import msresamp, resamp2_decim
from liquid_dsp_tpu_torch.parallel import (
    Mesh, StagePipeline, run_time_sharded, stream_jit, stream_mesh,
    time_shard_apply)
from liquid_dsp_tpu_torch.runtime import StreamRunner

CPU = torch.device("cpu")


def _mesh(n_time, n_channel=1):
    return stream_mesh(n_time, n_channel, devices=[CPU] * (n_time * n_channel))


def _jax_single(jproc, x, batch_shape=()):
    y, c = jproc(jnp.asarray(x), batch_shape=batch_shape)
    return np.asarray(y), c


def _torch_single(proc, x, batch_shape=()):
    y, c = proc(proc.init(batch_shape=batch_shape), torch.from_numpy(x))
    return y.numpy(), c


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_firfilt_time_sharded(n_dev):
    rng = np.random.default_rng(11)
    h = rng.standard_normal(17).astype(np.float32)
    x = tp.cnoise(rng, 1024)
    y_ref, c_ref = _jax_single(jfir.firfilt(h), x)
    y, c = run_time_sharded(firfilt(h), _mesh(n_dev), x)
    assert_close(y.numpy(), y_ref, tol=1e-5, msg=f"{n_dev}-shard firfilt")
    assert_close(c.numpy(), np.asarray(c_ref), tol=1e-6, msg="carry")
    y1, c1 = _torch_single(firfilt(h), x)
    # each output sample sums the same products in the same order
    np.testing.assert_array_equal(y.numpy(), y1)
    np.testing.assert_array_equal(c.numpy(), c1.numpy())


def test_firfilt_sharded_golden(golden):
    d = golden("firfilt_crcf_data_h13x32")
    y, _ = run_time_sharded(firfilt(d["h"]), _mesh(2), d["x"])
    assert_close(y.numpy(), d["y"], msg="sharded vs golden")


def test_fftfilt_time_sharded():
    rng = np.random.default_rng(13)
    h = rng.standard_normal(23).astype(np.float32)
    x = tp.cnoise(rng, 2048)
    y_ref, _ = _jax_single(jfft.fftfilt(h), x)
    y, _ = run_time_sharded(fftfilt(h), _mesh(4), x)
    assert_close(y.numpy(), y_ref, tol=1e-4, msg="4-shard fftfilt")


def test_chain_time_sharded():
    # mixer -> FIR -> decimator over 4 shards: the mixer starts each
    # shard from its closed-form phase, the filters take halos
    rng = np.random.default_rng(17)
    h = rng.standard_normal(31).astype(np.float32)
    h2 = rng.standard_normal(15).astype(np.float32)
    x = tp.cnoise(rng, 2048)
    y_ref, c_ref = _jax_single(jchain(
        jnco.nco(dphi=0.1, direction="down"), jfir.firfilt(h),
        jfir.firdecim(2, h2)), x)
    proc = chain(nco(dphi=0.1, direction="down"), firfilt(h),
                 firdecim(2, h2))
    y, c = run_time_sharded(proc, _mesh(4), x)
    assert_close(y.numpy(), y_ref, tol=1e-3, msg="sharded chain")
    assert_close(c[0]["theta"].numpy(), np.asarray(c_ref[0]["theta"]),
                 tol=1e-6, msg="nco carry")
    y1, _ = _torch_single(proc, x)
    assert_close(y.numpy(), y1, tol=1e-3, msg="sharded vs one device")


def test_multiblock_carry_continuity():
    rng = np.random.default_rng(19)
    h = rng.standard_normal(9).astype(np.float32)
    x = tp.cnoise(rng, 1024)
    y_ref, _ = _jax_single(jfir.firfilt(h), x)
    proc, mesh = firfilt(h), _mesh(4)
    carry = proc.init()
    y1, carry = run_time_sharded(proc, mesh, x[:512], carry=carry)
    y2, carry = run_time_sharded(proc, mesh, x[512:], carry=carry)
    assert_close(np.concatenate([y1.numpy(), y2.numpy()]), y_ref,
                 tol=1e-5, msg="block continuity")


def test_channel_and_time_sharded():
    rng = np.random.default_rng(23)
    h = rng.standard_normal(13).astype(np.float32)
    x = tp.cnoise(rng, (2, 1024))
    y_ref, c_ref = _jax_single(jfir.firfilt(h), x, (2,))
    proc = firfilt(h)
    y, c = run_time_sharded(proc, _mesh(4, 2), x, batch_shape=(2,))
    assert_close(y.numpy(), y_ref, tol=1e-5, msg="ch+time sharded")
    assert c.shape == (2, 12)
    assert_close(c.numpy(), np.asarray(c_ref), tol=1e-6, msg="carry")


def test_hierarchical_dcn_ici_mesh():
    # channels over the (dcn, ch) product, time over its own axis
    mesh = Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 2, 2),
                ("dcn", "ch", "t"))
    assert mesh.shape == {"dcn": 2, "ch": 2, "t": 2}
    rng = np.random.default_rng(0)
    x = tp.cnoise(rng, (4, 1024))
    jp = jfir.firfilt(jkaiser(33, 0.2, 60.0))
    y_ref, _ = jp.apply(jp.params, jp.init(batch_shape=(4,)), jnp.asarray(x))
    proc = firfilt(firdes_kaiser(33, 0.2, 60.0))
    fn = time_shard_apply(proc, mesh, channel_axis=("dcn", "ch"))
    y, _ = fn(proc.init(batch_shape=(4,)), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)


def test_firdecim_time_sharded():
    rng = np.random.default_rng(4)
    h = jkaiser(33, 0.1, 60.0)
    x = tp.cnoise(rng, (2, 8 * 64))
    y_ref, _ = _jax_single(jfir.firdecim(4, h), x, (2,))
    q = firdecim(4, firdes_kaiser(33, 0.1, 60.0))
    step = time_shard_apply(q, _mesh(4, 2))
    y, _ = step(q.init(batch_shape=(2,)), torch.from_numpy(x))
    assert_close(y.numpy(), y_ref, tol=1e-4)


def test_fused_rate_and_time_shard_halo():
    # tests/test_fuse.py's case: the fused FIR + halfband decimator keeps
    # halo metadata, so it time-shards
    p = fuse(chain(firfilt(firdes_kaiser(16, 0.2, 60.0)), resamp2_decim(3)))
    assert p.halo == p.lti.taps.shape[-1] - 1
    rng = np.random.default_rng(3)
    x = tp.cnoise(rng, (2, 1024))
    jp = jfuse(jchain(jfir.firfilt(jkaiser(16, 0.2, 60.0)),
                               jres.resamp2_decim(3)))
    y_ref, _ = _jax_single(jp, x, (2,))
    y1, _ = _torch_single(p, x, (2,))
    y4, _ = run_time_sharded(p, _mesh(4), x, batch_shape=(2,))
    rms = np.sqrt(np.mean(np.abs(y_ref) ** 2))
    assert np.abs(y4.numpy() - y_ref).max() / rms < 2e-4
    np.testing.assert_array_equal(y4.numpy(), y1)


def test_stream_jit_with_and_without_a_mesh():
    rng = np.random.default_rng(5)
    h = rng.standard_normal(7).astype(np.float32)
    x = torch.from_numpy(tp.cnoise(rng, 512))
    proc = firfilt(h)
    y0, _ = stream_jit(proc)(proc.init(), x)
    y2, _ = stream_jit(proc, _mesh(2))(proc.init(), x)
    np.testing.assert_array_equal(y0.numpy(), y2.numpy())


def test_carry_does_not_alias_the_input_block():
    # the new carry is the last shard's tail, copied: writing into the
    # caller's block afterwards leaves it as it was
    rng = np.random.default_rng(6)
    h = rng.standard_normal(9).astype(np.float32)
    x = torch.from_numpy(tp.cnoise(rng, 1024))
    proc = firfilt(h)
    _, c = time_shard_apply(proc, _mesh(4))(proc.init(), x)
    want = x[..., -8:].clone()
    x.zero_()
    np.testing.assert_array_equal(c.numpy(), want.numpy())


class TestStagePipeline:
    """examples/stage_pipeline_example.py's stages, against the JAX
    StagePipeline and the port's chain on one device."""

    def test_example_stages_against_jax(self):
        rng = np.random.default_rng(20)
        blocks = tp.cnoise(rng, (8, 1024))
        jstages = [jnco.nco(dphi=0.31, direction="down"),
                   jfir.firfilt(jkaiser(48, 0.2, 60.0)),
                   jres.resamp2_decim(7)]
        y_jax = JStagePipeline(jstages, devices=jax.devices()[:3]).run(blocks)

        def stages():
            return [nco(dphi=0.31, direction="down"),
                    firfilt(firdes_kaiser(48, 0.2, 60.0)), resamp2_decim(7)]
        pipe = StagePipeline(stages(), devices=[CPU] * 3)
        y = pipe.run(blocks)
        assert y.shape == y_jax.shape == (8, 512)
        # the JAX stages are jitted, and XLA takes the NCO's carried phase
        # theta + T * dphi as one FMA: from block 1 the phases differ by
        # an ulp at 317 rad (3e-5 rad), 5.4e-5 of rms measured
        assert tp.rel_err(y, y_jax) < 2e-4
        mono = chain(*stages())
        c, ref = mono.init(), []
        for b in blocks:
            yb, c = mono(c, torch.from_numpy(b))
            ref.append(yb.numpy())
        np.testing.assert_array_equal(y, np.stack(ref))

    def test_rate_changing_stage_and_reset(self):
        rng = np.random.default_rng(22)
        h1 = rng.standard_normal(17).astype(np.float32)
        h2 = rng.standard_normal(12).astype(np.float32)
        x = tp.cnoise(rng, (3, 512))
        pipe = StagePipeline([firfilt(h1), firdecim(4, h2)],
                             devices=["cpu", "cpu"])
        y1 = pipe.run(x)
        assert y1.shape == (3, 128)
        pipe.reset()
        np.testing.assert_array_equal(pipe.run(x), y1)
        ch = jchain(jfir.firfilt(h1), jfir.firdecim(4, h2))
        c, ref = ch.init(), []
        for b in x:
            yb, c = ch.apply(ch.params, c, jnp.asarray(b))
            ref.append(np.asarray(yb))
        assert_close(y1, np.stack(ref), tol=1e-5, msg="pipelined decim")


def test_stream_runner_on_a_mesh(tmp_path):
    # tests/test_runtime.py's sharded mode, then a checkpoint resume
    def proc():
        return chain(nco(dphi=0.1, direction="down"),
                     firfilt(firdes_kaiser(32, 0.2, 60.0)))
    rng = np.random.default_rng(3)
    x = tp.cnoise(rng, (1, 1024))
    jp = jchain(jnco.nco(dphi=0.1, direction="down"),
                jfir.firfilt(jkaiser(32, 0.2, 60.0)))
    y_ref, _ = _jax_single(jp, x, (1,))
    mesh = _mesh(2)
    runner = StreamRunner(proc(), batch_shape=(1,), mesh=mesh)
    y = runner(x).numpy()
    np.testing.assert_allclose(y, y_ref, atol=1e-4, rtol=1e-3)
    runner.save(tmp_path / "s.npz")
    y2 = runner(x).numpy()
    again = StreamRunner(proc(), batch_shape=(1,), mesh=mesh)
    again.load(tmp_path / "s.npz")
    assert again.blocks_processed == 1
    np.testing.assert_array_equal(again(x).numpy(), y2)


def test_refusals():
    h = np.ones(9, np.float32)
    x = np.zeros(64, np.complex64)
    with pytest.raises(ValueError, match="mesh 2x4 != 6 devices"):
        stream_mesh(4, 2, devices=[CPU] * 6)
    with pytest.raises(ValueError, match=r"\['dcn'\] not in mesh"):
        time_shard_apply(firfilt(h), _mesh(2), channel_axis=("dcn", "ch"))
    with pytest.raises(ValueError, match="halo 8 exceeds local block 4"):
        run_time_sharded(firfilt(h), _mesh(8), x[:32])
    with pytest.raises(ValueError, match="neither halo nor advance"):
        run_time_sharded(agc(), _mesh(2), x)


def _headline(mod):
    ops, design = (mod["ops"], mod["design"])
    return mod["chain"](ops["nco"](dphi=0.125, direction="down"),
                        ops["firfilt"](design(64, 0.2, 60.0)),
                        ops["firfilt"](design(57, 0.3, 60.0)),
                        ops["msresamp"](0.5, 60.0))


def test_kernel_fuse_proc_refused_in_both_packages():
    # the reference's fault: kernel_fuse's Proc declares halo=L-1 over a
    # {tr, ti, theta} carry (liquid_dsp_tpu/fuse.py:208); the JAX package
    # fails inside its exchange, the port refuses and says why
    x = tp.cnoise(np.random.default_rng(8), (8, 8192))
    jk = jkernel_fuse(jfuse(_headline(
        {"chain": jchain, "design": jkaiser,
         "ops": {"nco": jnco.nco, "firfilt": jfir.firfilt,
                 "msresamp": jres.msresamp}})))
    with pytest.raises(AttributeError, match="'dict' object has no "
                                             "attribute 'astype'"):
        jrun_sharded(jk, jstream_mesh(n_time=2, devices=jax.devices()[:2]),
                     jnp.asarray(x), batch_shape=(8,))
    k = kernel_fuse(fuse(_headline(
        {"chain": chain, "design": firdes_kaiser,
         "ops": {"nco": nco, "firfilt": firfilt, "msresamp": msresamp}})))
    assert type(k).__name__ == "MixFIRDecim" and k.halo == 143
    with pytest.raises(ValueError, match=r"MixFIRDecim.*kernel_fuse|"
                                         r"fuse\.py:208.*MixFIRDecim"):
        run_time_sharded(k, _mesh(2), x, batch_shape=(8,))
    # the same chain time-sharded before kernel_fuse runs
    f = fuse(_headline({"chain": chain, "design": firdes_kaiser,
                        "ops": {"nco": nco, "firfilt": firfilt,
                                "msresamp": msresamp}}))
    y, _ = run_time_sharded(f, _mesh(2), x[:, :4096], batch_shape=(8,))
    assert y.shape == (8, 2048)


def test_no_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        stream_mesh()
    with pytest.raises(RuntimeError, match="CUDA card"):
        StagePipeline([firfilt(np.ones(3, np.float32))])
    with pytest.raises(RuntimeError, match="CUDA card"):
        StreamRunner(firfilt(np.ones(3, np.float32)))
