"""Sample IO, checkpoints and the streaming runtime of the PyTorch port
against the JAX package.

Tolerances: `io` is bit-equal to the JAX package's numpy paths (the
port's only paths; the JAX module is run with its native helper switched
off) in every format, at the rails, past them and on exact .5 ties.  The
JAX package's native C helper multiplies by 1/scale where the numpy path
divides: the planes it reads agree within 1 ulp, the raw samples it
writes are equal.  `StreamRunner` is bit-equal to calling its proc with
the same carries; against the JAX runner on tests/test_runtime.py's chain
(nco, then a 32-tap FIR) within 1e-4 of rms, that test's own tolerance
(both form the mixer's phase t*dphi in float32, up to 205 rad in a
2048-sample block, where an ulp is 1.5e-5 rad); a stream resumed in the
other package from a checkpoint within 1e-5 (absolute and relative), as
that test's resume (512-sample blocks).
"""
import numpy as np
import pytest
import torch

import _torch_port as tp
import jax.numpy as jnp
from liquid_dsp_tpu import chain as jchain
from liquid_dsp_tpu import io as jio
from liquid_dsp_tpu.design.firdes import firdes_kaiser as jkaiser
from liquid_dsp_tpu.ops.fir import firfilt as jfirfilt
from liquid_dsp_tpu.ops.nco import nco as jnco
from liquid_dsp_tpu.runtime import StreamRunner as JStreamRunner
from liquid_dsp_tpu.utils import checkpoint as jck
from liquid_dsp_tpu_torch import chain, io
from liquid_dsp_tpu_torch.design.firdes import firdes_kaiser
from liquid_dsp_tpu_torch.ops.fir import firfilt
from liquid_dsp_tpu_torch.ops.nco import nco
from liquid_dsp_tpu_torch.runtime import StreamRunner
from liquid_dsp_tpu_torch.utils import checkpoint as ck

SCALE = {"cu8": 127.5, "cs8": 127.0, "cs16": 32767.0, "cf32": 1.0}


@pytest.fixture
def jio_numpy(monkeypatch):
    """The JAX package's io on its numpy paths."""
    monkeypatch.setattr(jio._native, "lib", None)
    return jio


def _edge_values(fmt):
    """float32 values at and past the rails, zero, tiny, and values whose
    scaled product (plus 127.5 for cu8) lands exactly on .5."""
    s = np.float32(SCALE[fmt])
    off = np.float32(127.5 if fmt == "cu8" else 0.0)
    v = [0.0, -0.0, 1.0, -1.0, 1.0000001, -1.0000001, 1.5, -3.0, 1e-30,
         -1e-30, 0.999, -0.999]
    ties = []
    for k in range(-300, 300):
        c = np.float32((k + 0.5 - off) / s)
        for d in (np.nextafter(c, np.float32(-1)), c,
                  np.nextafter(c, np.float32(1))):
            y = np.float32(np.float32(d * s) + off)
            if y - np.floor(y) == 0.5:
                ties.append(d)
    assert fmt == "cf32" or len(ties) > 20
    return np.array(v + ties, np.float32)


@pytest.mark.parametrize("fmt", io.IQ_FORMATS)
def test_formats_bit_equal(jio_numpy, fmt):
    rng = np.random.default_rng(1)
    re = np.concatenate([_edge_values(fmt),
                         rng.uniform(-1.3, 1.3, 3000).astype(np.float32)])
    im = rng.permutation(re)
    raw = io.planes_to_iq(re, im, fmt)
    np.testing.assert_array_equal(raw, jio_numpy.planes_to_iq(re, im, fmt))
    assert raw.dtype == jio.planes_to_iq(re, im, fmt).dtype
    x = (re + 1j * im).astype(np.complex64)
    np.testing.assert_array_equal(io.complex_to_iq(x, fmt),
                                  jio_numpy.complex_to_iq(x, fmt))
    # every raw value, and the bytes form
    if fmt == "cf32":
        raw_all = raw
    else:
        info = np.iinfo(raw.dtype)
        raw_all = np.arange(info.min, info.max + 1).astype(raw.dtype)
    for data in (raw_all, raw_all.tobytes()):
        got = io.iq_to_planes(data, fmt)
        want = jio_numpy.iq_to_planes(data, fmt)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(io.iq_to_complex(data, fmt),
                                      jio_numpy.iq_to_complex(data, fmt))
    # beside the JAX package's native path: planes within 1 ulp, raw equal
    np.testing.assert_array_equal(raw, jio.planes_to_iq(re, im, fmt))
    for g, w in zip(io.iq_to_planes(raw_all, fmt),
                    jio.iq_to_planes(raw_all, fmt)):
        assert np.all(np.abs(g - w) <= np.spacing(np.abs(w)))


@pytest.mark.parametrize("fmt", io.IQ_FORMATS)
def test_files_and_stream_bit_equal(jio_numpy, tmp_path, fmt):
    rng = np.random.default_rng(2)
    x = (rng.uniform(-1.1, 1.1, 10_000) +
         1j * rng.uniform(-1.1, 1.1, 10_000)).astype(np.complex64)
    f, jf = tmp_path / f"p.{fmt}", tmp_path / f"j.{fmt}"
    io.write_iq(f, x, fmt)
    jio_numpy.write_iq(jf, x, fmt)
    assert f.read_bytes() == jf.read_bytes()
    np.testing.assert_array_equal(io.read_iq(f, fmt),
                                  jio_numpy.read_iq(f, fmt))
    np.testing.assert_array_equal(io.read_iq(f, fmt, count=100, offset=50),
                                  jio_numpy.read_iq(f, fmt, count=100,
                                                    offset=50))
    for pad_last in (True, False):
        got = list(io.iq_stream(f, fmt, block=4096, pad_last=pad_last))
        want = list(jio_numpy.iq_stream(f, fmt, block=4096,
                                        pad_last=pad_last))
        assert len(got) == len(want) == (3 if pad_last else 2)
        for g, w in zip(got, want):
            assert g.shape == (4096,) and g.dtype == np.complex64
            np.testing.assert_array_equal(g, w)
    # the last block zero-padded past the capture's 10,000 samples
    last = list(io.iq_stream(f, fmt, block=4096))[-1]
    assert not last[10_000 - 8192:].any() and last[:10_000 - 8192].any()


def test_format_errors():
    with pytest.raises(ValueError, match="even sample count"):
        io.iq_to_planes(b"\x00\x01\x02", "cu8")
    with pytest.raises(ValueError, match="unknown IQ format"):
        io.iq_to_planes(b"\x00\x01", "cu9")
    with pytest.raises(ValueError, match="unknown IQ format"):
        io.planes_to_iq(np.zeros(2), np.zeros(2), "cs12")
    with pytest.raises(ValueError, match="shapes differ"):
        io.planes_to_iq(np.zeros(2), np.zeros(3), "cs16")


# --- StreamRunner ------------------------------------------------------------

def _proc():
    return chain(nco(dphi=0.1, direction="down"),
                 firfilt(firdes_kaiser(32, 0.2, 60.0)))


def _jproc():
    return jchain(jnco(dphi=0.1, direction="down"),
                  jfirfilt(jkaiser(32, 0.2, 60.0)))


def _signal(n, seed, shape=()):
    return tp.cnoise(np.random.default_rng(seed), shape + (n,))


def test_runner_equals_the_proc_called_directly():
    x = _signal(4096, 0, (3,))
    runner = StreamRunner(_proc(), batch_shape=(3,), device="cpu")
    proc = _proc()
    carry = proc.init(batch_shape=(3,))
    for blk in np.split(x, 8, axis=-1):
        y = runner(blk)
        yd, carry = proc(carry, torch.from_numpy(blk))
        assert y.dtype == torch.complex64 and y.shape == (3, 512)
        assert torch.equal(y, yd)
    assert runner.blocks_processed == 8
    # a tensor input, and a float64 numpy input (made complex64)
    y = runner(torch.from_numpy(x[:, :512]))
    yd, carry = proc(carry, torch.from_numpy(x[:, :512]))
    assert torch.equal(y, yd)
    y = runner(x[:, :512].astype(np.complex128))
    yd, carry = proc(carry, torch.from_numpy(x[:, :512]))
    assert torch.equal(y, yd)


def test_runner_matches_jax_runner():
    # tests/test_runtime.py's chain and block split
    x = _signal(4096, 1)
    jr = JStreamRunner(_jproc(), batch_shape=())
    r = StreamRunner(_proc(), device="cpu")
    ys = [r(blk).numpy() for blk in np.split(x, 8)]
    jys = [np.asarray(jr(jnp.asarray(blk))) for blk in np.split(x, 8)]
    assert tp.rel_err(np.concatenate(ys), np.concatenate(jys)) < 1e-4
    assert r.blocks_processed == jr.blocks_processed == 8
    outs = list(r.run(iter(np.split(x, 4))))
    assert len(outs) == 4 and r.blocks_processed == 12
    r.reset()
    assert r.blocks_processed == 0
    np.testing.assert_array_equal(r(x[:512]).numpy(), ys[0])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_packages(tmp_path, direction):
    x = _signal(2048, 2, (2,))
    blocks = np.split(x, 4, axis=-1)
    path = tmp_path / "state.npz"
    jr = JStreamRunner(_jproc(), batch_shape=(2,))
    r = StreamRunner(_proc(), batch_shape=(2,), device="cpu")
    for blk in blocks[:2]:
        jr(jnp.asarray(blk))
        r(blk)
    if direction == "jax_to_port":
        jr.save(path)
        resumed = StreamRunner(_proc(), batch_shape=(2,), device="cpu")
        resumed.load(path)
        assert resumed.blocks_processed == 2
        want = [np.asarray(jr(jnp.asarray(b))) for b in blocks[2:]]
        got = [resumed(b).numpy() for b in blocks[2:]]
    else:
        r.save(path)
        resumed = JStreamRunner(_jproc(), batch_shape=(2,))
        resumed.load(path)
        assert resumed.blocks_processed == 2
        want = [r(b).numpy() for b in blocks[2:]]
        got = [np.asarray(resumed(jnp.asarray(b))) for b in blocks[2:]]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_checkpoint_resume_is_exact_within_the_port(tmp_path):
    x = _signal(2048, 3, (2,))
    blocks = np.split(x, 4, axis=-1)
    r1 = StreamRunner(_proc(), batch_shape=(2,), device="cpu")
    for blk in blocks[:2]:
        r1(blk)
    r1.save(tmp_path / "s.npz")
    tail1 = [r1(b) for b in blocks[2:]]
    r2 = StreamRunner(_proc(), batch_shape=(2,), device="cpu")
    r2.load(tmp_path / "s.npz")
    for a, b in zip(tail1, [r2(b) for b in blocks[2:]]):
        assert torch.equal(a, b)


def test_leaf_order_is_jax_flatten_order(tmp_path):
    # two dict keys out of insertion order with the same shapes: a flatten
    # in insertion order would load them swapped with no error
    carry = {"zeta": np.full(3, 1.0, np.float32),
             "alpha": (np.full(3, 2.0, np.float32), None,
                       [np.full(3, 3.0, np.float32)]),
             "mid": np.int64(4)}
    like = {"zeta": torch.zeros(3), "alpha": (torch.zeros(3), None,
                                              [torch.zeros(3)]),
            "mid": np.int64(0)}
    jck.save_carry(tmp_path / "j.npz", {k: carry[k] for k in carry})
    got = ck.load_carry(tmp_path / "j.npz", like)
    assert list(got) == ["zeta", "alpha", "mid"]
    assert float(got["zeta"][0]) == 1.0 and float(got["alpha"][0][0]) == 2.0
    assert got["alpha"][1] is None and float(got["alpha"][2][0][0]) == 3.0
    assert int(got["mid"]) == 4 and torch.is_tensor(got["zeta"])
    ck.save_carry(tmp_path / "t.npz", like | {"zeta": torch.ones(3)})
    back = jck.load_carry(tmp_path / "t.npz", carry)
    assert float(back["zeta"][0]) == 1.0 and float(back["alpha"][0][0]) == 0
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(j.files) == sorted(t.files)
    assert bytes(j["__treedef__"]) == bytes(t["__treedef__"])


def test_carry_of_a_real_chain_round_trips(tmp_path):
    proc = _proc()
    c = proc.init(batch_shape=(2,))
    _, c = proc(c, torch.from_numpy(_signal(300, 4, (2,))))
    ck.save_carry(tmp_path / "c.npz", c)
    back = ck.load_carry(tmp_path / "c.npz", proc.init(batch_shape=(2,)))
    flat, flat_back = [], []
    assert ck._flatten(c, flat) == ck._flatten(back, flat_back)
    assert len(flat) == len(flat_back) > 0
    for a, b in zip(flat, flat_back):
        assert torch.equal(a, b)


def test_shape_mismatch_raises(tmp_path):
    r = StreamRunner(_proc(), batch_shape=(), device="cpu")
    r(_signal(256, 5))
    r.save(tmp_path / "s.npz")
    r2 = StreamRunner(_proc(), batch_shape=(2,), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        r2.load(tmp_path / "s.npz")
    jck.save_carry(tmp_path / "c.npz", {"a": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="does not match"):
        ck.load_carry(tmp_path / "c.npz", {"a": torch.zeros(5)})


def test_mesh_raises_naming_item_6_and_the_card_is_the_default():
    # the mesh (once a raise naming the item that ports it): a 2-shard
    # time mesh of the CPU, its home device the runner's; a device other
    # than the mesh's home raises
    from liquid_dsp_tpu_torch.parallel import stream_mesh
    mesh = stream_mesh(n_time=2, devices=["cpu", "cpu"])
    r = StreamRunner(_proc(), batch_shape=(1,), mesh=mesh)
    assert r.device == torch.device("cpu")
    assert r(_signal(512, 3)[None]).shape == (1, 512)
    with pytest.raises(ValueError, match="home device"):
        StreamRunner(_proc(), mesh=mesh, device="cuda:0")
    with pytest.raises(RuntimeError, match="CUDA card"):
        StreamRunner(_proc())


def test_capture_through_the_runner(tmp_path):
    # tests/test_runtime.py's io case: a cs16 capture in 2048-sample blocks
    rng = np.random.default_rng(2)
    x = (rng.uniform(-0.5, 0.5, 8192) +
         1j * rng.uniform(-0.5, 0.5, 8192)).astype(np.complex64)
    f = tmp_path / "cap.cs16"
    io.write_iq(f, x, "cs16")
    runner = StreamRunner(_proc(), batch_shape=(), device="cpu")
    outs = list(runner.run(io.iq_stream(f, "cs16", block=2048)))
    assert len(outs) == 4 and all(o.shape == (2048,) for o in outs)
    jr = JStreamRunner(_jproc(), batch_shape=())
    jouts = list(jr.run(jio.iq_stream(f, "cs16", block=2048)))
    assert tp.rel_err(torch.cat(outs).numpy(),
                      np.concatenate([np.asarray(o) for o in jouts])) < 1e-4
