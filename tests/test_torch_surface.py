"""The port's public surface against the JAX package's.

The walk: every module of liquid_dsp_tpu (pkgutil.walk_packages; not the
Pallas kernel files and not `native/`, under ROADMAP's "Not carried
over") has a counterpart in liquid_dsp_tpu_torch, and there

* every public name the JAX module binds at its top level (functions,
  classes, constants, `__all__`, `__version__`, a package `__init__`'s
  re-exports) exists, callable where the JAX one is;
* a public function's parameter names, and a class's constructor's, are
  among the port's (a `*args` or `**kw` of the JAX side needs one of its
  kind in the port);
* a public class's public members (`__call__` included; dataclass and
  NamedTuple fields too) are bound by the port's own class, not by a
  torch base it inherits from (nn.Module's `apply` is not a Proc's), and
  its methods' parameters are checked as functions' are.

What the port leaves out by decision is listed once, in NOT_CARRIED, with
its reason (the same entries as ROADMAP's "Not carried over" and the
north star's renames); a second test holds every entry to a gap the walk
still finds, so none goes stale.

Then parity on the CPU for the surface closed last: the `design`
package's six functions (bit-equal: the same numpy float64 code, as in
tests/test_torch_design_filters.py), `conv1d`/`conv1d_real` with
`lhs_dilation` (2e-6 relative, 1e-6 absolute, the tolerance of
tests/test_torch_nco_dotprod.py; both packages refuse any value but 1),
`Proc.scan_blocks` against the JAX method over 3 blocks (a FIR at 1e-5 of
rms and the carry equal, tests/test_torch_fir.py; an IIR cascade at 1e-5
absolute, tests/test_torch_iir.py; the frame64 stream receiver's
NamedTuple output stacked leaf by leaf, at tests/test_torch_frame64.py's
tolerances), bit-equal to as many `forward` calls, and `__version__`.
"""
import ast
import functools
import importlib
import inspect
import pathlib
import pkgutil
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
import liquid_dsp_tpu
import liquid_dsp_tpu_torch
from liquid_dsp_tpu import design as jdesign
from liquid_dsp_tpu import planar as planar_jax
from liquid_dsp_tpu.framing import frame64 as jf
from liquid_dsp_tpu.ops import dotprod as jdot
from liquid_dsp_tpu.ops import fir as jfir
from liquid_dsp_tpu.ops import iir as jiir
from liquid_dsp_tpu_torch import design, planar
from liquid_dsp_tpu_torch.convert import (carry_from_numpy, carry_to_numpy,
                                          load_jax_params)
from liquid_dsp_tpu_torch.framing.frame64 import (FRAME64_LEN,
                                                  framesync64_stream)
from liquid_dsp_tpu_torch.ops import dotprod, fir, iir

from test_torch_frame64 import _assert_block_equal, _mkframe

JAX, PORT = liquid_dsp_tpu.__name__, liquid_dsp_tpu_torch.__name__

# (JAX module relative to the package, gap) -> why the port has no
# counterpart.  A gap is a name, "Class.member" or "function(param, ...)".
NOT_CARRIED = {
    ("core", "Pytree"): "a typing alias for JAX pytrees; the port's carries "
                        "are tensors in tuples and dicts",
    ("core", "scan_unroll"): "an unroll factor for XLA's lax.scan; the "
                             "port's recurrences are kernels",
    ("core", "Proc.jitted"): "jax.jit of apply; torch runs eagerly",
    ("core", "Proc.__call__"): "the one-shot proc(x, carry=None); "
                               "nn.Module.__call__ runs forward(carry, x)",
    ("core", "Proc.params"): "renamed: coefficients are the module's "
                             "buffers",
    ("core", "Proc.apply"): "renamed: apply(params, carry, x) is "
                            "forward(carry, x)",
    ("core", "Proc.children"): "renamed: a chain's stages are Chain.stages",
    ("core", "Proc.planar_apply"): "renamed: forward_planar",
    ("core", "Proc.planar_init"): "renamed: init_planar",
    ("core", "planar_per_plane(apply)"): "renamed: the op's forward",
    ("framing.stream_rx", "batched_apply(apply_1d)"): "renamed: apply_2d",
    ("parallel.stream", "time_shard_apply(no_collectives)"):
        "an XLA sharding option; its one caller is tools/bench_scaling.py, "
        "which stays the JAX package's",
    ("parallel.mesh", "P"): "jax.sharding.PartitionSpec; the port's mesh "
                            "is a list of torch devices",
    ("parallel.mesh", "NamedSharding"): "jax.sharding.NamedSharding; the "
                                        "port's mesh is a list of devices",
    ("utils.random", "jax_crandn"): "key-based; the port's crandn takes a "
                                    "torch.Generator",
    ("utils.random", "jax_awgn"): "key-based; the port's awgn takes a "
                                  "torch.Generator",
    ("utils", "jax_crandn"): "the re-export of utils.random's",
    ("utils", "jax_awgn"): "the re-export of utils.random's",
}


def _jax_modules():
    """The JAX package's modules, relative names ("" is the package)."""
    out = [""]
    for m in pkgutil.walk_packages(liquid_dsp_tpu.__path__, JAX + "."):
        rel = m.name[len(JAX) + 1:]
        if (rel.split(".")[0] != "native"
                and not rel.startswith("ops.kernels.pallas_")):
            out.append(rel)
    return out


def _module(pkg, rel):
    return importlib.import_module(pkg + ("." + rel if rel else ""))


def _public(name):
    return not name.startswith("_") or (name.startswith("__")
                                        and name.endswith("__"))


def _bound_names(mod):
    """The public names a module's own source binds at its top level."""
    tree = ast.parse(pathlib.Path(mod.__file__).read_text())
    names = set(getattr(mod, "__all__", ()))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names |= {n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)}
        elif (isinstance(node, ast.ImportFrom) and node.level
              and hasattr(mod, "__path__")):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if _public(n)}


def _own_classes(cls, pkg):
    return [c for c in cls.__mro__ if c.__module__.split(".")[0] == pkg]


def _members(cls):
    """A JAX class's public members, from its own package's classes."""
    names = set()
    for c in _own_classes(cls, JAX):
        names |= set(vars(c)) | set(vars(c).get("__annotations__", {}))
    return {n for n in names if not n.startswith("_") or n == "__call__"}


def _self_assigned(cls):
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(cls)))
    except (OSError, TypeError):
        return set()
    return {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
            and isinstance(n.ctx, ast.Store)
            and isinstance(n.value, ast.Name) and n.value.id == "self"}


def _binds(cls, name):
    """Whether the port's own classes (not torch's) bind ``name``."""
    return any(name in vars(c) or name in vars(c).get("__annotations__", {})
               or name in _self_assigned(c)
               for c in _own_classes(cls, PORT))


def _missing_params(jfn, pfn):
    try:
        jp = inspect.signature(jfn).parameters
        pp = inspect.signature(pfn).parameters
    except (TypeError, ValueError):
        return []
    var = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    kinds = {p.kind for p in pp.values()}
    named = {n for n, p in pp.items() if p.kind not in var}
    return [n for n, p in jp.items()
            if (p.kind not in kinds if p.kind in var else n not in named)]


def _gap(what, missing):
    return f"{what}({', '.join(missing)})"


@functools.lru_cache(maxsize=None)
def _gaps(rel):
    """What the port's counterpart of JAX module ``rel`` lacks."""
    jm, pm = _module(JAX, rel), _module(PORT, rel)
    gaps = set()
    for name in _bound_names(jm):
        jv = getattr(jm, name)
        if not hasattr(pm, name) or (callable(jv)
                                     and not callable(getattr(pm, name))):
            gaps.add(name)
            continue
        if getattr(jv, "__module__", None) != jm.__name__:
            continue                       # checked where it is defined
        pv = getattr(pm, name)
        if inspect.isfunction(jv):
            miss = _missing_params(jv, pv)
            if miss:
                gaps.add(_gap(name, miss))
        elif inspect.isclass(jv):
            plain = not (hasattr(jv, "_fields")
                         or hasattr(jv, "__dataclass_fields__"))
            miss = _missing_params(jv, pv) if plain else []
            if miss:
                gaps.add(_gap(name, miss))
            for m in _members(jv):
                if not _binds(pv, m):
                    gaps.add(f"{name}.{m}")
                    continue
                jm_ = inspect.getattr_static(jv, m, None)
                if isinstance(jm_, (staticmethod, classmethod)) or \
                        inspect.isfunction(jm_):
                    miss = _missing_params(getattr(jv, m), getattr(pv, m))
                    if miss:
                        gaps.add(_gap(f"{name}.{m}", miss))
    return gaps


@pytest.mark.parametrize("rel", _jax_modules())
def test_port_has_the_public_surface(rel):
    gaps = _gaps(rel) - {g for (r, g) in NOT_CARRIED if r == rel}
    assert not gaps, (f"{PORT}.{rel or '__init__'} lacks what "
                      f"{JAX}.{rel or '__init__'} has: {sorted(gaps)}")


@pytest.mark.parametrize("rel,gap", sorted(NOT_CARRIED))
def test_every_exception_is_still_a_gap(rel, gap):
    # present in the JAX package, absent from the port: else the entry
    # goes, with ROADMAP's line for it
    assert rel in _jax_modules()
    assert gap in _gaps(rel), (rel, gap, NOT_CARRIED[(rel, gap)])


# --- parity of what was closed -----------------------------------------------

def test_version_is_the_jax_packages():
    assert liquid_dsp_tpu_torch.__version__ == liquid_dsp_tpu.__version__
    assert liquid_dsp_tpu_torch.__version__ == "0.1.0"


def _design_cases(rng):
    fc = float(rng.uniform(0.1, 0.2))
    w, zeta, K = float(rng.uniform(0.01, 0.1)), 0.707, 1000.0
    return {
        "firdespm": ((31, [(0.0, fc), (fc + 0.1, 0.5)], [1.0, 0.0],
                      [1.0, 10.0]), {}),
        "firdespm_lowpass": ((41, fc, 60.0), {}),
        "iirdes": (("cheby1", 5, fc), {"ap_db": 0.5}),
        "iirdes_sos": (("ellip", 6, fc), {"ap_db": 0.5, "as_db": 50.0}),
        "iirdes_pll_active_lag": ((w, zeta, K), {}),
        "iirdes_pll_active_pi": ((w, zeta, K), {}),
    }


@pytest.mark.parametrize("name", sorted(_design_cases(
    np.random.default_rng(0))))
def test_design_package_functions_equal_jax(name):
    args, kw = _design_cases(np.random.default_rng(26))[name]
    got, want = getattr(design, name), getattr(jdesign, name)
    assert inspect.isfunction(got)
    got, want = got(*args, **kw), want(*args, **kw)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(*((got, want) if isinstance(want, tuple)
                      else ((got,), (want,)))):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


def _conv_inputs(kind):
    rng = np.random.default_rng(26)
    x = (tp.cnoise(rng, (2, 40)) if kind[0] == "c"
         else rng.standard_normal((2, 40)).astype(np.float32))
    h = (tp.cnoise(rng, 7) if kind[1] == "c"
         else rng.standard_normal(7).astype(np.float32))
    return x, h


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["cr", "rr", "cc", "rc"])
def test_conv1d_with_lhs_dilation_equals_jax(kind, stride):
    x, h = _conv_inputs(kind)
    got = dotprod.conv1d(torch.from_numpy(x), torch.from_numpy(h), stride,
                         lhs_dilation=1).numpy()
    want = np.asarray(jdot.conv1d(jnp.asarray(x), jnp.asarray(h), stride,
                                  lhs_dilation=1))
    assert got.shape == want.shape == (2, (40 - 7) // stride + 1)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    if kind == "rr":
        got = dotprod.conv1d_real(torch.from_numpy(x), torch.from_numpy(h),
                                  stride, 1).numpy()
        want = np.asarray(jdot.conv1d_real(jnp.asarray(x), jnp.asarray(h),
                                           stride, 1))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["cr", "rr", "cc"])
def test_lhs_dilation_other_than_1_refused_by_both(kind):
    x, h = _conv_inputs(kind)
    fns = [(dotprod.conv1d, torch.from_numpy, "only 1"),
           (jdot.conv1d, jnp.asarray, "transposed convolution")]
    if kind == "rr":
        fns += [(dotprod.conv1d_real, torch.from_numpy, "only 1"),
                (jdot.conv1d_real, jnp.asarray, "transposed convolution")]
    for fn, arr, msg in fns:
        with pytest.raises(ValueError, match=msg):
            fn(arr(x), arr(h), 1, lhs_dilation=2)


def _port_forwards(proc, carry, blocks):
    """The blocks through ``forward`` one by one: (outputs, carry)."""
    ys = []
    for xb in blocks:
        y, carry = proc(carry, xb)
        ys.append(y)
    return ys, carry


def test_scan_blocks_fir_equals_jax():
    rng = np.random.default_rng(26)
    h = rng.standard_normal(37)
    xs = tp.cnoise(rng, (3, 2, 500))
    jp = jfir.firfilt(h)
    p = fir.firfilt(h)
    load_jax_params(p, tp.jax_params(jp))
    yj, cj = jp.scan_blocks(jnp.asarray(xs), batch_shape=(2,))
    y, c = p.scan_blocks(torch.from_numpy(xs), batch_shape=(2,))
    assert y.shape == yj.shape == (3, 2, 500)
    assert tp.rel_err(y.numpy(), np.asarray(yj)) < 1e-5
    np.testing.assert_array_equal(carry_to_numpy(c), np.asarray(cj))
    ys, cf = _port_forwards(p, p.init(batch_shape=(2,)),
                            torch.from_numpy(xs))
    assert torch.equal(y, torch.stack(ys)) and torch.equal(c, cf)
    # a given carry (the JAX package's after block 0) is where it starts
    y2, c2 = p.scan_blocks(torch.from_numpy(xs[1:]),
                           carry_from_numpy(np.asarray(
                               jp.scan_blocks(jnp.asarray(xs[:1]),
                                              batch_shape=(2,))[1])))
    assert tp.rel_err(y2.numpy(), np.asarray(yj)[1:]) < 1e-5
    np.testing.assert_array_equal(carry_to_numpy(c2), np.asarray(cj))


def test_scan_blocks_iir_equals_jax():
    rng = np.random.default_rng(27)
    B, A = jdesign.iirdes_sos("butter", 5, float(rng.uniform(0.1, 0.3)))
    xs = tp.cnoise(rng, (3, 2, 300))
    jq, pq = jiir.iirfilt_sos(B, A), iir.iirfilt_sos(B, A)
    yj, cj = jq.scan_blocks(jnp.asarray(xs), batch_shape=(2,))
    y, c = pq.scan_blocks(torch.from_numpy(xs), batch_shape=(2,))
    assert y.shape == yj.shape == (3, 2, 300)
    assert np.abs(y.numpy() - np.asarray(yj)).max() <= 1e-5
    assert np.abs(c.numpy() - np.asarray(cj)).max() <= 1e-5
    ys, cf = _port_forwards(pq, pq.init(batch_shape=(2,)),
                            torch.from_numpy(xs))
    assert torch.equal(y, torch.stack(ys)) and torch.equal(c, cf)
    _, cj0 = jq.scan_blocks(jnp.asarray(xs[:1]), batch_shape=(2,))
    y2, c2 = pq.scan_blocks(torch.from_numpy(xs[1:]),
                            carry_from_numpy(np.asarray(cj0)))
    assert np.abs(y2.numpy() - np.asarray(yj)[1:]).max() <= 1e-5
    assert np.abs(c2.numpy() - np.asarray(cj)).max() <= 1e-5


def test_scan_blocks_namedtuple_output_equals_jax():
    # the frame64 stream receiver: its output is a NamedTuple, stacked
    # leaf by leaf; frames in every block, one across a block boundary
    T = 4096
    rng = np.random.default_rng(28)
    x = np.zeros((2, 3 * T), np.complex64)
    for ch, starts in enumerate(((700, 5000, 9300), (3600, 8200))):
        for s0 in starts:
            x[ch, s0:s0 + FRAME64_LEN] = _mkframe(rng)[2]
    x += 0.004 * tp.cnoise(rng, x.shape)
    xs = np.ascontiguousarray(x.reshape(2, 3, T).transpose(1, 0, 2))
    yj, cj = jf.framesync64_stream(T).scan_blocks(jnp.asarray(xs),
                                                  batch_shape=(2,))
    p = framesync64_stream(T)
    y, c = p.scan_blocks(torch.from_numpy(xs), batch_shape=(2,))
    assert type(y).__name__ == type(yj).__name__ == "Frame64Block"
    assert y._fields == yj._fields
    for leaf, jleaf in zip(y, yj):
        assert leaf.shape == jleaf.shape and leaf.shape[0] == 3
    for b in range(3):
        _assert_block_equal(type(y)(*(leaf[b] for leaf in y)),
                            {k: np.asarray(v[b])
                             for k, v in yj._asdict().items()})
    assert int(np.asarray(yj.valid).sum()) == 5
    for key in ("buf", "base", "last_end"):
        np.testing.assert_array_equal(carry_to_numpy(c)[key],
                                      np.asarray(cj[key]))
    ys, cf = _port_forwards(p, p.init(batch_shape=(2,)),
                            torch.from_numpy(xs))
    for k, leaf in enumerate(y):
        assert torch.equal(leaf, torch.stack([o[k] for o in ys]))
    assert all(torch.equal(c[k], cf[k]) for k in c)
    # a given carry: blocks 1-2 from the carry block 0 left
    _, c0 = p(p.init(batch_shape=(2,)), torch.from_numpy(xs[0]))
    y2, _ = p.scan_blocks(torch.from_numpy(xs[1:]), c0)
    for b in (1, 2):
        _assert_block_equal(type(y2)(*(leaf[b - 1] for leaf in y2)),
                            {k: np.asarray(v[b])
                             for k, v in yj._asdict().items()})


def test_scan_blocks_slices_every_leaf_and_checks_the_count():
    # a planar stage takes (re, im): each plane is sliced on axis 0 and
    # the output pair stacked plane by plane, as the JAX package's scan
    h = np.random.default_rng(29).standard_normal(9)
    xs = tp.cnoise(np.random.default_rng(30), (3, 2, 64))
    re, im = np.ascontiguousarray(xs.real), np.ascontiguousarray(xs.imag)
    (yjr, yji), cj = planar_jax(jfir.firfilt(h)).scan_blocks(
        (jnp.asarray(re), jnp.asarray(im)), batch_shape=(2,))
    p = planar(fir.firfilt(h))
    y, c = p.scan_blocks((torch.from_numpy(re), torch.from_numpy(im)),
                         batch_shape=(2,))
    assert isinstance(y, tuple) and y[0].shape == (3, 2, 64)
    assert tp.rel_err(y[0].numpy() + 1j * y[1].numpy(),
                      np.asarray(yjr) + 1j * np.asarray(yji)) < 1e-5
    for got, want in zip(carry_to_numpy(c), cj):
        np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="blocks on axis 0"):
        p.scan_blocks((torch.from_numpy(re), torch.from_numpy(im[:2])),
                      batch_shape=(2,))
