"""Sharded stream execution: run a Proc with the time axis split across the
devices of a mesh, passing on exactly the state the reference keeps in its
ring buffers (`liquid_dsp_tpu/parallel/stream.py`).

Mapping from reference mechanisms (SURVEY.md §2.12, §5):
  * firfilt/fftfilt tail state (reference fftfilt.c:259 saved tail) ->
    ``halo`` stages: shard i > 0 starts from the last ``halo`` input
    samples of shard i - 1, copied to its device; shard 0 takes the
    inter-block carry, and the new carry is the last shard's tail.
    Overlap-save semantics, the single-device stream's output.
  * phase accumulators (NCO theta, affine in the sample index, reference
    nco.c) -> ``advance`` stages: shard i starts from
    ``advance(carry, i * T_local)``; nothing is exchanged.
  * chains -> each stage in turn over all shards (the halos of a stage
    are its own input's tails).

Shards are launched one after another from the host.  On distinct cards
they overlap, since CUDA launches are asynchronous; on one card they queue
on its stream.  Sequential-carry stages (AGC, PLL, symsync loops) do not
time-shard: shard those over channels ("ch").
"""
from __future__ import annotations

import copy
from typing import Optional

import torch

from ..core import Chain, Proc, entry_tensor, tree_map
from .mesh import Mesh, move

__all__ = ["time_shard_apply", "run_time_sharded", "stream_jit"]


def replicas(proc: Proc, devices) -> dict:
    """{device: proc on it}: the proc itself on the device its buffers
    lie on, a copy on every other device of ``devices``."""
    buf = next(proc.buffers(), None)
    here = buf.device if buf is not None else None
    return {d: proc if d == here else copy.deepcopy(proc).to(d)
            for d in dict.fromkeys(devices)}


def _fault_message(proc, h, carry) -> str:
    return (
        f"proc {proc.name!r} declares halo {h}, but its carry is not the "
        f"last {h} input samples (a single tensor of last dimension {h}): "
        f"it is a {type(carry).__name__}, so it cannot be time-sharded. "
        "This is the reference's own fault: liquid_dsp_tpu/fuse.py:208 "
        "gives kernel_fuse's Proc halo=L-1 over a {tr, ti, theta} carry, "
        "and its run_time_sharded raises AttributeError at "
        "liquid_dsp_tpu/parallel/stream.py:83. The port's MixFIRDecim "
        "declares the same halo and is refused here: time-shard the "
        "chain before kernel_fuse")


def _shard_apply(proc: Proc, carry, xs, reps):
    """One stage (or chain) over all time shards of one channel group.

    xs: the shards' inputs in time order, each on its device; carry: the
    inter-block carry on the home device (the first shard's); reps:
    {device: proc replica}.  Returns (the shards' outputs, carry')."""
    if isinstance(proc, Chain):
        new = []
        for i, stage in enumerate(proc.stages):
            xs, c2 = _shard_apply(stage, carry[i],
                                  xs, {d: r.stages[i] for d, r in
                                       reps.items()})
            new.append(c2)
        return xs, tuple(new)

    n = len(xs)
    first = xs[0].device
    T_local = xs[0].shape[-1]
    if proc.halo is not None:
        h = proc.halo
        if h == 0:
            outs = [reps[x.device](tree_map(lambda c: move(c, x.device),
                                            carry), x) for x in xs]
            return [y for y, _ in outs], outs[0][1]
        if h > T_local:
            raise ValueError(
                f"halo {h} exceeds local block {T_local}; use longer blocks")
        if not (torch.is_tensor(carry) and carry.dim() >= 1
                and carry.shape[-1] == h):
            raise ValueError(_fault_message(proc, h, carry))
        tails = [x[..., T_local - h:] for x in xs]
        ys = []
        for i, x in enumerate(xs):
            c_in = move(carry if i == 0 else tails[i - 1], x.device)
            ys.append(reps[x.device](c_in, x)[0])
        # a copy: the carry must not alias the caller's input block
        return ys, move(tails[-1], first, copy=True)

    if proc.advance is not None:
        rep0 = reps[first]
        ys = []
        for i, x in enumerate(xs):
            c_i = tree_map(lambda c: move(c, x.device),
                           rep0.advance(carry, i * T_local))
            ys.append(reps[x.device](c_i, x)[0])
        return ys, rep0.advance(carry, n * T_local)

    raise ValueError(
        f"proc {proc.name!r} has neither halo nor advance metadata; "
        "it cannot be time-sharded (shard over channels instead)")


def time_shard_apply(proc: Proc, mesh: Mesh, time_axis: str = "t",
                     channel_axis: Optional[str] = "ch"):
    """A sharded block step ``(carry, x) -> (y, carry')`` over ``mesh``.

    x: [..., T], its last axis split over ``time_axis`` (T a multiple of
    its size) and, when ``channel_axis`` names mesh axes of more than one
    device, its leading axis over their product, with every carry leaf of
    one or more dimensions split alongside.  channel_axis may be a name or
    a tuple of names (the hierarchical (dcn, ch) layout of SURVEY §5); an
    explicit tuple with a name not in the mesh raises ValueError.  The
    output is assembled on x's device, the carry on the mesh's home
    device.  The output equals ``proc`` on one device within float
    tolerance (each output sample sums the same products)."""
    n_shards = int(mesh.shape[time_axis])
    ch_axes = ((tuple(channel_axis) if isinstance(channel_axis, (tuple, list))
                else (channel_axis,)) if channel_axis is not None else ())
    if isinstance(channel_axis, (tuple, list)):
        # an explicit tuple must name real mesh axes: a typo silently
        # dropping one would quietly lose data parallelism
        unknown = [a for a in ch_axes if a not in mesh.shape]
        if unknown:
            raise ValueError(f"channel_axis names {unknown} not in mesh "
                             f"axes {tuple(mesh.shape)}")
    ch_axes = tuple(a for a in ch_axes if a in mesh.shape)
    n_groups = 1
    for a in ch_axes:
        n_groups *= int(mesh.shape[a])
    grid = mesh.grid(time_axis, ch_axes)
    reps = replicas(proc, [d for row in grid for d in row])
    home = mesh.home

    def run(carry, x):
        T = x.shape[-1]
        if T % n_shards:
            raise ValueError(f"block length {T} does not divide into "
                             f"{n_shards} time shards")
        Tl = T // n_shards
        G = n_groups if (x.dim() > 1 and n_groups > 1) else 1
        rows = grid if G > 1 else grid[:1]
        if G > 1 and x.shape[0] % G:
            raise ValueError(f"leading axis {x.shape[0]} does not divide "
                             f"into {G} channel groups")
        xg = x.chunk(G, dim=0) if G > 1 else (x,)
        cg = [_group(carry, G, g) for g in range(G)] if G > 1 else [carry]
        ys, cs = [], []
        for g, (xb, devs) in enumerate(zip(xg, rows)):
            xs = [move(xb[..., i * Tl:(i + 1) * Tl], d)
                  for i, d in enumerate(devs)]
            c_in = tree_map(lambda c: move(c, devs[0]), cg[g])
            y, c2 = _shard_apply(proc, c_in, xs, reps)
            ys.append(torch.cat([move(yi, x.device) for yi in y], dim=-1))
            cs.append(tree_map(lambda c: move(c, home), c2))
        if G == 1:
            return ys[0], cs[0]
        return torch.cat(ys, dim=0), _cat_groups(cs, carry)

    return run


def _group(carry, G: int, g: int):
    """Channel group g's slice of a carry: every leaf of one or more
    dimensions split along its leading axis."""
    def take(c):
        if c.dim() == 0:
            return c
        if c.shape[0] % G:
            raise ValueError(f"carry leaf {tuple(c.shape)} does not divide "
                             f"into {G} channel groups")
        return c.chunk(G, dim=0)[g]
    return tree_map(take, carry)


def _cat_groups(cs, like):
    """The channel groups' carries joined along the leading axis (a
    0-dimensional leaf, not split, is the first group's)."""
    if isinstance(like, dict):
        return {k: _cat_groups([c[k] for c in cs], like[k]) for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_cat_groups([c[i] for c in cs], v)
                          for i, v in enumerate(like))
    if torch.is_tensor(like) and like.dim() > 0:
        return torch.cat(cs, dim=0)
    return cs[0]


def run_time_sharded(proc: Proc, mesh: Mesh, x, carry=None, **init_kw):
    """One sharded block step from a fresh carry (made on the mesh's home
    device with ``init_kw``) or the one given.  A host array goes to the
    home device first."""
    if carry is None:
        carry = proc.init(device=mesh.home, **init_kw)
    return time_shard_apply(proc, mesh)(carry, entry_tensor(x, mesh.home))


def stream_jit(proc: Proc, mesh: Optional[Mesh] = None, **shard_kw):
    """The block step ``(carry, x) -> (y, carry')``: the proc itself, or
    time-sharded over ``mesh``.  Eager (no compile); the name is the JAX
    package's."""
    if mesh is None:
        return lambda carry, x: proc(carry, x)
    return time_shard_apply(proc, mesh, **shard_kw)
