"""LDPC belief propagation's iteration loop and the decode's decisions: a
Hopper kernel for the JAX package's ``lax.scan`` in `liquid_dsp_tpu/fec/
ldpc.py:225-241` (the batched decoder's `step`, `max_iters` times over the
messages Rv) and the posterior, decisions and syndrome after it.  The JAX
package has no Pallas kernel here; on torch an iteration was about 36
launches.

`ldpc_bp` takes the LLRs [R, n] and the slot maps of `fec/ldpc.py`'s
`_slot_maps` (check slot -> variable slot `c2v`, variable slot -> check
slot `v2c`, check slot -> variable `cvar`; pads point one past the end)
and returns the final variable-side messages Rv [R, n*wc + 1] (the last
column the pad, 0); given H's weights at the check slots (`cw`) it
returns the decisions and the parity verdict of the same launch instead
(hard [R, n] int32, ok [R] bool).  A CUDA tensor launches
``csrc/ldpc_bp.cu`` (one launch for every iteration of every codeword,
over the real edges only: `compact_maps`); a CPU tensor runs
`ldpc_bp_reference` and `ldpc_decide_reference`, the decoder's loop and
epilogue in plain PyTorch; any other device raises.  An iteration: Q =
posterior - own message at each check slot (pads neutral: 38.0 for
sum-product, where tanh(19) is 1 in float32, inf for min-sum), the check
update (`check_update`), the messages gathered back to the variables
(pads 0).

Both add each sum in slot order (`slot_sum`: the posterior over a
variable's wc messages, the log-magnitudes over a check's wr slots) and
round every operation once, with the same float32 functions, so the
kernel can equal the plain version bit for bit on the card: a check's
real slots come first, so its pads' part of the sum is wr - deg adds of
one constant after them, which the kernel adds without their work.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SAT", "TINY", "CAP", "NEUTRAL_SP", "check_update",
           "compact_maps", "ldpc_bp", "ldpc_bp_reference",
           "ldpc_decide_reference", "posterior", "slot_sum"]

SAT = float(np.float32(1.0 - 1e-7))    # the largest float32 below 1
TINY = float(np.float32(1e-30))
CAP = 1e6                              # a weight-1 check's min-sum message
NEUTRAL_SP = 38.0                      # tanh(19) is 1 in float32


def slot_sum(v):
    """The sum over the last axis in slot order, ((v0 + v1) + v2) + ...:
    the kernel's order.  (A PyTorch reduction on the card splits a short
    axis over threads and adds in another order.)"""
    s = v[..., 0]
    for j in range(1, v.shape[-1]):
        s = s + v[..., j]
    return s


def posterior(llr, Rv, n: int, wc: int):
    """llr [R, n] plus each variable's wc messages of Rv [R, n*wc + 1],
    added in slot order."""
    return llr + slot_sum(Rv[:, :n * wc].reshape(-1, n, wc))


def _excl_sign(neg):
    # the sign of the product over the other slots, from the parity of
    # negative counts (the JAX decoder's adds-only form, kept so that both
    # round alike)
    tot = neg.sum(dim=-1, keepdim=True)
    return 1.0 - 2.0 * torch.remainder(tot - neg, 2.0)


def check_update(Q, min_sum: bool):
    """Check-node messages from the incoming Q [..., m, wr] (pads neutral):
    `liquid_dsp_tpu/fec/ldpc.py:176-216` on torch."""
    if min_sum:
        neg = (Q < 0).to(Q.dtype)
        mag = Q.abs()
        m1 = mag.amin(dim=-1, keepdim=True)
        # the first slot holding the minimum (the JAX decoder's cumsum of
        # the ties; argmin returns the first, and a scan over a short
        # innermost axis is slow on the card)
        only_first = torch.arange(Q.shape[-1], device=Q.device) == \
            mag.argmin(dim=-1, keepdim=True)
        m2 = torch.where(only_first, torch.inf, mag).amin(dim=-1,
                                                          keepdim=True)
        # a weight-1 check sends a large finite certainty, never inf
        return _excl_sign(neg) * torch.clamp(
            torch.where(only_first, m2, m1), max=CAP)
    # saturated BP in the log domain: the sum of log|tanh| and the sign
    # parity; |messages| stay below 2 atanh(SAT) ~ 17.3
    t = torch.clamp(torch.tanh(Q / 2), -SAT, SAT)
    neg = (t < 0).to(Q.dtype)
    lt = torch.log(torch.clamp(t.abs(), min=TINY))
    mag = torch.exp(slot_sum(lt)[..., None] - lt)
    return 2 * torch.atanh(torch.clamp(_excl_sign(neg) * mag, -SAT, SAT))


def ldpc_bp_reference(llr, c2v, v2c, cvar, m: int, n: int, wr: int,
                      wc: int, max_iters: int, min_sum: bool):
    """Plain PyTorch version: the decoder's loop, about 36 launches an
    iteration.  llr [R, n] float32; maps as `ldpc_bp` -> Rv [R, n*wc+1]."""
    neutral = torch.inf if min_sum else NEUTRAL_SP
    c2v_pad = (c2v == n * wc)
    v2c_pad = (v2c == m * wr)
    pad1 = torch.nn.functional.pad
    Rv = llr.new_zeros(llr.shape[0], n * wc + 1)
    for _ in range(max_iters):
        post = posterior(llr, Rv, n, wc)
        Qv = pad1(post, (0, 1)).index_select(1, cvar) - \
            Rv.index_select(1, c2v)
        Qv = torch.where(c2v_pad, neutral, Qv)
        R = check_update(Qv.reshape(-1, m, wr), min_sum)
        Rflat = pad1(R.reshape(-1, m * wr), (0, 1))
        Rv2 = torch.where(v2c_pad, 0.0, Rflat.index_select(1, v2c))
        Rv = pad1(Rv2, (0, 1))
    return Rv


def compact_maps(c2v, v2c, cvar, m: int, n: int, wr: int, wc: int):
    """The real edges of `_slot_maps`'s padded maps (numpy or CPU
    tensors), numbered check-major in slot order -> numpy int32 (cstart
    [m + 1] a check's first edge, evar [E] an edge's variable, echk [E]
    its check, vstart [n + 1] a variable's first entry of vedge, vedge [E]
    a variable's edges in vslot order); edge e's check slot is echk[e]*wr
    + e - cstart[echk[e]].  Raises ValueError unless every check's and
    variable's real slots come before its pads (the kernel's sums and its
    reads of H's weights rest on that)."""
    c2v, v2c, cvar = (np.asarray(a, np.int64).reshape(-1)
                      for a in (c2v, v2c, cvar))
    creal = (cvar != n).reshape(m, wr)
    vreal = (v2c != m * wr).reshape(n, wc)
    for real in (creal, vreal):
        if (real[:, 1:] & ~real[:, :-1]).any():
            raise ValueError("compact_maps: a pad slot before a real one")
    deg_c, deg_v = creal.sum(1), vreal.sum(1)
    cs = np.flatnonzero(creal)                  # the edges' check slots
    eid = np.full(m * wr + 1, -1, np.int64)
    eid[cs] = np.arange(len(cs))
    vedge = eid[v2c[vreal.reshape(-1)]]
    if (vedge < 0).any() or not np.array_equal(
            np.sort(vedge), np.arange(len(cs))):
        raise ValueError("compact_maps: the two sides' edges differ")
    i32 = lambda a: np.ascontiguousarray(a, np.int32)    # noqa: E731
    return (i32(np.concatenate([[0], np.cumsum(deg_c)])), i32(cvar[cs]),
            i32(cs // wr), i32(np.concatenate([[0], np.cumsum(deg_v)])),
            i32(vedge))


def ldpc_decide_reference(llr, Rv, cvar, cw, m: int, n: int, wr: int,
                          wc: int):
    """The decode's epilogue in plain PyTorch: (hard [R, n] int32 = the
    posterior < 0, ok [R] bool = the exact integer syndrome over each
    check's slots, weighted by H's entries `cw` [m*wr], is even)."""
    hard = (posterior(llr, Rv, n, wc) < 0).to(torch.int32)
    hard_p = torch.nn.functional.pad(hard, (0, 1))
    syn = (hard_p.index_select(1, cvar).to(torch.int64)
           * cw).reshape(-1, m, wr).sum(dim=-1)
    return hard, (syn % 2 == 0).all(dim=-1)


_GRIDS = {}     # (card, m, n, E, min_sum) -> (in_smem, resident blocks)


def _grid(lib, dev, m, n, E, min_sum):
    """Whether a codeword's arrays fit in shared memory on `dev`, and the
    persistent grid there (the blocks the card keeps resident): asked of
    the card once for each code and mode."""
    key = (torch.cuda.current_device(), m, n, E, min_sum)
    if key not in _GRIDS:
        in_smem = int(lib.ldpc_bp_smem_bytes(m, n, E) <=
                      lib.ldpc_bp_smem_max())
        grid = lib.ldpc_bp_blocks(m, n, E, int(min_sum), in_smem)
        if grid < 1:
            raise RuntimeError(f"ldpc_bp: no grid for the kernel on {dev}: "
                               f"CUDA error {-grid}")
        _GRIDS[key] = (in_smem, grid)
    return _GRIDS[key]


def ldpc_bp(llr, c2v, v2c, cvar, m: int, n: int, wr: int, wc: int,
            max_iters: int, min_sum: bool, cw=None, maps=None,
            messages: bool = False):
    """All `max_iters` belief-propagation iterations over the rows of llr
    [R, n] float32 (> 0 means bit 0): the messages Rv [R, n*wc + 1]
    float32 that the posterior (`posterior`) is formed from.  c2v, cvar
    [m*wr] and v2c [n*wc] are `_slot_maps`'s maps on llr's device, int32
    (the plain version takes int64 too).

    With `cw` (H's weights at the check slots, [m*wr] int64, `_slot_maps`'s
    last map) the same launch also decides: it returns (hard [R, n] int32,
    ok [R] bool), or (Rv, hard, ok) with `messages`; both devices read the
    parity from `cw`.  `maps`: the five arrays of `compact_maps` as
    tensors on the card, made once by the caller (the decoder); without
    them the card's path makes them from the padded maps on the host, each
    call (this call form, the messages alone, predates the decoder's).

    A CUDA tensor launches the kernel (and counts the launch in
    ``ldpc_bp.launches``); a CPU tensor runs the plain version.  Any H
    runs on the card: a codeword's arrays sit in shared memory where they
    fit, otherwise in a global scratch.
    """
    if (llr.dim() != 2 or llr.dtype != torch.float32 or llr.shape[1] != n
            or c2v.shape != (m * wr,) or cvar.shape != (m * wr,)
            or v2c.shape != (n * wc,) or max_iters < 0
            or (cw is not None and cw.shape != (m * wr,))):
        raise ValueError(
            f"ldpc_bp takes llr [R, {n}] float32, c2v, cvar (and cw) "
            f"[{m * wr}], v2c [{n * wc}] and max_iters >= 0, got "
            f"{tuple(llr.shape)} {llr.dtype}, {tuple(c2v.shape)}, "
            f"{tuple(cvar.shape)}, {tuple(v2c.shape)}, {max_iters}")
    devs = {t.device for t in (llr, c2v, v2c, cvar)
            + (() if cw is None else (cw,))}
    if len(devs) != 1:
        raise ValueError(f"ldpc_bp: tensors on {sorted(map(str, devs))}")
    dev = llr.device
    if dev.type == "cpu":
        rv = ldpc_bp_reference(llr, c2v, v2c, cvar, m, n, wr, wc,
                               max_iters, min_sum)
        if cw is None:
            return rv
        hard, ok = ldpc_decide_reference(llr, rv, cvar, cw, m, n, wr, wc)
        return (rv, hard, ok) if messages else (hard, ok)
    if dev.type != "cuda":
        raise ValueError(f"ldpc_bp runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {dev}")
    if c2v.dtype != torch.int32 or v2c.dtype != torch.int32 or \
            cvar.dtype != torch.int32:
        raise ValueError(f"ldpc_bp on the card takes int32 maps, got "
                         f"{c2v.dtype}, {v2c.dtype}, {cvar.dtype}")
    R = llr.shape[0]
    want_rv = cw is None or messages
    rv = torch.empty(R, n * wc + 1, dtype=torch.float32, device=dev) \
        if want_rv else None
    hard = ok = None
    if cw is not None:
        hard = torch.empty(R, n, dtype=torch.int32, device=dev)
        ok = torch.empty(R, dtype=torch.bool, device=dev)
    outs = tuple(t for t in (rv, hard, ok) if t is not None)
    if R == 0:
        return outs[0] if len(outs) == 1 else outs
    if cw is not None and (cw.dtype != torch.int64
                           or not cw.is_contiguous()):
        raise ValueError(f"ldpc_bp on the card takes cw contiguous int64, "
                         f"got {cw.dtype}")
    if maps is None:
        maps = tuple(torch.from_numpy(a).to(dev) for a in compact_maps(
            c2v.cpu(), v2c.cpu(), cvar.cpu(), m, n, wr, wc))
    if len(maps) != 5 or any(t.device != dev or not t.is_contiguous()
                             for t in maps):
        raise ValueError("ldpc_bp: maps are compact_maps's five arrays, "
                         "contiguous on llr's card")
    E = maps[1].shape[0]
    llr = llr.contiguous()
    from .build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        in_smem, grid = _grid(lib, dev, m, n, E, bool(min_sum))
        blocks = min(grid, R)
        scratch = None if in_smem else torch.empty(
            blocks, 2 * E + n + 4 * m, dtype=torch.float32, device=dev)
        ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
        rc = lib.ldpc_bp_launch(
            llr.data_ptr(), ptr(rv), ptr(hard), ptr(ok), ptr(scratch),
            *(t.data_ptr() for t in maps), ptr(cw), R, blocks, m, n, E,
            wr, wc, int(max_iters), int(bool(min_sum)), in_smem, SAT, TINY,
            float("inf") if min_sum else NEUTRAL_SP, CAP,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ldpc_bp kernel launch failed: CUDA error {rc}")
    ldpc_bp.launches += 1
    return outs[0] if len(outs) == 1 else outs


ldpc_bp.launches = 0
