"""A cascade of second-order sections evaluated parallel in time: a Hopper
kernel for the JAX package's ``lax.associative_scan`` in
`liquid_dsp_tpu/ops/iir.py:266-305` (`iir_apply_sos_pscan`, the
``backend="pscan"`` of `iirfilt_sos`).  The JAX package has no Pallas
kernel here.

Each section's DF2T update is an affine map of its state s = (s0, s1):

    s[n] = M s[n-1] + v[n],   M = [[-a1, 1], [-a2, 0]],
    v[n] = (c1 x[n], c2 x[n]),  c1 = b1 - a1 b0,  c2 = b2 - a2 b0,
    y[n] = b0 x[n] + s0[n-1],

with x the section's input (the previous section's output).  A row is cut
into tiles of ``chunk * threads`` samples and a tile into ``threads``
chunks of ``chunk`` samples, the chunks in warps of ``lanes`` =
min(32, threads) (chunk j is lane j % lanes of warp j // lanes); per tile,
for each section in turn:

1. the walk: chunk j runs the map over its samples from the zero state
   (chunk 0 from the tile's carry), giving its end state e_j;
2. the combine, in two levels.  In each warp an inclusive Kogge-Stone
   scan, for d = 0 .. log2(lanes) - 1 and every lane l >= 2^d at once,
   e_l <- P_d e_{l - 2^d} + e_l with P_d = M^(chunk * 2^d), gives W_l, the
   end of lane l's chunk from the warp's start taken as zero.  The warps'
   totals (their last lane's W) are scanned the same way with
   P_{log2(lanes) + d} = M^(chunk * lanes * 2^d), which gives G_w, the
   true end of warp w.  Chunk j's true start is W_{l-1} + M^(chunk l)
   G_{w-1} (the lane powers, `pscan_lane_powers`), G_{w-1} for lane 0,
   and in warp 0 W_{l-1} (chunk 0: the tile's carry);
3. the re-walk: chunk j runs the map again from its true start and writes
   y, which the next section takes as its input.  The tile's carry for the
   next tile is the re-walk's end state of the chunk that holds the tile's
   last sample.

The powers come from repeated squaring in float32 (Q_0 = M,
Q_{i+1} = Q_i Q_i), and P_d = Q_{log2(chunk) + d}; the lane power
M^(chunk l) is P of l's lowest set bit, times P of each higher set bit in
turn from the left.  Every a*b + c is one fused multiply-add (`fma32`,
exact), in this order: a step is s0' = fma(-a1, s0, fma(c1, x, s1)),
s1' = fma(-a2, s0, c2 x) (and y = fma(b0, x, s0) in the re-walk); c1 and
c2 are fma(-a1, b0, b1) and fma(-a2, b0, b2); a matrix applied, P f + e,
is fma(P[i][0], f0, fma(P[i][1], f1, e_i)); a matrix product's entry
fma(A[i][0], B[0][j], A[i][1] B[1][j]).  Complex values work on their
planes: a*b + c as (fma(ar, br, fma(-ai, bi, cr)), fma(ar, bi, fma(ai, br,
ci))), a*b as (fma(ar, br, -(ai bi)), fma(ar, bi, ai br)).  The kernel
writes the same operations out (``__fmaf_rn`` / ``__fmul_rn``) with the
same chunk, tile, warp and combine order, so on the card it equals the
plain version bit for bit.  The kernel also takes section k's re-walk and
section k + 1's walk in one pass over a chunk, and a full tile without
predicates: the same operations on each chain, so the same bits.

`iir_pscan` launches the CUDA kernel ``csrc/iir_pscan.cu`` on a CUDA
tensor and runs `iir_pscan_reference` at the kernel's chunk and threads
on a CPU tensor; any other device raises.  Real coefficients run on
float32 rows (the caller splits a complex stream into its planes),
complex coefficients on complex64 rows.  The plain version takes any
[ns, 3], any T and any number of rows, and any chunk and threads that are
powers of two.  The kernel takes 1 to MAX_NS (64) sections in one launch
(their constants and powers in shared memory); the wrapper runs a longer
cascade as launches of at most MAX_NS sections, each section's
arithmetic unchanged, so the same bits.  Like the JAX package, it keeps
this form for an unstable filter: its powers may overflow there, as the
JAX package's products do.
"""
from __future__ import annotations

import torch

from .symsync_scan import fma32

__all__ = ["CHUNK", "LANES", "MAX_NS", "THREADS", "iir_pscan",
           "iir_pscan_reference", "launch_groups", "pscan_lane_powers",
           "pscan_powers"]

THREADS = 256                   # chunks of a tile: the kernel's threads
LANES = 32                      # chunks of a warp
CHUNK = {False: 64, True: 32}   # samples of a chunk, real and complex rows
MAX_NS = 64                     # sections in one launch


def _log2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"iir_pscan: {what} must be a power of two, got {n}")
    return n.bit_length() - 1


def _arith(cplx: bool):
    """(planes, madd, mul): a tensor as its values (float32) or as a
    leading axis of its two float planes (complex64); a*b + c and a*b of
    such, as the kernel takes them; negation is the tensors' own."""
    if not cplx:
        return (lambda t: t), fma32, (lambda p, q: p * q)

    def madd(p, q, r):
        return torch.stack([fma32(p[0], q[0], fma32(-p[1], q[1], r[0])),
                            fma32(p[0], q[1], fma32(p[1], q[0], r[1]))])

    def mul(p, q):
        return torch.stack([fma32(p[0], q[0], -(p[1] * q[1])),
                            fma32(p[0], q[1], p[1] * q[0])])

    return (lambda t: torch.view_as_real(t).movedim(-1, 0)), madd, mul


def _matmul(madd, mul, A, B):
    """A B for 2x2 matrices as (m00, m01, m10, m11)."""
    a, b, c, d = A
    e, f, g, h = B
    return (madd(a, e, mul(b, g)), madd(a, f, mul(b, h)),
            madd(c, e, mul(d, g)), madd(c, f, mul(d, h)))


def _apply(madd, P, f0, f1, e0, e1):
    """P (f0, f1) + (e0, e1)."""
    return (madd(P[0], f0, madd(P[1], f1, e0)),
            madd(P[2], f0, madd(P[3], f1, e1)))


def pscan_powers(a, chunk: int, threads: int):
    """P_d = M^(chunk * 2^d) for d = 0 .. log2(threads) - 1 of each
    section's M = [[-a1, 1], [-a2, 0]], by repeated squaring in the
    kernel's order: a list over d of (P00, P01, P10, P11), each entry [ns]
    float32 (or [2, ns], its planes, for complex a)."""
    planes, madd, mul = _arith(a.is_complex())
    lc, lt = _log2(chunk, "chunk"), _log2(threads, "threads")
    ap = planes(a)
    zero = torch.zeros_like(ap[..., 1])
    one = torch.ones_like(zero)
    if a.is_complex():
        one[1] = 0.0
    q = (-ap[..., 1], one, -ap[..., 2], zero)
    out = []
    for i in range(lc + lt):
        if i >= lc:
            out.append(q)
        if i + 1 < lc + lt:
            q = _matmul(madd, mul, q, q)
    return out


def pscan_lane_powers(a, chunk: int, threads: int, powers=None):
    """The lane powers M^(chunk l), l = 0 .. lanes - 1 (lanes =
    min(LANES, threads)): the identity for l = 0, else P of l's lowest set
    bit times P of each higher set bit in turn, from the left (P from
    `powers`, `pscan_powers`' result, where the caller has it).  A tuple
    (Q00, Q01, Q10, Q11) of [ns, lanes] float32 (or [2, ns, lanes])."""
    planes, madd, mul = _arith(a.is_complex())
    pw = pscan_powers(a, chunk, threads) if powers is None else powers
    lanes = min(LANES, threads)
    zero = torch.zeros_like(planes(a)[..., 1])
    one = torch.ones_like(zero)
    if a.is_complex():
        one[1] = 0.0
    out = [(one, zero, zero, one)]
    for lane in range(1, lanes):
        b = (lane & -lane).bit_length() - 1
        m = pw[b]
        for hb in range(b + 1, lanes.bit_length() - 1):
            if lane >> hb & 1:
                m = _matmul(madd, mul, pw[hb], m)
        out.append(m)
    return tuple(torch.stack([m[i] for m in out], -1) for i in range(4))


def iir_pscan_reference(x, b, a, state, chunk: int | None = None,
                        threads: int = THREADS):
    """Plain PyTorch version: the chunked scan of the module docstring on
    [rows, chunks] tensors, tile by tile.  x [R, T], b and a [ns, 3],
    state [R, ns, 2], all float32 or all complex64 -> (y [R, T], state').
    chunk defaults to the kernel's (CHUNK)."""
    cplx = x.is_complex()
    planes, madd, mul = _arith(cplx)
    C = CHUNK[cplx] if chunk is None else chunk
    _log2(C, "chunk")
    lt = _log2(threads, "threads")
    lanes = min(LANES, threads)
    lw = _log2(lanes, "lanes")
    nw = threads // lanes
    R, T = x.shape
    L = C * threads
    ntiles = -(-T // L)
    pw = pscan_powers(a, C, threads)
    lpw = pscan_lane_powers(a, C, threads, pw)
    bp, ap = planes(b), planes(a)
    # per section b0, c1, c2, -a1, -a2, shaped to broadcast over [R, chunks]
    consts = []
    for k in range(b.shape[0]):
        b0, b1, b2, a1, a2 = (t[..., k, i, None, None] for t, i in
                              ((bp, 0), (bp, 1), (bp, 2), (ap, 1), (ap, 2)))
        consts.append((b0, madd(-a1, b0, b1), madd(-a2, b0, b2), -a1, -a2))
    xp = planes(torch.nn.functional.pad(x, (0, ntiles * L - T)))
    xp = xp.reshape(xp.shape[:-1] + (ntiles, threads, C))
    sp = planes(state)
    carry = [(sp[..., k, 0], sp[..., k, 1]) for k in range(b.shape[0])]
    pos = torch.arange(L, device=x.device).reshape(threads, C)

    def combine(e0, e1, cin0, cin1, k):
        """The chunks' true starts from their walks' end states."""
        shape = e0.shape
        w0 = e0.reshape(shape[:-1] + (nw, lanes))
        w1 = e1.reshape(shape[:-1] + (nw, lanes))
        for d in range(lw):                 # in each warp: W
            o = 1 << d
            P = [p[..., k, None, None, None] for p in pw[d]]
            n0, n1 = _apply(madd, P, w0[..., :-o], w1[..., :-o],
                            w0[..., o:], w1[..., o:])
            w0 = torch.cat([w0[..., :o], n0], -1)
            w1 = torch.cat([w1[..., :o], n1], -1)
        g0, g1 = w0[..., -1], w1[..., -1]   # over the warps' totals: G
        for d in range(lt - lw):
            o = 1 << d
            P = [p[..., k, None, None] for p in pw[lw + d]]
            n0, n1 = _apply(madd, P, g0[..., :-o], g1[..., :-o],
                            g0[..., o:], g1[..., o:])
            g0 = torch.cat([g0[..., :o], n0], -1)
            g1 = torch.cat([g1[..., :o], n1], -1)
        # lane l >= 1 of warp w >= 1: W_{l-1} + M^(C l) G_{w-1}
        Q = [q[..., k, None, None, 1:] for q in lpw]
        m0, m1 = _apply(madd, Q, g0[..., :-1, None], g1[..., :-1, None],
                        w0[..., 1:, :-1], w1[..., 1:, :-1])
        s = []
        for cin, g, w_, m in ((cin0, g0, w0, m0), (cin1, g1, w1, m1)):
            lane0 = torch.cat([cin[..., None], g[..., :-1]], -1)[..., None]
            rest = torch.cat([w_[..., :1, :-1], m], -2)
            s.append(torch.cat([lane0, rest], -1).reshape(shape))
        return s

    tiles = []
    for t in range(ntiles):
        n = min(L, T - t * L)
        valid = None if n == L else pos < n               # [threads, C]
        last = (n - 1) // C               # the chunk with the tile's end
        cols = [xp[..., t, :, i] for i in range(C)]       # [R, threads]
        for k, (b0, c1, c2, na1, na2) in enumerate(consts):
            cin0, cin1 = carry[k]

            def step(e0, e1, u, i):
                n0 = madd(na1, e0, madd(c1, u, e1))
                n1 = madd(na2, e0, mul(c2, u))
                if valid is None:
                    return n0, n1
                return (torch.where(valid[:, i], n0, e0),
                        torch.where(valid[:, i], n1, e1))

            # 1. the walk from zero, chunk 0 from the carry
            z = torch.zeros_like(cols[0][..., 1:])
            e0 = torch.cat([cin0[..., None], z], -1)
            e1 = torch.cat([cin1[..., None], z], -1)
            for i in range(C):
                e0, e1 = step(e0, e1, cols[i], i)
            # 2. the combine, in the warps and over them
            s0, s1 = combine(e0, e1, cin0, cin1, k)
            # 3. the re-walk from each chunk's true start, writing y
            for i in range(C):
                u = cols[i]
                yv = madd(b0, u, s0)
                cols[i] = yv if valid is None else torch.where(
                    valid[:, i], yv, u)
                s0, s1 = step(s0, s1, u, i)
            carry[k] = (s0[..., last], s1[..., last])
        tiles.append(torch.stack(cols, -1).flatten(-2))   # [R, L]
    y = torch.cat(tiles, -1)[..., :T] if tiles else planes(x)
    st = torch.stack([torch.stack(c, -1) for c in carry], -2)
    if cplx:
        y, st = torch.complex(y[0], y[1]), torch.complex(st[0], st[1])
    return y.contiguous(), st


def _check(x, b, a, state):
    if x.dim() != 2 or b.dim() != 2 or b.shape[1] != 3 or a.shape != b.shape:
        raise ValueError(f"iir_pscan takes x [R, T] and b, a [ns, 3], got "
                         f"{tuple(x.shape)}, {tuple(b.shape)} and "
                         f"{tuple(a.shape)}")
    ns = b.shape[0]
    if ns < 1:
        raise ValueError("iir_pscan takes at least one section")
    if state.shape != (x.shape[0], ns, 2):
        raise ValueError(f"iir_pscan: state {tuple(state.shape)}, want "
                         f"{(x.shape[0], ns, 2)}")
    if x.dtype not in (torch.float32, torch.complex64) or any(
            t.dtype != x.dtype for t in (b, a, state)):
        raise ValueError(f"iir_pscan takes all float32 or all complex64, "
                         f"got {x.dtype}, {b.dtype}, {a.dtype}, "
                         f"{state.dtype}")
    if any(t.device != x.device for t in (b, a, state)):
        raise ValueError(f"iir_pscan: all tensors must be on one device, "
                         f"got {x.device}, {b.device}, {a.device}, "
                         f"{state.device}")
    if not x.is_contiguous():
        raise ValueError("iir_pscan takes a contiguous x")


def launch_groups(ns: int):
    """The kernel launches of an ns-section cascade on the card, as
    (first, end) section ranges of at most MAX_NS sections."""
    return [(k, min(k + MAX_NS, ns)) for k in range(0, ns, MAX_NS)]


def iir_pscan(x, b, a, state):
    """The biquad cascade b, a [ns, 3] over x [R, T] from the carry state
    [R, ns, 2] (the DF2T states, as `iir_scan`'s), parallel in time:
    returns (y [R, T], state').

    A CUDA tensor launches the kernel once per `launch_groups` entry (and
    counts each launch in ``iir_pscan.launches``); a CPU tensor runs the
    plain version at the kernel's chunk and threads.
    """
    _check(x, b, a, state)
    if x.device.type == "cpu":
        return iir_pscan_reference(x, b, a, state)
    if x.device.type != "cuda":
        raise ValueError(f"iir_pscan runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {x.device}")
    R, T = x.shape
    st = state.clone(memory_format=torch.contiguous_format)
    if R == 0 or T == 0:
        return torch.empty_like(x), st
    groups = launch_groups(b.shape[0])
    from .build import load_library
    lib = load_library()
    v = x
    for k0, k1 in groups:
        y = torch.empty_like(x)
        sk = st if len(groups) == 1 else st[:, k0:k1].contiguous()
        bk, ak = b[k0:k1].contiguous(), a[k0:k1].contiguous()
        with torch.cuda.device(x.device):
            rc = lib.iir_pscan_launch(
                v.data_ptr(), y.data_ptr(), bk.data_ptr(), ak.data_ptr(),
                sk.data_ptr(), R, T, k1 - k0, int(x.is_complex()),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"iir_pscan kernel launch failed: CUDA error "
                               f"{rc}")
        iir_pscan.launches += 1
        if sk is not st:
            st[:, k0:k1] = sk
        v = y
    return v, st


iir_pscan.launches = 0
