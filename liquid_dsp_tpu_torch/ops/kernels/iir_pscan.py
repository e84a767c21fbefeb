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
chunks of ``chunk`` samples; per tile, for each section in turn:

1. the walk: chunk j runs the map over its samples from the zero state
   (chunk 0 from the tile's carry), giving its end state e_j;
2. the combine: an inclusive Kogge-Stone scan over the chunks, for
   d = 0 .. log2(threads) - 1 and every j >= 2^d at once,
   e_j <- P_d e_{j - 2^d} + e_j with P_d = M^(chunk * 2^d), so that e_j
   becomes the state at the end of chunk j;
3. the re-walk: chunk j runs the map again from its true start state (the
   tile's carry for chunk 0, e_{j-1} for the others) and writes y, which
   the next section takes as its input.  The tile's carry for the next
   tile is the re-walk's end state of the chunk that holds the tile's last
   sample.

The powers come from repeated squaring in float32 (Q_0 = M,
Q_{i+1} = Q_i Q_i, an entry Q[r][0] Q[0][c] + Q[r][1] Q[1][c]), and
P_d = Q_{log2(chunk) + d}.  Every operation is rounded once, in this
order: a step is s0' = (-a1) s0 + (s1 + c1 x), s1' = (-a2) s0 + c2 x (and
y = b0 x + s0 in the re-walk), a combine (P[i][0] f0 + P[i][1] f1) + e_i;
complex values multiply on their planes as (ar br - ai bi, ar bi + ai br).
The kernel writes the same operations out
(``__fmul_rn`` / ``__fadd_rn`` / ``__fsub_rn``) with the same chunk, tile
and combine order, so on the card it equals the plain version bit for
bit.

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

__all__ = ["CHUNK", "MAX_NS", "THREADS", "iir_pscan", "iir_pscan_reference",
           "launch_groups", "pscan_powers"]

THREADS = 1024                  # chunks of a tile: the kernel's threads
CHUNK = {False: 16, True: 8}    # samples of a chunk, real and complex rows
MAX_NS = 64                     # sections in one launch


def _log2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"iir_pscan: {what} must be a power of two, got {n}")
    return n.bit_length() - 1


def _arith(cplx: bool):
    """(planes, mul): a tensor as its values (float32) or as a leading
    axis of its two float planes (complex64), and the product of two such,
    on the planes as the kernel takes it; sums and differences of planes
    are the tensors' own."""
    if not cplx:
        return (lambda t: t), (lambda p, q: p * q)

    def mul(p, q):
        return torch.stack([p[0] * q[0] - p[1] * q[1],
                            p[0] * q[1] + p[1] * q[0]])

    return (lambda t: torch.view_as_real(t).movedim(-1, 0)), mul


def pscan_powers(a, chunk: int, threads: int):
    """P_d = M^(chunk * 2^d) for d = 0 .. log2(threads) - 1 of each
    section's M = [[-a1, 1], [-a2, 0]], by repeated squaring in the
    kernel's order: a list over d of (P00, P01, P10, P11), each entry [ns]
    float32 (or [2, ns], its planes, for complex a)."""
    planes, mul = _arith(a.is_complex())
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
            q00, q01, q10, q11 = q
            q = (mul(q00, q00) + mul(q01, q10), mul(q00, q01) + mul(q01, q11),
                 mul(q10, q00) + mul(q11, q10), mul(q10, q01) + mul(q11, q11))
    return out


def iir_pscan_reference(x, b, a, state, chunk: int | None = None,
                        threads: int = THREADS):
    """Plain PyTorch version: the chunked scan of the module docstring on
    [rows, chunks] tensors, tile by tile.  x [R, T], b and a [ns, 3],
    state [R, ns, 2], all float32 or all complex64 -> (y [R, T], state').
    chunk defaults to the kernel's (CHUNK)."""
    cplx = x.is_complex()
    planes, mul = _arith(cplx)
    C = CHUNK[cplx] if chunk is None else chunk
    _log2(C, "chunk")
    lt = _log2(threads, "threads")
    R, T = x.shape
    L = C * threads
    ntiles = -(-T // L)
    pw = pscan_powers(a, C, threads)
    bp, ap = planes(b), planes(a)
    # per section b0, c1, c2, -a1, -a2, shaped to broadcast over [R, chunks]
    consts = []
    for k in range(b.shape[0]):
        b0, b1, b2, a1, a2 = (t[..., k, i, None, None] for t, i in
                              ((bp, 0), (bp, 1), (bp, 2), (ap, 1), (ap, 2)))
        consts.append((b0, b1 - mul(a1, b0), b2 - mul(a2, b0), -a1, -a2))
    xp = planes(torch.nn.functional.pad(x, (0, ntiles * L - T)))
    xp = xp.reshape(xp.shape[:-1] + (ntiles, threads, C))
    sp = planes(state)
    carry = [(sp[..., k, 0], sp[..., k, 1]) for k in range(b.shape[0])]
    pos = torch.arange(L, device=x.device).reshape(threads, C)
    tiles = []
    for t in range(ntiles):
        n = min(L, T - t * L)
        valid = pos < n                                   # [threads, C]
        last = (n - 1) // C               # the chunk with the tile's end
        cols = [xp[..., t, :, i] for i in range(C)]       # [R, threads]
        for k, (b0, c1, c2, na1, na2) in enumerate(consts):
            cin0, cin1 = carry[k]

            def step(e0, e1, u, m):
                return (torch.where(m, mul(na1, e0) + (e1 + mul(c1, u)), e0),
                        torch.where(m, mul(na2, e0) + mul(c2, u), e1))

            # 1. the walk from zero, chunk 0 from the carry
            z = torch.zeros_like(cols[0][..., 1:])
            e0 = torch.cat([cin0[..., None], z], -1)
            e1 = torch.cat([cin1[..., None], z], -1)
            for i in range(C):
                e0, e1 = step(e0, e1, cols[i], valid[:, i])
            # 2. the combine: Kogge-Stone with P_d = M^(C 2^d)
            for d in range(lt):
                o = 1 << d
                p00, p01, p10, p11 = (p[..., k, None, None] for p in pw[d])
                f0, f1 = e0[..., :-o], e1[..., :-o]
                e0 = torch.cat([e0[..., :o], (mul(p00, f0) + mul(p01, f1))
                                + e0[..., o:]], -1)
                e1 = torch.cat([e1[..., :o], (mul(p10, f0) + mul(p11, f1))
                                + e1[..., o:]], -1)
            # 3. the re-walk from each chunk's true start, writing y
            s0 = torch.cat([cin0[..., None], e0[..., :-1]], -1)
            s1 = torch.cat([cin1[..., None], e1[..., :-1]], -1)
            for i in range(C):
                u = cols[i]
                cols[i] = mul(b0, u) + s0
                s0, s1 = step(s0, s1, u, valid[:, i])
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
