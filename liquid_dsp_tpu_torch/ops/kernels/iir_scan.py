"""The per-sample IIR recurrence, a cascade of transposed direct-form II
sections: a Hopper kernel for the JAX package's ``lax.scan``s in
`liquid_dsp_tpu/ops/iir.py:37-57` (`iir_apply_tf`), `:60-78`
(`iir_apply_sos`) and the shadowing loop of
`liquid_dsp_tpu/ops/channel.py:65-75`.  The JAX package has no Pallas
kernel here; PyTorch has no device-side scan, and a Python loop would
launch a few kernels per sample and section.

`iir_scan` launches the CUDA kernel ``csrc/iir_scan.cu`` on a CUDA tensor
and runs `iir_scan_reference`, the same loop in plain PyTorch, on a CPU
tensor; any other device raises.  Per row and sample, for the sections
k in order (v the input on entry, the output after the last section):

    yk        = b[k,0]*v + s[k,0]
    s[k,i]    = (b[k,i+1]*v - a[k,i+1]*yk) + s[k,i+1]      (i < n-2)
    s[k,n-2]  =  b[k,n-1]*v - a[k,n-1]*yk
    v         = yk

Real coefficients run on float32 rows (the caller splits a complex stream
into its planes); complex coefficients on complex64 rows, each product
taken on the planes as (ar*br - ai*bi, ar*bi + ai*br).  Both versions
round every operation once in this order (the kernel writes them out as
``__fmul_rn`` / ``__fadd_rn`` / ``__fsub_rn``), so on the card the kernel
equals the plain version bit for bit.

The plain version takes any [ns, n].  On the card the kernel holds one
section of 2 to MAX_N (17) coefficients in registers and one of up to
MAX_WIDE_N (4096) in shared memory (its wide form), and 1 to MAX_NS (8)
second-order sections in one launch; the wrapper runs a longer cascade
of second-order sections as launches of at most 8 sections, and a
cascade of wider sections as a launch a section, each on its own slice
of the state and each launch's output the next one's input.  Each
section's arithmetic is unchanged by the split, so the split cascade
equals the plain version bit for bit too.  A section of more than
MAX_WIDE_N coefficients raises ValueError on a CUDA tensor only.
"""
from __future__ import annotations

import torch

__all__ = ["MAX_N", "MAX_NS", "MAX_WIDE_N", "iir_scan",
           "iir_scan_reference", "launch_groups", "plane_ops"]

MAX_N = 17      # coefficients of a section the kernel holds in registers
MAX_NS = 8      # second-order sections in one launch
MAX_WIDE_N = 4096   # coefficients of a section in the wide form (shared)


def plane_ops(cplx: bool):
    """(mul, add, sub) on float tensors, or on complex values held as
    (re, im) pairs of float tensors with the kernels' own product."""
    if not cplx:
        return ((lambda p, q: p * q), (lambda p, q: p + q),
                (lambda p, q: p - q))

    def mul(p, q):
        return (p[0] * q[0] - p[1] * q[1], p[0] * q[1] + p[1] * q[0])

    def add(p, q):
        return (p[0] + q[0], p[1] + q[1])

    def sub(p, q):
        return (p[0] - q[0], p[1] - q[1])

    return mul, add, sub


def _planes(t):
    return (t.real, t.imag) if t.is_complex() else t


def _map(f, v, cplx):
    return (f(v[0]), f(v[1])) if cplx else f(v)


def _cat(vs, cplx, dim=-1):
    if cplx:
        return (torch.cat([v[0] for v in vs], dim),
                torch.cat([v[1] for v in vs], dim))
    return torch.cat(vs, dim)


def iir_scan_reference(x, b, a, state):
    """Plain PyTorch version: a loop over the T samples on [rows] tensors.
    x [R, T], b and a [ns, n], state [R, ns, n-1], all float32 or all
    complex64 -> (y [R, T], state')."""
    cplx = x.is_complex()
    mul, add, sub = plane_ops(cplx)
    ns, n = b.shape
    xs, bs, as_, ss = (_planes(t) for t in (x, b, a, state))
    s = [_map(lambda t, k=k: t[:, k, :], ss, cplx) for k in range(ns)]
    coef = [(_map(lambda t, k=k: t[k, 0], bs, cplx),
             _map(lambda t, k=k: t[k, 1:], bs, cplx),
             _map(lambda t, k=k: t[k, 1:], as_, cplx)) for k in range(ns)]
    outs = []
    for t in range(x.shape[-1]):
        v = _map(lambda u: u[:, t:t + 1], xs, cplx)
        for k, (b0, bk, ak) in enumerate(coef):
            sk = s[k]
            yk = add(mul(b0, v), _map(lambda u: u[:, :1], sk, cplx))
            d = sub(mul(bk, v), mul(ak, yk))
            s[k] = _cat([add(_map(lambda u: u[:, :-1], d, cplx),
                             _map(lambda u: u[:, 1:], sk, cplx)),
                         _map(lambda u: u[:, -1:], d, cplx)], cplx)
            v = yk
        outs.append(v)
    state2 = torch.stack([torch.complex(*sk) if cplx else sk for sk in s],
                         dim=1)
    if not outs:
        return x.new_zeros(x.shape), state2
    y = _cat(outs, cplx)
    return (torch.complex(*y) if cplx else y), state2


def _check(x, b, a, state):
    if x.dim() != 2 or b.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"iir_scan takes x [R, T] and b, a [ns, n], got "
                         f"{tuple(x.shape)}, {tuple(b.shape)} and "
                         f"{tuple(a.shape)}")
    ns, n = b.shape
    if state.shape != (x.shape[0], ns, n - 1):
        raise ValueError(f"iir_scan: state {tuple(state.shape)}, want "
                         f"{(x.shape[0], ns, n - 1)}")
    if x.dtype not in (torch.float32, torch.complex64) or any(
            t.dtype != x.dtype for t in (b, a, state)):
        raise ValueError(f"iir_scan takes all float32 or all complex64, got "
                         f"{x.dtype}, {b.dtype}, {a.dtype}, {state.dtype}")
    if ns < 1 or n < 2:
        raise ValueError(f"iir_scan takes at least one section of at least "
                         f"2 coefficients, got {ns} x {n}")
    if any(t.device != x.device for t in (b, a, state)):
        raise ValueError(f"iir_scan: all tensors must be on one device, got "
                         f"{x.device}, {b.device}, {a.device}, "
                         f"{state.device}")
    if not x.is_contiguous():
        raise ValueError("iir_scan takes a contiguous x")


def launch_groups(ns: int, n: int):
    """The kernel launches of an [ns, n] cascade on the card, as (first,
    end) section ranges: second-order sections by at most MAX_NS, other
    sections one a launch."""
    size = MAX_NS if n == 3 else 1
    return [(k, min(k + size, ns)) for k in range(0, ns, size)]


def iir_scan(x, b, a, state):
    """The DF2T cascade over x [R, T] from the carry state [R, ns, n-1]:
    returns (y [R, T], state').

    A CUDA tensor launches the kernel, once per `launch_groups` entry (and
    counts each launch in ``iir_scan.launches``; a section of more than
    MAX_WIDE_N coefficients raises ValueError there); a CPU tensor runs
    the plain version.
    """
    _check(x, b, a, state)
    if x.device.type == "cpu":
        return iir_scan_reference(x, b, a, state)
    if x.device.type != "cuda":
        raise ValueError(f"iir_scan runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {x.device}")
    R, T = x.shape
    ns, n = b.shape
    if n > MAX_WIDE_N:
        raise ValueError(f"iir_scan's kernel takes sections of up to "
                         f"{MAX_WIDE_N} coefficients on CUDA tensors, got "
                         f"{n}")
    st = state.clone(memory_format=torch.contiguous_format)
    if R == 0 or T == 0:
        return torch.empty_like(x), st
    groups = launch_groups(ns, n)
    from .build import load_library
    lib = load_library()
    v = x
    for k0, k1 in groups:
        y = torch.empty_like(x)
        # one launch's slice of the state, written back after it
        sk = st if len(groups) == 1 else st[:, k0:k1].contiguous()
        bk, ak = b[k0:k1].contiguous(), a[k0:k1].contiguous()
        with torch.cuda.device(x.device):
            rc = lib.iir_scan_launch(
                v.data_ptr(), y.data_ptr(), bk.data_ptr(), ak.data_ptr(),
                sk.data_ptr(), R, T, k1 - k0, n, int(x.is_complex()),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"iir_scan kernel launch failed: CUDA error "
                               f"{rc}")
        iir_scan.launches += 1
        if sk is not st:
            st[:, k0:k1] = sk
        v = y
    return v, st


iir_scan.launches = 0
