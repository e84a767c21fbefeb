"""The inter-block state pass of the block-processed IIR filter: a Hopper
kernel for the JAX package's ``lax.scan`` in
`liquid_dsp_tpu/ops/iir.py:172-181` (inside `iir_apply_block`).  The JAX
package has no Pallas kernel here.

The block form (`ops/iir.py`, `iir_apply_block`) computes a block of L
outputs from two matrix products, and carries only the state from one
block to the next:

    s_pre[r, n] = s;   s = M s + w[r, n]          (n = 0 .. nb-1)

with M = A^L ([p, p]) and w = K u the block inputs' contribution.  The
products around it stay matmuls (XLA computed them outside any kernel).

`iir_block_state` launches the CUDA kernel ``csrc/iir_block_state.cu`` on
a CUDA tensor and runs `iir_block_state_reference`, the same loop in plain
PyTorch, on a CPU tensor; any other device raises.  Per block, in the JAX
package's order (s @ M^T, then + w): acc = s[0]*M[q,0], then
acc += s[j]*M[q,j] for j = 1 .. p-1, then s'[q] = acc + w[q].  Real
filters run on float32 rows (the caller splits a complex stream into its
planes), complex filters on complex64 rows with the kernels' own product
(`iir_scan.plane_ops`).  Both round every operation once in this order,
so on the card the kernel equals the plain version bit for bit.

The kernel gives each state of a row a lane (lane q keeps row q of M and
its state, and gathers the row's states by warp shuffles, which are
exact), so it takes 1 <= p <= 32 states, a warp per row at 32; the wrapper
raises on more.  The plain version takes any p.
"""
from __future__ import annotations

import torch

from .iir_scan import plane_ops

__all__ = ["MAX_P", "iir_block_state", "iir_block_state_reference"]

MAX_P = 32      # states: one lane of a warp each


def iir_block_state_reference(w, m, s):
    """Plain PyTorch version: a loop over the nb blocks on [rows, p]
    tensors.  w [R, nb, p], m [p, p], s [R, p], all float32 or all
    complex64 -> (s_pre [R, nb, p], s')."""
    cplx = w.is_complex()
    mul, add, _ = plane_ops(cplx)

    def planes(t):
        return (t.real, t.imag) if cplx else t

    def pick(v, f):
        return (f(v[0]), f(v[1])) if cplx else f(v)

    ws, ms, sv = planes(w), planes(m), planes(s)
    p = m.shape[0]
    cols = [pick(ms, lambda t, j=j: t[:, j]) for j in range(p)]
    pre = []
    for n in range(w.shape[1]):
        pre.append(torch.complex(*sv) if cplx else sv)
        acc = mul(pick(sv, lambda t: t[:, :1]), cols[0])
        for j in range(1, p):
            acc = add(acc, mul(pick(sv, lambda t, j=j: t[:, j:j + 1]),
                               cols[j]))
        sv = add(acc, pick(ws, lambda t, n=n: t[:, n]))
    s2 = torch.complex(*sv) if cplx else sv
    if not pre:
        return w.new_zeros(w.shape), s.clone()
    return torch.stack(pre, dim=1), s2


def _check(w, m, s):
    if w.dim() != 3 or m.shape != (w.shape[2], w.shape[2]) or \
            s.shape != (w.shape[0], w.shape[2]):
        raise ValueError(f"iir_block_state takes w [R, nb, p], m [p, p] and "
                         f"s [R, p], got {tuple(w.shape)}, {tuple(m.shape)} "
                         f"and {tuple(s.shape)}")
    if w.dtype not in (torch.float32, torch.complex64) or \
            m.dtype != w.dtype or s.dtype != w.dtype:
        raise ValueError(f"iir_block_state takes all float32 or all "
                         f"complex64, got {w.dtype}, {m.dtype}, {s.dtype}")
    if m.device != w.device or s.device != w.device:
        raise ValueError(f"iir_block_state: all tensors must be on one "
                         f"device, got {w.device}, {m.device}, {s.device}")
    if not w.is_contiguous():
        raise ValueError("iir_block_state takes a contiguous w")


def iir_block_state(w, m, s):
    """The states before each block, s_pre [R, nb, p], and the state after
    the last, from w [R, nb, p], M [p, p] and the state s [R, p].

    A CUDA tensor launches the kernel (and counts the launch in
    ``iir_block_state.launches``); a CPU tensor runs the plain version.
    """
    _check(w, m, s)
    if w.device.type == "cpu":
        return iir_block_state_reference(w, m, s)
    if w.device.type != "cuda":
        raise ValueError(f"iir_block_state runs on CUDA (kernel) or CPU "
                         f"(plain version) tensors, got device {w.device}")
    R, nb, p = w.shape
    if not 1 <= p <= MAX_P:
        raise ValueError(f"iir_block_state's kernel takes 1 to {MAX_P} "
                         f"states, got {p}")
    s_pre = torch.empty_like(w)
    s2 = s.clone(memory_format=torch.contiguous_format)
    if R == 0 or nb == 0:
        return s_pre, s2
    m = m.contiguous()
    from .build import load_library
    lib = load_library()
    with torch.cuda.device(w.device):
        rc = lib.iir_block_state_launch(
            w.data_ptr(), m.data_ptr(), s2.data_ptr(), s_pre.data_ptr(), R,
            nb, p, int(w.is_complex()),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"iir_block_state kernel launch failed: CUDA "
                           f"error {rc}")
    iir_block_state.launches += 1
    return s_pre, s2


iir_block_state.launches = 0
