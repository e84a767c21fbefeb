"""The Viterbi add-compare-select recurrence and its traceback for Hopper:
the card's form of the two `lax.scan`s of
`liquid_dsp_tpu/fec/device.py:conv_soft_decoder` (lines 171-271).  The
JAX package has no Pallas kernel here, and PyTorch has no scan that
stays on the device: a Python loop over the trellis would launch a dozen
small kernels per step, some 550 steps per codeword block.

`viterbi_acs` launches the CUDA kernel ``csrc/viterbi_acs.cu`` on a CUDA
tensor and runs `viterbi_acs_reference`, the same computation in plain
PyTorch, on a CPU tensor; any other device raises.

What both compute, per codeword n (obs [N, T, r] depunctured metrics,
exp [ns, 2, r] the trellis's expected +-1 outputs, half = ns/2):

  * pm = -1e9 for every state except pm[0] = 0 (never -inf: the early
    steps' exact ties must fall as in the JAX package);
  * per step t and next state s' (predecessors p0 = s' >> 1 and
    p1 = p0 + half, input bit b = s' & 1):
      bm_i = sum over streams k in index order of exp[p_i, b, k]*obs[t, k]
      cand_i = pm[p_i] + bm_i
      j[t, s'] = cand1 > cand0          (strict: a tie takes p0)
      pm'[s'] = max(cand0, cand1) - (max over states of that max);
  * traceback from state 0: bit[t] = s & 1, s <- (s >> 1) + j[t, s]*half;
    the first `nout` bits are the output.

Every product is by +-1, so exact, and the kernel takes the sums, the
max and the subtraction in this order: kernel and plain version give the
same bits and the same decisions.  The decisions are packed one bit per
state into int32 words, bit (s & 31) of word (s >> 5) of step t
(`tests/test_torch_kernel_identities.py` walks this layout and the
traceback's read of it); ``decisions=True`` returns them [N, T, ns/32].

The kernel decodes one codeword per warp for 64 <= ns <= 256 (every
scheme the decoders launch: a lane holds ns/32 states, no block barrier)
and one per thread block for ns of 32, 512 and 1024.
"""
from __future__ import annotations

import torch

__all__ = ["viterbi_acs", "viterbi_acs_reference", "dec_smem_max", "NEG"]

NEG = -1e9          # the start metric of every state but 0
_STREAMS = (2, 3)   # r: the rate-1/2 and rate-1/3 codes (K <= 9)


def _branch(exp: torch.Tensor):
    """(p0, p1, e0 [ns, r], e1 [ns, r]): each next state's predecessors
    and the expected outputs on its two incoming branches."""
    ns = exp.shape[0]
    s = torch.arange(ns, device=exp.device)
    p0 = s >> 1
    p1 = p0 + (ns >> 1)
    b = s & 1
    return p0, p1, exp[p0, b], exp[p1, b]


def _pack(j: torch.Tensor) -> torch.Tensor:
    """[..., ns] bool -> [..., ns/32] int32 words, bit (s & 31) of word
    (s >> 5) set where j[s]."""
    w = (torch.ones(32, dtype=torch.int64, device=j.device)
         << torch.arange(32, device=j.device))
    words = (j.reshape(j.shape[:-1] + (-1, 32)).to(torch.int64) * w).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def viterbi_acs_reference(obs: torch.Tensor, exp: torch.Tensor, nout: int,
                          decisions: bool = False):
    """Plain PyTorch version: a loop of torch ops over the T steps,
    batched over the N codewords.  Returns bits [N, nout] int32 (and the
    packed decisions [N, T, ns/32] int32 with ``decisions``)."""
    N, T, r = obs.shape
    ns = exp.shape[0]
    half = ns >> 1
    p0, p1, e0, e1 = _branch(exp)
    pm = torch.full((N, ns), NEG, dtype=torch.float32, device=obs.device)
    pm[:, 0] = 0.0
    js = torch.empty(T, N, ns, dtype=torch.bool, device=obs.device)
    for t in range(T):
        o = obs[:, t]                                     # [N, r]
        bm0 = e0[:, 0] * o[:, :1]
        bm1 = e1[:, 0] * o[:, :1]
        for k in range(1, r):
            bm0 = bm0 + e0[:, k] * o[:, k:k + 1]
            bm1 = bm1 + e1[:, k] * o[:, k:k + 1]
        c0 = pm[:, p0] + bm0
        c1 = pm[:, p1] + bm1
        js[t] = c1 > c0
        m = torch.maximum(c0, c1)
        pm = m - m.amax(dim=1, keepdim=True)
    bits = torch.empty(N, T, dtype=torch.int32, device=obs.device)
    state = torch.zeros(N, 1, dtype=torch.int64, device=obs.device)
    for t in range(T - 1, -1, -1):
        jt = torch.gather(js[t], 1, state).to(torch.int64)
        bits[:, t] = (state & 1)[:, 0].to(torch.int32)
        state = (state >> 1) + jt * half
    bits = bits[:, :nout].contiguous()
    if decisions:
        return bits, _pack(js.permute(1, 0, 2))
    return bits


def _check(obs, exp, nout):
    if obs.dim() != 3 or exp.dim() != 3 or exp.shape[1] != 2 \
            or exp.shape[2] != obs.shape[2]:
        raise ValueError(f"viterbi_acs takes obs [N, T, r] and exp "
                         f"[ns, 2, r], got {tuple(obs.shape)} and "
                         f"{tuple(exp.shape)}")
    ns, r = exp.shape[0], exp.shape[2]
    if r not in _STREAMS or ns & (ns - 1) or not 32 <= ns <= 1024:
        raise ValueError(f"viterbi_acs takes r in {_STREAMS} and a power "
                         f"of two 32 <= ns <= 1024, got r={r}, ns={ns}")
    if not 0 <= nout <= obs.shape[1]:
        raise ValueError(f"nout {nout} outside [0, T={obs.shape[1]}]")
    if obs.dtype != torch.float32 or exp.dtype != torch.float32:
        raise ValueError(f"obs and exp must be float32, got {obs.dtype} "
                         f"and {exp.dtype}")
    if obs.device != exp.device:
        raise ValueError(f"viterbi_acs: obs and exp must be on one device, "
                         f"got {obs.device} and {exp.device}")


def dec_smem_max() -> int:
    """The most decision bytes (T * ns / 8) the kernel keeps in shared
    memory for one codeword, as ``csrc/viterbi_acs.cu`` sets it (builds
    and loads the kernel library)."""
    from .build import load_library
    return load_library().viterbi_acs_dec_smem_max()


def viterbi_acs(obs: torch.Tensor, exp: torch.Tensor, nout: int,
                decisions: bool = False):
    """Soft Viterbi decode of N codewords: obs [N, T, r] float32
    depunctured metrics (positive = bit 1), exp [ns, 2, r] float32 +-1.
    Returns bits [N, nout] int32 (and with ``decisions`` the packed
    decisions [N, T, ns/32] int32).  The kernel keeps a codeword's
    decisions in shared memory up to the kernel's limit
    (`dec_smem_max`), else (and with ``decisions``) in a buffer in device
    memory.

    A CUDA tensor launches the kernel (and counts the launch in
    ``viterbi_acs.launches``); a CPU tensor runs the plain version.
    """
    _check(obs, exp, nout)
    if obs.device.type == "cpu":
        return viterbi_acs_reference(obs, exp, nout, decisions)
    if obs.device.type != "cuda":
        raise ValueError(f"viterbi_acs runs on CUDA (kernel) or CPU (plain "
                         f"version) tensors, got device {obs.device}")
    N, T, r = obs.shape
    ns = exp.shape[0]
    bits = torch.empty(N, nout, dtype=torch.int32, device=obs.device)
    dec = (torch.empty(N, T, ns // 32, dtype=torch.int32, device=obs.device)
           if decisions or (N and T * ns // 8 > dec_smem_max()) else None)
    if N and T:
        from .build import load_library
        lib = load_library()
        obs, exp = obs.contiguous(), exp.contiguous()
        with torch.cuda.device(obs.device):
            rc = lib.viterbi_acs_launch(
                obs.data_ptr(), exp.data_ptr(), bits.data_ptr(),
                None if dec is None else dec.data_ptr(), N, T, r, ns, nout,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"viterbi_acs kernel launch failed: CUDA "
                               f"error {rc}")
        viterbi_acs.launches += 1
    return (bits, dec) if decisions else bits


viterbi_acs.launches = 0
