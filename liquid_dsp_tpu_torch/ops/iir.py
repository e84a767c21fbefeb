"""IIR filtering (`liquid_dsp_tpu/ops/iir.py`): transposed direct-form II
filters and second-order-section cascades as block processors.

Reference analogs:
  * iirfilt    — src/filter/src/iirfilt.c:49+ (DF2T with nb/na taps, or a
                 cascade of second-order sections chosen at create).
  * iirfiltsos — src/filter/src/iirfiltsos.c (one biquad, the PLL loop
                 filter).

Three backends compute the same filter, and their carries are the same
stacked DF2T state, so a carry moves between them unchanged:

  * ``scan``: the per-sample recurrence, `ops/kernels/iir_scan.py` (the
    CUDA kernel on the card, its plain version on the CPU);
  * ``block``: exact block state-space processing.  Per block of L
    samples the outputs are ``Th @ u + Obs @ s`` (the Toeplitz matrix of
    the impulse response, the zero-input response) and the state moves
    on as ``s' = A^L s + K u``; the products are matmuls with TF32 off
    (the JAX package pins HIGHEST), the state pass from block to block is
    `ops/kernels/iir_block_state.py`;
  * ``pscan`` (second-order sections only): each section's update as an
    affine map evaluated parallel in time, chunks walked, their end states
    combined by a scan over the chunks, then walked again from their true
    starts, `ops/kernels/iir_pscan.py` (the CUDA kernel on the card, its
    plain version on the CPU).

``auto`` picks per call by the input tensor's device: a CPU tensor takes
``scan`` (as the JAX package's ``auto`` does on the CPU); a CUDA tensor
takes ``block`` for a stable filter of at most 32 states and ``scan``
otherwise.  An unstable filter (A^L not representable) takes ``scan``
under ``auto`` and ``block``; ``pscan`` stays ``pscan`` there, as in the
JAX package (its powers of the section's matrix may overflow).  An
explicit ``block`` on a stable filter of more than 32 states runs on the
CPU (the state pass's plain version takes any order) and raises
ValueError on a CUDA tensor, at the call (the state pass's kernel gives
each state a lane of one warp), where the JAX package's block form takes
any order.  The scan takes any order on either device
(`ops/kernels/iir_scan.py`), ``pscan`` any cascade
(`ops/kernels/iir_pscan.py`); `iirfilt` refuses ``pscan`` (ValueError,
SOS-only), as the JAX package does.  A Proc keeps both parameter sets as
buffers where the JAX package keeps both, so one module runs on either
device.

Real coefficients filter each float plane of a complex stream on its own
(`planar_per_plane`); complex coefficients run on complex64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import Proc, planar_per_plane
# a module name of its own: chip_smoke.py's TF32 control swaps it
from ..core import full_f32 as _full_f32
from .kernels.iir_block_state import MAX_P as BLOCK_MAX_P
from .kernels.iir_block_state import iir_block_state
from .kernels.iir_pscan import iir_pscan
from .kernels.iir_scan import iir_scan

__all__ = ["iirfilt", "iirfilt_sos", "IIRFilt", "iir_apply_tf",
           "iir_apply_sos", "iir_apply_block", "iir_apply_sos_pscan",
           "iir_freqresponse", "iir_group_delay", "iirfilt_integrator",
           "iirfilt_differentiator", "iirfilt_dc_blocker", "iirfilt_pll"]

BLOCK_SIZE = 128


def _norm_ba(b, a):
    b = np.atleast_1d(np.asarray(b))
    a = np.atleast_1d(np.asarray(a))
    b = b / a[0]
    a = a / a[0]
    return b, a


def _work_dtype(*ts):
    return (torch.complex64 if any(t.is_complex() for t in ts)
            else torch.float32)


def _scan(bs, as_, state, x, kernel=None):
    """The DF2T cascade bs/as_ [ns, n] over x [..., T] from state
    [..., ns, n-1] on `iir_scan` (or `iir_pscan`, n = 3); real
    coefficients on a complex stream run on its two planes."""
    kernel = iir_scan if kernel is None else kernel
    batch, T = x.shape[:-1], x.shape[-1]
    ns, n = bs.shape
    if x.is_complex() and not bs.is_complex():
        xp = torch.stack([x.real, x.imag]).reshape(-1, T)
        sp = torch.stack([state.real, state.imag]).reshape(-1, ns, n - 1)
        y, s = kernel(xp.contiguous(), bs, as_, sp)
        R = y.shape[0] // 2
        y = torch.complex(y[:R], y[R:])
        s = torch.complex(s[:R], s[R:])
    else:
        y, s = kernel(x.reshape(-1, T).contiguous(), bs, as_,
                      state.reshape(-1, ns, n - 1))
    return y.reshape(batch + (T,)), s.reshape(batch + (ns, n - 1))


def _cascade(B, A, carry, x, kernel=None):
    """`_scan` with the stream and carry in the working type and real
    coefficients kept real, so that a complex stream runs as its planes."""
    dt, cf = _work_dtype(B, A, x), _work_dtype(B, A)
    return _scan(B.to(cf), A.to(cf), carry.to(dt), x.to(dt), kernel=kernel)


def iir_apply_tf(b, a, carry, x):
    """One block of DF2T IIR filtering; carry = internal state [..., n-1].

    y[t] = b0*x[t] + s0;  s_i = b_{i+1} x - a_{i+1} y + s_{i+1}
    (transposed direct form II, reference iirfilt.c)."""
    n = max(b.shape[-1], a.shape[-1])
    bp = torch.nn.functional.pad(b, (0, n - b.shape[-1]))
    ap = torch.nn.functional.pad(a, (0, n - a.shape[-1]))
    y, s = _cascade(bp[None], ap[None], carry[..., None, :], x)
    return y, s[..., 0, :]


def iir_apply_sos(B, A, carry, x):
    """Cascade of biquads; B, A: [n_sections, 3]; carry: [..., ns, 2]."""
    return _cascade(B, A, carry, x)


def _df2t_ss(b, a):
    """DF2T state-space realization in float64/complex128:
    s' = A s + Bv x,  y = s[0] + D x  (C = e0).

    The state vector IS the DF2T internal state of `iir_apply_tf`, so
    carries are value-compatible across the scan and block backends."""
    n = max(len(b), len(a))
    dt = np.complex128 if (np.iscomplexobj(b) or np.iscomplexobj(a)) \
        else np.float64
    bp = np.zeros(n, dt)
    ap = np.zeros(n, dt)
    bp[:len(b)] = b
    ap[:len(a)] = a
    p = n - 1
    A = np.zeros((p, p), dt)
    A[:, 0] = -ap[1:]
    A[np.arange(p - 1), np.arange(1, p)] = 1.0
    Bv = bp[1:] - ap[1:] * bp[0]
    C = np.zeros(p, dt)
    C[0] = 1.0
    return A, Bv, C, dt(bp[0])


def _ss_cascade(sections):
    """Series-compose state-space systems; the composite state is the
    CONCATENATION of the per-section states (so an SOS cascade's block
    carry is exactly the stacked per-section DF2T states)."""
    A1, B1, C1, D1 = sections[0]
    for A2, B2, C2, D2 in sections[1:]:
        p1, p2 = A1.shape[0], A2.shape[0]
        dt = np.result_type(A1, A2)
        A = np.zeros((p1 + p2, p1 + p2), dt)
        A[:p1, :p1] = A1
        A[p1:, p1:] = A2
        A[p1:, :p1] = np.outer(B2, C1)
        B1 = np.concatenate([B1, B2 * D1])
        C1 = np.concatenate([C1 * D2, C2])
        A1, D1 = A, D1 * D2
    return A1, B1, C1, D1


def _block_mats(A, Bv, C, D, L):
    """The exact block-processing operators for one L-block, in float64
    on the host, cast to float32/complex64 at the end:
    y = Th @ u + Obs @ s0 (the intra-block Toeplitz matrix of the impulse
    response plus the zero-input response), s' = A^L s0 + K @ u."""
    p = A.shape[0]
    Apow = np.empty((L + 1, p, p), A.dtype)
    Apow[0] = np.eye(p, dtype=A.dtype)
    for k in range(1, L + 1):
        Apow[k] = Apow[k - 1] @ A
    h = np.empty(L, A.dtype)
    h[0] = D
    if L > 1:
        h[1:] = np.einsum("j,ijk,k->i", C, Apow[:L - 1], Bv)
    ii, kk = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    Th = np.where(ii >= kk, h[np.clip(ii - kk, 0, L - 1)], 0.0)
    Obs = np.einsum("j,ijk->ik", C, Apow[:L])              # [L, p]
    K = np.einsum("ijk,k->ji", Apow[L - 1::-1], Bv)        # [p, L]
    cplx = np.iscomplexobj(A)
    cast = (lambda m: np.asarray(m, np.complex64 if cplx else np.float32))
    return {"Th": cast(Th), "Obs": cast(Obs), "K": cast(K),
            "Apow": cast(Apow)}


def _block_rows(Th, Obs, K, Apow, x, s):
    """Block processing of rows x [R, T] from states s [R, p]."""
    L, p = Obs.shape
    R, T = x.shape
    nb, r = divmod(T, L)
    outs = []
    with _full_f32():
        if nb:
            xb = x[:, :nb * L].reshape(R, nb, L)
            w = torch.matmul(xb, K.mT)                         # [R, nb, p]
            s_pre, s = iir_block_state(w.contiguous(), Apow[L],
                                       s.contiguous())
            yb = torch.matmul(xb, Th.mT) + torch.matmul(s_pre, Obs.mT)
            outs.append(yb.reshape(R, nb * L))
        if r:
            xr = x[:, nb * L:]
            outs.append(torch.matmul(xr, Th[:r, :r].mT)
                        + torch.matmul(s, Obs[:r].mT))
            s = (torch.matmul(s, Apow[r].mT)
                 + torch.matmul(xr, K[:, L - r:].mT))
    if not outs:
        return x.new_zeros(x.shape), s
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)), s


def iir_apply_block(params, carry, x):
    """Exact block-processed IIR (see the module docstring): params holds
    "Th", "Obs", "K" and "Apow" (`_block_mats`), carry the DF2T state
    [..., p] (or [..., ns, 2] for a cascade: the same values).  Real
    matrices on a complex stream run on its two planes."""
    Th, Obs, K, Apow = (params[k] for k in ("Th", "Obs", "K", "Apow"))
    p = Obs.shape[1]
    batch, T = x.shape[:-1], x.shape[-1]
    dt = _work_dtype(Th, x)
    x, s = x.to(dt), carry.to(dt).reshape(-1, p)
    if dt.is_complex and not Th.is_complex():
        xp = torch.stack([x.real, x.imag]).reshape(-1, T)
        y, s = _block_rows(Th, Obs, K, Apow, xp,
                           torch.cat([s.real, s.imag]))
        R = y.shape[0] // 2
        y, s = torch.complex(y[:R], y[R:]), torch.complex(s[:R], s[R:])
    else:
        y, s = _block_rows(Th, Obs, K, Apow, x.reshape(-1, T), s)
    return y.reshape(batch + (T,)), s.reshape(carry.shape)


def _resolve_iir_backend(backend: str, A) -> str:
    """'auto' stays unresolved until the call (the input's device picks);
    unstable systems (spectral radius > ~1) take scan under 'auto' and
    'block': A^L is not representable.  'block' above BLOCK_MAX_P (32)
    states is refused at the call, on CUDA tensors only
    (`IIRFilt.forward`).  'pscan' stays 'pscan' for an unstable filter,
    as in the JAX package."""
    if backend not in ("auto", "scan", "block", "pscan"):
        raise ValueError(f"unknown iir backend {backend!r}")
    if backend != "pscan" and not _iir_stable(A):
        return "scan"
    return backend


def _iir_stable(A) -> bool:
    return (A.shape[0] == 0
            or np.abs(np.linalg.eigvals(A)).max() <= 1.0 + 1e-9)


class IIRFilt(Proc):
    """IIR filter over blocks (reference iirfilt_crcf): the transfer-
    function form (`iirfilt`, buffers "b", "a", carry [..., n-1]) or a
    cascade of second-order sections (`iirfilt_sos`, buffers "B", "A",
    carry [..., ns, 2]), with the block form's "Th", "Obs", "K", "Apow"
    where the backend may take it ("B" and "A" alone under 'pscan').  The
    buffers are the JAX package's params under the same names."""

    def __init__(self, coef, ss, sos: bool, name: str, backend: str,
                 block_size: int):
        super().__init__(name)
        self.sos = sos
        self.backend = _resolve_iir_backend(backend, ss[0])
        keys = ("B", "A") if sos else ("b", "a")
        names = []
        if self.backend in ("auto", "scan", "pscan"):
            for k, c in zip(keys, coef):
                self._buffer(k, c)
            names += keys
        if self.backend in ("auto", "block"):
            for k, m in _block_mats(*ss, block_size).items():
                self._buffer(k, m)
            names += ["Th", "Obs", "K", "Apow"]
        self.param_spec = {k: k for k in names}
        self.p = int(ss[0].shape[0])
        self.state_shape = ((coef[0].shape[0], 2) if sos
                            else (max(len(coef[0]), len(coef[1])) - 1,))
        self.cplx = any(np.iscomplexobj(c) for c in coef)
        if not self.cplx:
            self.forward_planar, self.init_planar = planar_per_plane(
                self.forward, self.init)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(tuple(batch_shape) + self.state_shape,
                           dtype=dtype, device=device)

    def uses_block(self, x) -> bool:
        """Whether a call on x takes the block form."""
        return self.backend == "block" or (
            self.backend == "auto" and x.device.type == "cuda"
            and self.p <= BLOCK_MAX_P)

    def forward(self, carry, x):
        dt = (torch.complex64 if self.cplx or x.is_complex()
              else torch.float32)
        if carry.is_complex() and not dt.is_complex:
            carry = carry.real
        x, carry = x.to(dt), carry.to(dt)
        if self.uses_block(x):
            if x.device.type == "cuda" and self.p > BLOCK_MAX_P:
                raise ValueError(
                    f"iir backend 'block' takes at most {BLOCK_MAX_P} states "
                    f"on CUDA tensors (the iir_block_state kernel's limit: a "
                    f"lane a state), got {self.p}; use 'auto' or 'scan' there")
            return iir_apply_block({k: getattr(self, k) for k in
                                    ("Th", "Obs", "K", "Apow")}, carry, x)
        if self.backend == "pscan":
            return iir_apply_sos_pscan(self.B, self.A, carry, x)
        if self.sos:
            return iir_apply_sos(self.B, self.A, carry, x)
        return iir_apply_tf(self.b, self.a, carry, x)


def iirfilt(b, a, name: str = "iirfilt", backend: str = "auto",
            block_size: int = BLOCK_SIZE) -> IIRFilt:
    """IIR filter from transfer-function coefficients (reference
    iirfilt_crcf_create); backend 'scan', 'block' or 'auto' (module
    docstring)."""
    if backend == "pscan":
        raise ValueError("pscan backend is SOS-only (iirfilt_sos)")
    b, a = _norm_ba(b, a)
    cplx = np.iscomplexobj(b) or np.iscomplexobj(a)
    dt = np.complex64 if cplx else np.float32
    return IIRFilt((b.astype(dt), a.astype(dt)), _df2t_ss(b, a), False,
                   name, backend, block_size)


def iir_apply_sos_pscan(B, A, carry, x):
    """Cascade of biquads evaluated parallel in time (`iir_pscan`: the
    kernel on the card, its plain version on the CPU); B, A: [n_sections,
    3]; carry: [..., ns, 2], the scan's convention.  Real coefficients stay
    real, so a complex stream runs as its two float planes."""
    return _cascade(B, A, carry, x, kernel=iir_pscan)


def iirfilt_sos(B, A, name: str = "iirfilt_sos", backend: str = "auto",
                block_size: int = BLOCK_SIZE) -> IIRFilt:
    """IIR filter as a second-order-section cascade (reference
    iirfilt_crcf_create_sos); B, A: [n_sections, 3] with A[:,0] = 1.  The
    block form composes the cascade; its carry stays the stacked
    per-section DF2T states.  backend 'scan', 'block', 'pscan' or 'auto'
    (module docstring)."""
    B = np.atleast_2d(np.asarray(B, np.float32))
    A = np.atleast_2d(np.asarray(A, np.float32))
    A0 = A[:, :1]
    B = B / A0
    A = A / A0
    ns = B.shape[0]
    cplx = np.iscomplexobj(B) or np.iscomplexobj(A)
    wide = np.complex128 if cplx else np.float64
    ss = _ss_cascade([_df2t_ss(np.asarray(B[k], wide), np.asarray(A[k], wide))
                      for k in range(ns)])
    dt = np.complex64 if cplx else np.float32
    return IIRFilt((B.astype(dt), A.astype(dt)), ss, True, name, backend,
                   block_size)


def iir_freqresponse(b, a, fc):
    """H(e^{j 2 pi fc}) for transfer-function coefficients."""
    b = np.atleast_1d(b)
    a = np.atleast_1d(a)
    z = np.exp(-2j * np.pi * np.asarray(fc))  # z := z^-1
    num = sum(bk * z ** k for k, bk in enumerate(b))
    den = sum(ak * z ** k for k, ak in enumerate(a))
    return num / den


def iir_group_delay(b, a, fc, df: float = 1e-4):
    """Group delay via the numerical phase derivative (reference
    group_delay.c iir_group_delay)."""
    h1 = iir_freqresponse(b, a, fc - df / 2)
    h2 = iir_freqresponse(b, a, fc + df / 2)
    dphi = np.angle(h2 * np.conj(h1))
    return -dphi / (2 * np.pi * df)


# ---------------------------------------------------------------------------
# factory constructors (reference iirfilt.c:264-411)


def _pintelon_sos(mags_z, args_z, mags_p, args_p, k):
    """Digital zpk (magnitude / angle in degrees, as published in
    [Pintelon:1990]) -> SOS arrays via design.iirdes.zpk2sos."""
    from ..design.iirdes import zpk2sos
    z = np.asarray(mags_z) * np.exp(1j * np.deg2rad(np.asarray(args_z)))
    p = np.asarray(mags_p) * np.exp(1j * np.deg2rad(np.asarray(args_p)))
    return zpk2sos(z, p, k)


def iirfilt_integrator(name: str = "iirfilt_integrator") -> IIRFilt:
    """8th-order digital integrator, [Pintelon:1990] Table II constants
    (reference iirfilt_xxx_create_integrator, iirfilt.c:264-310)."""
    B, A = _pintelon_sos(
        [1.175839, 3.371020, 3.371020, 4.549710, 4.549710,
         5.223966, 5.223966, 5.443743],
        [180.0, -125.1125, 125.1125, -80.96404, 80.96404,
         -40.09347, 40.09347, 0.0],
        [0.5805235, 0.2332021, 0.2332021, 0.1814755, 0.1814755,
         0.1641457, 0.1641457, 1.0],
        [180.0, -114.0968, 114.0968, -66.33969, 66.33969,
         -21.89539, 21.89539, 0.0],
        -1.89213380759321e-05)
    return iirfilt_sos(B, A, name=name)


def iirfilt_differentiator(name: str = "iirfilt_differentiator") -> IIRFilt:
    """8th-order digital differentiator, [Pintelon:1990] Table IV
    constants (reference iirfilt.c:313-359)."""
    B, A = _pintelon_sos(
        [1.702575, 5.877385, 5.877385, 4.197421, 4.197421,
         5.350284, 5.350284, 1.0],
        [180.0, -221.4063, 221.4063, -144.5972, 144.5972,
         -66.88802, 66.88802, 0.0],
        [0.8476936, 0.2990781, 0.2990781, 0.2232427, 0.2232427,
         0.1958670, 0.1958670, 0.1886088],
        [180.0, -125.5188, 125.5188, -81.52326, 81.52326,
         -40.51510, 40.51510, 0.0],
        2.09049284907492e-05)
    return iirfilt_sos(B, A, name=name)


def iirfilt_dc_blocker(alpha: float,
                       name: str = "iirfilt_dc_blocker") -> IIRFilt:
    """First-order DC-blocking filter H(z) = (1 - z^-1)/(1 - (1-a)z^-1)
    (reference iirfilt.c:366-376)."""
    if not (0.0 < alpha < 1.0):
        raise ValueError("alpha must be in (0, 1)")
    b = np.array([1.0, -1.0], np.float32)
    a = np.array([1.0, -1.0 + alpha], np.float32)
    return iirfilt(b, a, name=name)


def iirfilt_pll(w: float, zeta: float = 0.7071, K: float = 1000.0,
                name: str = "iirfilt_pll") -> IIRFilt:
    """Phase-locked-loop loop filter: one active-lag second-order section
    (reference iirfilt.c:382-411)."""
    if not (0.0 < w < 1.0):
        raise ValueError("bandwidth must be in (0, 1)")
    if not (0.0 < zeta < 1.0):
        raise ValueError("damping factor must be in (0, 1)")
    if K <= 0.0:
        raise ValueError("loop gain must be positive")
    from ..design.iirdes import iirdes_pll_active_lag
    b, a = iirdes_pll_active_lag(w, zeta, K)
    return iirfilt_sos(b[None, :], a[None, :], name=name)
