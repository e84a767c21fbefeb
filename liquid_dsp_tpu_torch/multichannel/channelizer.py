"""Polyphase filterbank channelizers (`liquid_dsp_tpu/multichannel/
channelizer.py`).

Reference analogs:
  * firpfbch  — src/multichannel/src/firpfbch.c:37-405: maximally
                decimated M-channel analyzer/synthesizer; per-channel
                window + dotprod then M-point (I)FFT (analyzer run at
                :383-405, synthesizer at :314-331).
  * firpfbch2 — src/multichannel/src/firpfbch2.c:36-329: oversampled
                (M/2-sample advance) channelizer, 2x output rate.

Two regimes, chosen when a bank is built:
  * up to `_FUSED_MAX_M` channels the p-tap branch filter and the
    M-point (I)DFT compose into dense matrices (host numpy, registered as
    buffers), and a block is a few real [L, depth*M] x [depth*M, *]
    matmuls over sliding frame windows on (re, im) planes; these banks
    also run natively on planes (`planar.py`: ``forward_planar``);
  * above it the dense DFT factor grows O(M^2), and the banks filter
    each branch along the frame axis and take a batched (I)FFT.
The two regimes' carries differ where the reference's do (the firpfbch2
synthesizer: ``{"e", "o"}`` fused, ``{"w1", "w0"}`` above the limit).

The products are torch.matmul in float32.  The JAX package runs them at
Precision.HIGHEST; ``precision`` is taken for the same signature, and
every value is computed at full float32, so ``HIGH`` gives HIGHEST's
result.  It accepts None, ``HIGH`` and ``HIGHEST`` (a JAX Precision or
its name) and raises on the lower ones, which the port cannot give.
On the card full float32 holds only with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default):
the golden tolerance (2e-4) assumes full float32.

Channel c of the analyzer is the input mixed down by exp(-j*2*pi*c*n/M),
lowpass-filtered by the prototype, and decimated by M (the reference's
equivalence autotest, src/multichannel/tests/firpfbch_crcf_autotest.c).
Analysis output convention: y[..., c, l] = channel c, frame l.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import Proc
from ..design.firdes import firdes_kaiser

__all__ = ["firpfbch_kaiser_taps", "firpfbch_analyzer",
           "firpfbch_synthesizer", "firpfbch2_analyzer",
           "firpfbch2_synthesizer"]

_FUSED_MAX_M = 512   # largest M for the dense fused-matmul formulation


def firpfbch_kaiser_taps(M: int, m: int = 4, as_db: float = 60.0):
    """Prototype lowpass, length 2*M*m+1, cutoff 0.5/M, un-normalized
    (reference firpfbch_crcf_create_kaiser, firpfbch.c:146-177)."""
    return firdes_kaiser(2 * M * m + 1, 0.5 / M, as_db).astype(np.float32)


def _check_precision(precision):
    """None, HIGH or HIGHEST (see the module note); anything else raises."""
    name = getattr(precision, "name", precision)
    if precision is not None and str(name).upper() not in ("HIGH",
                                                           "HIGHEST"):
        raise ValueError(f"precision {precision!r}: the channelizers compute "
                         "at full float32 only (None, HIGH or HIGHEST)")


def _branch_taps(h: np.ndarray, M: int, p: int):
    """Hb[r, q] = h[q*M + r] — polyphase decomposition, p taps/branch."""
    return np.stack([h[r + np.arange(p) * M] for r in range(M)])  # [M, p]


# ---------------------------------------------------------------------------
# shared machinery


def _branch_filter(Hb, carry, u):
    """Filter each branch along the frame axis (the large-M regime).

    u: [..., L, M] (frame-major), Hb: [M, p] real, carry: [..., p-1, M].
    v[l, r] = sum_q Hb[r, q] * up[l + (p-1) - q, r].  Returns (v, carry')."""
    p = Hb.shape[1]
    up = torch.cat([carry, u], dim=-2) if p > 1 else u
    win = up.unfold(-2, p, 1)                      # [..., L, M, p]
    v = torch.einsum("...lmp,mp->...lm", win, Hb.flip(-1).to(u.dtype))
    return v, (_tail(up, p - 1) if p > 1 else carry)


def _frame_windows(upr, upi, L: int, depth: int):
    """Sliding frame windows: up [.., L+depth-1, M] -> [.., L, depth*M]
    with column d*M + m = up[l + d, m] (unfold, then one copy)."""
    lead, M = upr.shape[:-2], upr.shape[-1]

    def win(up):
        return up.unfold(-2, depth, 1).transpose(-1, -2).reshape(
            lead + (L, depth * M))

    return win(upr), win(upi)


def _cmm(wr, wi, Ar, Ai):
    """Complex matmul on planes: (wr + j wi) @ (Ar + j Ai)."""
    return wr @ Ar - wi @ Ai, wr @ Ai + wi @ Ar


def _tail(up, keep: int):
    """Last `keep` frames as a POSITIVE-start slice (keep=0 must return
    an EMPTY slice; `up[..., -0:, :]` would return everything), copied so
    that a carry never holds the whole block's storage."""
    return up[..., up.shape[-2] - keep:, :].clone()


def _complex(x):
    return x if x.is_complex() else x.to(torch.complex64)


def _planes(c):
    c = c.to(torch.complex64)
    return c.real, c.imag


def _register_planes(module: Proc, **mats):
    """Complex host matrices as (re, im) float32 buffers "<key>r", "<key>i"."""
    for key, A in mats.items():
        module._buffer(key + "r", np.ascontiguousarray(A.real, np.float32))
        module._buffer(key + "i", np.ascontiguousarray(A.imag, np.float32))


class _Bank(Proc):
    """A channelizer bank: ``_core`` maps (re, im) input planes and plane
    carries to output planes and new plane carries.  Single-carry banks
    (firpfbch, firpfbch2 analyzer) share `forward` and the planar view;
    the large-M regime overrides `forward` and has no planar view."""

    def __init__(self, name, rate, fused: bool, carry_frames: int, M: int):
        super().__init__(name)
        self.rate = rate
        self.M, self.carry_frames, self.fused = M, carry_frames, fused
        if fused:
            self.forward_planar = self._forward_planes
            self.init_planar = self._init_planes

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        return torch.zeros(tuple(batch_shape) + (self.carry_frames, self.M),
                           dtype=dtype, device=device)

    def _init_planes(self, batch_shape=(), dtype=torch.float32, device=None):
        z = torch.zeros(tuple(batch_shape) + (self.carry_frames, self.M),
                        dtype=torch.float32, device=device)
        return (z, z)

    def forward(self, carry, x):
        x = _complex(x)
        Yr, Yi, cr2, ci2 = self._core(x.real, x.imag, *_planes(carry))
        return torch.complex(Yr, Yi), torch.complex(cr2, ci2)

    def _forward_planes(self, carry, x):
        (r, i), (cr, ci) = x, carry
        Yr, Yi, cr2, ci2 = self._core(r, i, cr.to(r.dtype), ci.to(i.dtype))
        return (Yr, Yi), (cr2, ci2)


# ---------------------------------------------------------------------------
# firpfbch (maximally decimated)


class FirpfbchAnalyzer(_Bank):
    """M-channel maximally-decimated analysis bank (see
    `firpfbch_analyzer`)."""

    def __init__(self, M, h, name):
        h = np.asarray(h)
        p = len(h) // M  # taps per branch (reference p = 2m)
        super().__init__(name, (1, 1), M <= _FUSED_MAX_M, p - 1, M)
        self.p = p
        Hb = _branch_taps(h, M, p)                       # [M, p]
        if not self.fused:
            self._buffer("Hb", Hb)
            return
        cc = np.arange(M)
        F = np.exp(-2j * np.pi * np.outer((M - 1 - cc), np.arange(M)) / M)
        A = np.zeros((p, M, M), np.complex64)
        for c in range(M):
            for q in range(p):
                A[p - 1 - q, c, :] = Hb[c, q] * F[c, :]
        _register_planes(self, A=A.reshape(p * M, M))

    def _check(self, T):
        if T % self.M:
            raise ValueError(f"analyzer block length {T} not a multiple of "
                             f"M={self.M}")
        return T // self.M

    def forward(self, carry, x):
        if self.fused:
            return super().forward(carry, x)
        x = _complex(x)
        L = self._check(x.shape[-1])
        u = x.reshape(x.shape[:-1] + (L, self.M)).flip(-1)  # x[lM + M-1-i]
        v, new_carry = _branch_filter(self.Hb, carry.to(x.dtype), u)
        Y = torch.fft.fft(v.flip(-1), dim=-1)   # X[M-1-i] = v_i (:401-405)
        return Y.transpose(-1, -2).to(torch.complex64), new_carry

    def _core(self, r, i, cr, ci):
        L, p, M = self._check(r.shape[-1]), self.p, self.M
        lead = r.shape[:-1]
        upr = torch.cat([cr, r.reshape(lead + (L, M)).flip(-1)], dim=-2)
        upi = torch.cat([ci, i.reshape(lead + (L, M)).flip(-1)], dim=-2)
        Yr, Yi = _cmm(*_frame_windows(upr, upi, L, p), self.Ar, self.Ai)
        return (Yr.transpose(-1, -2), Yi.transpose(-1, -2),
                _tail(upr, p - 1), _tail(upi, p - 1))


def firpfbch_analyzer(M: int, m: int = 4, as_db: float = 60.0, h=None,
                      precision=None,
                      name: str = "firpfbch_analyzer") -> FirpfbchAnalyzer:
    """M-channel maximally-decimated analysis bank, sample-exact with the
    reference (firpfbch.c _analyzer_execute/_run:346-405).

    Input [..., T] (T % M == 0) -> output [..., M, T//M]; carry
    [..., p-1, M] complex.  Window i's stream u_i[l] = x[l*M + M-1-i] is
    branch-filtered by taps h[i + n*M]; bin (M-1-i) of a forward FFT
    across branches.  Fused form (M <= _FUSED_MAX_M): one [pM, M] matrix
    A[(d, c), b] = Hb[c, p-1-d] * exp(-2j*pi*(M-1-c)*b/M), four real
    matmuls per block.  ``precision``: see the module note (every value
    at full float32; TF32 must be off on the card)."""
    _check_precision(precision)
    if h is None:
        h = firpfbch_kaiser_taps(M, m, as_db)
    return FirpfbchAnalyzer(M, h, name)


class FirpfbchSynthesizer(_Bank):
    """M-channel synthesis bank (see `firpfbch_synthesizer`)."""

    def __init__(self, M, h, name):
        h = np.asarray(h)
        p = len(h) // M
        super().__init__(name, (1, 1), M <= _FUSED_MAX_M, p - 1, M)
        self.p = p
        Hb = _branch_taps(h, M, p)
        if not self.fused:
            self._buffer("Hb", Hb)
            return
        jj = np.arange(M)
        W = np.exp(2j * np.pi * np.outer(jj, jj) / M)     # M * ifft
        S = np.zeros((p, M, M), np.complex64)
        for r in range(M):
            for q in range(p):
                S[p - 1 - q, :, r] += Hb[r, q] * W[:, r]
        _register_planes(self, S=S.reshape(p * M, M))

    def forward(self, carry, X):
        if self.fused:
            return super().forward(carry, X)
        X = _complex(X)
        L = X.shape[-1]
        # unnormalized backward transform across channels
        w = torch.fft.ifft(X.transpose(-2, -1), dim=-1, norm="forward")
        v, new_carry = _branch_filter(self.Hb, carry.to(w.dtype), w)
        return (v.reshape(v.shape[:-2] + (L * self.M,)).to(torch.complex64),
                new_carry)

    def _core(self, Xr, Xi, cr, ci):
        L, p, M = Xr.shape[-1], self.p, self.M
        lead = Xr.shape[:-2]
        ur = torch.cat([cr, Xr.transpose(-2, -1)], dim=-2)
        ui = torch.cat([ci, Xi.transpose(-2, -1)], dim=-2)
        Yr, Yi = _cmm(*_frame_windows(ur, ui, L, p), self.Sr, self.Si)
        return (Yr.reshape(lead + (L * M,)), Yi.reshape(lead + (L * M,)),
                _tail(ur, p - 1), _tail(ui, p - 1))


def firpfbch_synthesizer(M: int, m: int = 4, as_db: float = 60.0, h=None,
                         precision=None,
                         name: str = "firpfbch_synth") -> FirpfbchSynthesizer:
    """M-channel synthesis bank, sample-exact with the reference
    (firpfbch.c _synthesizer_execute:314-331): unnormalized inverse FFT
    across channels, then per-branch filtering.

    Input [..., M, L] -> output [..., L*M].  Fused form: one [pM, M]
    matrix S[(d, j), r] = Hb[r, p-1-d] * exp(2j*pi*j*r/M) over p-frame
    windows of the channel-symbol stream.  The fused carry holds raw
    channel-symbol frames, the large-M carry IFFT-domain frames (both
    [p-1, M] complex).  ``precision``: see the module note."""
    _check_precision(precision)
    if h is None:
        h = firpfbch_kaiser_taps(M, m, as_db)
    return FirpfbchSynthesizer(M, h, name)


# ---------------------------------------------------------------------------
# firpfbch2 (2x oversampled)


def _firpfbch2_branches(M: int, m: int, as_db: float, fc: float):
    """Branch taps G[k, nu] = h[k + nu*M] of the prototype normalized to
    a DC gain of M (reference firpfbch2.c create_kaiser)."""
    h = firdes_kaiser(2 * M * m + 1, fc, as_db)
    h = (h * M / np.sum(h)).astype(np.float32)
    return np.stack([h[k + np.arange(2 * m) * M] for k in range(M)])


class Firpfbch2Analyzer(_Bank):
    """Oversampled analysis channelizer (see `firpfbch2_analyzer`)."""

    def __init__(self, M, m, as_db, name):
        if M % 2:
            raise ValueError("firpfbch2 requires an even number of channels")
        M2, p = M // 2, 2 * m
        # p history frames: the newest p frames of u (both the filter
        # memory and the one-hop lag across block boundaries)
        super().__init__(name, (2, 1), M <= _FUSED_MAX_M, p, M)
        self.p = p
        # the analyzer prototype has twice the synthesizer's bandwidth
        G = _firpfbch2_branches(M, m, as_db, 1.0 / M)
        jj = np.arange(M)
        self._buffer("samp", (M2 - 1 - (jj % M2)) + (jj >= M2) * M2)
        k_odd = (jj - M2) % M
        if not self.fused:
            self._buffer("G", G)
            self._buffer("G_odd", G[k_odd])
            self._buffer("first_half", jj < M2)
            return
        W = np.exp(2j * np.pi * np.outer(jj, jj) / M) / M     # IFFT matrix
        A_even = np.zeros((p + 1, M, M), np.complex64)
        A_odd = np.zeros((p + 1, M, M), np.complex64)
        for j in range(M):
            for q in range(p):
                A_even[p - q - (1 if j >= M2 else 0), j, :] += G[j, q] * W[j, :]
                A_odd[p - q, j, :] += G[k_odd[j], q] * W[j, :]
        # [even | odd] hop columns: one product gives both hops of a frame
        _register_planes(self, A=np.concatenate(
            [A_even.reshape((p + 1) * M, M), A_odd.reshape((p + 1) * M, M)],
            axis=1))

    def _check(self, T):
        if T % self.M:
            raise ValueError(f"firpfbch2 analyzer block length {T} must be "
                             f"a multiple of M={self.M} (even hop count)")
        return T // self.M

    def forward(self, carry, x):
        if self.fused:
            return super().forward(carry, x)
        x = _complex(x)
        L = self._check(x.shape[-1])
        u = x.reshape(x.shape[:-1] + (L, self.M))[..., self.samp]
        hist = carry.to(x.dtype)
        ue_all, _ = _branch_filter(self.G, hist[..., :-1, :],
                                   torch.cat([hist[..., -1:, :], u], dim=-2))
        uo, _ = _branch_filter(self.G_odd, hist[..., 1:, :], u)
        X_even = torch.where(self.first_half, ue_all[..., 1:, :],
                             ue_all[..., :-1, :])
        X = torch.stack([X_even, uo], dim=-2)
        X = X.reshape(X.shape[:-3] + (2 * L, self.M))
        Y = torch.fft.ifft(X, dim=-1)
        new_carry = _tail(torch.cat([hist, u], dim=-2), self.p)
        return Y.transpose(-1, -2).to(torch.complex64), new_carry

    def _core(self, r, i, cr, ci):
        L, p, M = self._check(r.shape[-1]), self.p, self.M
        lead = r.shape[:-1]
        upr = torch.cat([cr, r.reshape(lead + (L, M))[..., self.samp]], -2)
        upi = torch.cat([ci, i.reshape(lead + (L, M))[..., self.samp]], -2)
        Xr, Xi = _cmm(*_frame_windows(upr, upi, L, p + 1), self.Ar, self.Ai)
        # [.., L, even | odd] -> [.., 2L, M]: hops in order
        Yr = Xr.reshape(lead + (2 * L, M))
        Yi = Xi.reshape(lead + (2 * L, M))
        return (Yr.transpose(-1, -2), Yi.transpose(-1, -2),
                _tail(upr, p), _tail(upi, p))


def firpfbch2_analyzer(M: int, m: int = 4, as_db: float = 60.0,
                       precision=None,
                       name: str = "firpfbch2_analyzer") -> Firpfbch2Analyzer:
    """Oversampled analysis channelizer, sample-exact with the reference
    (firpfbch2.c:244-282): M/2-sample hops, alternating window/filter
    alignment, sub-sampled filter bank, inverse FFT scaled by 1/M.

    Input [..., T] (T % M == 0, an even number of hops) -> output
    [..., M, 2*T//M]; carry [..., 2m, M] complex.  Fused form (M <=
    _FUSED_MAX_M): window j's stream u_j[n] = x[n*M + M/2-1-(j mod M/2)
    + (j>=M/2)*M/2]; even hops filter it with branch taps k=j (the
    opposite window half lagged one hop), odd hops with k=(j-M/2) mod M;
    both hops' filters and the IDFT fuse into one [(p+1)M, 2M] matrix
    over (p+1)-frame windows:

        A_even[(d, j), b] = G[j, p-d-(j>=M/2)] * W[j, b] / M,
        A_odd [(d, j), b] = G[(j-M/2) mod M, p-d] * W[j, b] / M.

    ``precision``: see the module note (every value at full float32,
    TF32 off on the card: the golden tolerance is 2e-4)."""
    _check_precision(precision)
    return Firpfbch2Analyzer(M, m, as_db, name)


class Firpfbch2Synthesizer(Proc):
    """Oversampled synthesis channelizer (see `firpfbch2_synthesizer`)."""

    def __init__(self, M, m, as_db, name):
        super().__init__(name)
        if M % 2:
            raise ValueError("firpfbch2 requires an even number of channels")
        self.rate = (1, 2)
        M2, p = M // 2, 2 * m
        self.M, self.p = M, p
        self.fused = M <= _FUSED_MAX_M
        G = _firpfbch2_branches(M, m, as_db, 0.5 / M)
        if not self.fused:
            jj = np.arange(M)
            self._buffer("G", G)
            self._buffer("G_hi", G[(jj + M2) % M])
            return
        self.forward_planar = self._forward_planes
        self.init_planar = self._init_planes
        cc = np.arange(M)
        W2 = np.exp(2j * np.pi * np.outer(cc, cc) / M) / 2.0
        Ae = np.zeros((p + 1, M, M2), np.complex64)   # Xe -> y_even
        Be = np.zeros((p + 1, M, M2), np.complex64)   # Xo -> y_even (lagged)
        Ao = np.zeros((p + 1, M, M2), np.complex64)   # Xo -> y_odd
        Bo = np.zeros((p + 1, M, M2), np.complex64)   # Xe -> y_odd
        for i in range(M2):
            for q in range(p):
                Ae[p - q, :, i] += G[i, q] * W2[:, i]
                Be[p - 1 - q, :, i] += G[i + M2, q] * W2[:, i]
                Ao[p - q, :, i] += G[i, q] * W2[:, i + M2]
                Bo[p - q, :, i] += G[i + M2, q] * W2[:, i + M2]
        n = (p + 1) * M
        # the even-hop windows feed [y_even | y_odd] through [Ae | Bo],
        # the odd-hop windows through [Be | Ao]: y = We @ E + Wo @ O
        planes = {}
        for key, (a, b) in {"E": (Ae, Bo), "O": (Be, Ao)}.items():
            planes[key] = np.concatenate([a.reshape(n, M2), b.reshape(n, M2)],
                                         axis=1)
        _register_planes(self, **planes)

    def init(self, batch_shape=(), dtype=torch.complex64, device=None):
        shape = tuple(batch_shape) + (self.p, self.M)
        if not self.fused:
            return {"w1": torch.zeros(tuple(batch_shape) + (self.p - 1,
                                                            self.M),
                                      dtype=dtype, device=device),
                    "w0": torch.zeros(shape, dtype=dtype, device=device)}
        z = torch.zeros(shape, dtype=dtype, device=device)
        return {"e": z, "o": z}

    def _init_planes(self, batch_shape=(), dtype=torch.float32, device=None):
        z = torch.zeros(tuple(batch_shape) + (self.p, self.M),
                        dtype=torch.float32, device=device)
        return {"er": z, "ei": z, "or": z, "oi": z}

    @staticmethod
    def _frames(nf):
        if nf % 2:
            raise ValueError("firpfbch2 synthesizer needs an even number of "
                             "frames per block")
        return nf // 2

    def forward(self, carry, X):
        X = _complex(X)
        if self.fused:
            (cer, cei), (cor, coi) = _planes(carry["e"]), _planes(carry["o"])
            Yr, Yi, cer, cei, cor, coi = self._core(
                X.real, X.imag, cer, cei, cor, coi)
            return torch.complex(Yr, Yi), {"e": torch.complex(cer, cei),
                                           "o": torch.complex(cor, coi)}
        nf, M, p = X.shape[-1], self.M, self.p
        self._frames(nf)
        M2 = M // 2
        w = torch.fft.ifft(X.transpose(-2, -1), dim=-1) * M2
        w1_in, w0_in = w[..., 0::2, :], w[..., 1::2, :]      # [..., L, M]
        A_lo, c1 = _branch_filter(self.G, carry["w1"].to(w.dtype), w1_in)
        hist0 = carry["w0"].to(w.dtype)
        B_all, _ = _branch_filter(
            self.G_hi, hist0[..., :-1, :],
            torch.cat([hist0[..., -1:, :], w0_in], dim=-2))
        c0 = _tail(torch.cat([hist0, w0_in], dim=-2), p)
        y_even = A_lo[..., :M2] + B_all[..., :-1, :M2]
        y_odd = B_all[..., 1:, M2:] + A_lo[..., M2:]
        y = torch.stack([y_even, y_odd], dim=-2)
        y = y.reshape(y.shape[:-3] + (nf * M2,))
        return y.to(torch.complex64), {"w1": c1, "w0": c0}

    def _forward_planes(self, carry, x):
        Xr, Xi = x
        c = [carry[k].to(Xr.dtype) for k in ("er", "ei", "or", "oi")]
        Yr, Yi, *c2 = self._core(Xr, Xi, *c)
        return (Yr, Yi), dict(zip(("er", "ei", "or", "oi"), c2))

    def _core(self, Xr, Xi, cer, cei, cor, coi):
        nf, p = Xr.shape[-1], self.p
        L = self._frames(nf)
        lead = Xr.shape[:-2]
        Xfr, Xfi = Xr.transpose(-2, -1), Xi.transpose(-2, -1)   # [.., nf, M]
        uer = torch.cat([cer, Xfr[..., 0::2, :]], dim=-2)
        uei = torch.cat([cei, Xfi[..., 0::2, :]], dim=-2)
        uor = torch.cat([cor, Xfr[..., 1::2, :]], dim=-2)
        uoi = torch.cat([coi, Xfi[..., 1::2, :]], dim=-2)
        er, ei = _cmm(*_frame_windows(uer, uei, L, p + 1), self.Er, self.Ei)
        orr, oi = _cmm(*_frame_windows(uor, uoi, L, p + 1), self.Or, self.Oi)
        # [.., L, y_even | y_odd] -> [.., nf*M/2]: hops in order
        Yr = (er + orr).reshape(lead + (nf * self.M // 2,))
        Yi = (ei + oi).reshape(lead + (nf * self.M // 2,))
        return (Yr, Yi, _tail(uer, p), _tail(uei, p), _tail(uor, p),
                _tail(uoi, p))


def firpfbch2_synthesizer(M: int, m: int = 4, as_db: float = 60.0,
                          precision=None,
                          name: str = "firpfbch2_synth"
                          ) -> Firpfbch2Synthesizer:
    """Oversampled synthesis channelizer, sample-exact with the reference
    (firpfbch2.c:287-337): per hop, IFFT of the M channel inputs scaled
    by M/2, pushed into one of two alternating window banks; each output
    sample sums two sub-filter dot products across the banks.

    Input [..., M, nf] (nf even) -> output [..., nf*M/2].  Fused form:
    the per-hop IDFT and the two alternating-bank branch filters compose
    into matrices over (p+1)-frame windows of the even-hop and odd-hop
    channel-symbol streams:

      y_even[n, i] = sum_{q,c} G[i, q]    W2[c, i]    Xe[n-q,   c]
                   + sum_{q,c} G[i+M2, q] W2[c, i]    Xo[n-1-q, c]
      y_odd [n, i] = sum_{q,c} G[i, q]    W2[c, i+M2] Xo[n-q,   c]
                   + sum_{q,c} G[i+M2, q] W2[c, i+M2] Xe[n-q,   c]

    with W2[c, j] = exp(2j*pi*c*j/M)/2.  Carry: the last p raw frames of
    each hop-parity stream, ``{"e", "o"}`` (planar ``{"er", "ei", "or",
    "oi"}``); above _FUSED_MAX_M the IFFT-domain window banks ``{"w1",
    "w0"}``.  ``precision``: see the module note."""
    _check_precision(precision)
    return Firpfbch2Synthesizer(M, m, as_db, name)
