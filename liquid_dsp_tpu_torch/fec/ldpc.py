"""LDPC belief-propagation (sum-product) decoding (`liquid_dsp_tpu/fec/
ldpc.py`): the code construction, the systematic encoder and the
one-codeword decoder as host numpy, as in the JAX package; the batched
decoder (`ldpc_decoder_device`) on torch.

Reference analog (studied, not copied): reference src/fec/src/
sumproduct.c — internal iterative sum-product message passing over a
sparse parity-check matrix (used experimentally by the reference; not
exposed as a fec scheme).

Implementation: log-domain min-sum/sum-product over a dense or sparse
H, vectorized with numpy; returns hard decisions and a parity-satisfied
flag.  The batched decoder's iterations and its decisions run in
`ops/kernels/ldpc_bp.py`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import entry_device
from ..ops.kernels.ldpc_bp import compact_maps, ldpc_bp

__all__ = ["ldpc_sumproduct_decode", "ldpc_encode_systematic",
           "make_regular_ldpc", "ldpc_decoder_device"]


def make_regular_ldpc(n: int, k: int, col_weight: int = 3,
                      seed: int = 0) -> np.ndarray:
    """Random regular-ish parity-check matrix H [(n-k), n] (for tests and
    experimentation; the reference also generates its H internally)."""
    m = n - k
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        rows = rng.choice(m, size=min(col_weight, m), replace=False)
        H[rows, j] = 1
    # ensure no empty rows
    for i in range(m):
        if H[i].sum() == 0:
            H[i, rng.integers(0, n)] = 1
    return H


def ldpc_encode_systematic(H: np.ndarray, msg_bits: np.ndarray):
    """Systematic encode via Gaussian elimination: returns (codeword,
    column permutation) with codeword[perm] ordered as [parity | msg]."""
    H = np.asarray(H, np.uint8) % 2
    m, n = H.shape
    k = n - m
    A = H.copy()
    perm = np.arange(n)
    row = 0
    for col in range(n):
        if row >= m:
            break
        sel = None
        for r in range(row, m):
            if A[r, col]:
                sel = r
                break
        if sel is None:
            continue
        A[[row, sel]] = A[[sel, row]]
        for r in range(m):
            if r != row and A[r, col]:
                A[r] ^= A[row]
        # move pivot column into position `row`
        if col != row:
            A[:, [row, col]] = A[:, [col, row]]
            perm[[row, col]] = perm[[col, row]]
        row += 1
    if row < m:
        raise ValueError("parity-check matrix is rank deficient")
    # A = [I_m | P]; parity = P @ msg
    P = A[:, m:]
    msg_bits = np.asarray(msg_bits, np.uint8) % 2
    if len(msg_bits) != k:
        raise ValueError(f"expected {k} message bits")
    parity = (P @ msg_bits) % 2
    cw_perm = np.concatenate([parity, msg_bits]).astype(np.uint8)
    # un-permute into the original column order
    cw = np.zeros(n, np.uint8)
    cw[perm] = cw_perm
    return cw, perm


def ldpc_sumproduct_decode(H: np.ndarray, llr: np.ndarray,
                           max_iters: int = 50, min_sum: bool = False):
    """Decode soft inputs; llr[i] > 0 means bit i likely 0 (standard
    convention).  Returns (hard_bits, parity_ok, iterations)."""
    H = np.asarray(H, np.uint8)
    m, n = H.shape
    llr = np.asarray(llr, np.float64)
    rows, cols = np.nonzero(H)
    # messages on edges
    Lq = llr[cols].copy()          # variable -> check
    Lr = np.zeros_like(Lq)         # check -> variable
    for it in range(1, max_iters + 1):
        # check update: per row, combine incoming Lq
        for r in range(m):
            e = rows == r
            v = Lq[e]
            if min_sum:
                sgn = np.sign(v)
                sprod = np.prod(sgn) * sgn
                mags = np.abs(v)
                # min excluding self
                order = np.argsort(mags)
                m1 = mags[order[0]]
                m2 = mags[order[1]] if len(mags) > 1 else m1
                mins = np.where(np.arange(len(v)) == order[0], m2, m1)
                Lr[e] = sprod * mins
            else:
                t = np.tanh(np.clip(v / 2, -19, 19))
                prod = np.prod(t)
                with np.errstate(divide="ignore"):
                    ratio = prod / np.where(t == 0, 1e-30, t)
                Lr[e] = 2 * np.arctanh(np.clip(ratio, -1 + 1e-12,
                                               1 - 1e-12))
        # variable update
        post = llr.copy()
        np.add.at(post, cols, Lr)
        Lq = post[cols] - Lr
        hard = (post < 0).astype(np.uint8)
        if not ((H @ hard) % 2).any():
            return hard, True, it
    return hard, False, max_iters


def _slot_maps(H: np.ndarray):
    """The JAX decoder's slot layout (`liquid_dsp_tpu/fec/ldpc.py:
    150-173`): edge e is check slot (rows[e], cslot[e]) and variable slot
    (cols[e], vslot[e]); the flat maps' pad entries point one past the
    end.  Returns (m, n, wr, wc, c2v, v2c, cvar, cw), cw the weight of H
    at each check slot (0 on pads) for the exact syndrome."""
    m, n = H.shape
    rows, cols = np.nonzero(H)
    E = len(rows)
    wr = int(np.bincount(rows, minlength=m).max()) if E else 1
    wc = int(np.bincount(cols, minlength=n).max()) if E else 1
    cslot = np.zeros(E, np.int64)
    vslot = np.zeros(E, np.int64)
    rc = np.zeros(m, np.int64)
    vc = np.zeros(n, np.int64)
    for e in range(E):
        cslot[e] = rc[rows[e]]
        rc[rows[e]] += 1
        vslot[e] = vc[cols[e]]
        vc[cols[e]] += 1
    c2v = np.full(m * wr, n * wc, np.int64)
    v2c = np.full(n * wc, m * wr, np.int64)
    c2v[rows * wr + cslot] = cols * wc + vslot
    v2c[cols * wc + vslot] = rows * wr + cslot
    cvar = np.full(m * wr, n, np.int64)
    cvar[rows * wr + cslot] = cols
    cw = np.zeros(m * wr, np.int64)
    cw[rows * wr + cslot] = H[rows, cols]
    return m, n, wr, wc, c2v, v2c, cvar, cw


class _LDPCDecoder:
    """decode_fn of `ldpc_decoder_device`: the slot maps and the kernel's
    maps of the real edges (`compact_maps`) live on each device they are
    used on, made once (the first call on a device other than the
    decoder's own copies them there once, never per call)."""

    def __init__(self, H, max_iters: int, min_sum: bool, device):
        H = np.asarray(H, np.uint8)
        (self.m, self.n, self.wr, self.wc, c2v, v2c, cvar,
         cw) = _slot_maps(H)
        # the kernel's index maps are int32; the syndrome's weights int64
        self._host = [torch.from_numpy(a.astype(np.int32))
                      for a in (c2v, v2c, cvar)] + [torch.from_numpy(cw)]
        self._compact = tuple(torch.from_numpy(a) for a in compact_maps(
            c2v, v2c, cvar, self.m, self.n, self.wr, self.wc))
        self.max_iters = int(max_iters)
        self.min_sum = bool(min_sum)
        self.device = entry_device(device)
        self._maps = {}
        self._on(self.device)

    def _on(self, dev):
        """[c2v, v2c, cvar, cw, compact maps] on `dev`."""
        key = str(dev)
        if key not in self._maps:
            self._maps[key] = [a.to(dev) for a in self._host] + [
                tuple(a.to(dev) for a in self._compact)]
        return self._maps[key]

    def __call__(self, llr):
        """llr [..., n] (> 0 means bit 0) -> (hard [..., n] int32,
        parity_ok [...] bool) after max_iters iterations.  A tensor is
        decoded where it lies; a host array on the decoder's device."""
        if not torch.is_tensor(llr):
            llr = torch.from_numpy(np.ascontiguousarray(
                llr, np.float32)).to(self.device)
        llr = llr.to(torch.float32)
        m, n, wr, wc = self.m, self.n, self.wr, self.wc
        if llr.shape[-1] != n:
            raise ValueError(f"ldpc decoder takes llr [..., {n}], got "
                             f"{tuple(llr.shape)}")
        c2v, v2c, cvar, cw, cmaps = self._on(llr.device)
        batch = llr.shape[:-1]
        # the iterations, the decisions and the exact integer syndrome:
        # one kernel launch on the card
        hard, ok = ldpc_bp(llr.reshape(-1, n), c2v, v2c, cvar, m, n, wr, wc,
                           self.max_iters, self.min_sum, cw, cmaps)
        return hard.reshape(*batch, n), ok.reshape(batch)


def ldpc_decoder_device(H, max_iters: int = 50, min_sum: bool = False,
                        device="cuda"):
    """A BATCHED belief-propagation decoder for H on torch: the JAX
    package's `ldpc_decoder_device` (`liquid_dsp_tpu/fec/ldpc.py:123-251`)
    with the same formulation and constants.

    Returns decode_fn(llr [..., n] float, llr > 0 = bit 0) ->
    (hard [..., n] int32, parity_ok [...] bool) after max_iters fixed
    iterations (no early exit, as the JAX ``lax.scan``).

    Messages live in dense padded slot arrays, check-side [.., m, wr_max]
    and variable-side [.., n, wc_max], joined by flat index maps (one
    gather each way an iteration) that are built once here as tensors on
    ``device`` (the card unless given; without one a CUDA device raises).
    Pad slots carry the neutral element (38.0 for sum-product, inf for
    min-sum; a weight-1 check's min-sum message is capped at 1e6), the
    tanh product runs in the log domain with the sign from the parity of
    negative counts and SAT = 1 - 1e-7 in float32.  The final syndrome is
    an exact integer sum, so no matmul precision setting can reach it.
    The iterations (the JAX decoder's ``lax.scan``), the posterior, the
    decisions and the syndrome are one launch of the `ops/kernels/
    ldpc_bp.py` kernel on the card (over the real edges only, the maps of
    `compact_maps` made here once), and its plain version on the CPU.
    """
    return _LDPCDecoder(H, max_iters, min_sum, device)
