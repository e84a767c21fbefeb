"""Parks-McClellan (Remez exchange) equiripple FIR design (host-side
NumPy, float64), ported line for line from
`liquid_dsp_tpu.design.firdespm` (reference src/filter/src/
firdespm.c:115-798): a Remez exchange on a dense frequency grid for
linear-phase type-I/II filters, multi-band with per-band weights and
weighting functions."""
from __future__ import annotations

import numpy as np

__all__ = ["firdespm", "firdespm_lowpass"]


def _remez_exchange(n_coef: int, grid: np.ndarray, des: np.ndarray,
                    wt: np.ndarray, n_iter: int = 40, tol: float = 1e-6):
    """Solve the weighted Chebyshev approximation on the grid.

    n_coef: number of cosine basis functions (r = n_coef), approximating
    H(f) = sum_{k=0}^{r-1} a_k cos(2 pi k f).
    Returns H evaluated on the grid's extremal cosine polynomial.
    """
    r = n_coef
    ngrid = len(grid)
    # initial extremal guess: uniformly spaced grid points
    ext = np.linspace(0, ngrid - 1, r + 1).astype(int)
    x_grid = np.cos(2 * np.pi * grid)
    delta = 0.0
    for _ in range(n_iter):
        xe = x_grid[ext]
        de = des[ext]
        we = wt[ext]
        # barycentric weights over extremal points
        b = np.ones(r + 1)
        for k in range(r + 1):
            diff = xe[k] - np.delete(xe, k)
            # product in log-space for robustness
            b[k] = 1.0 / np.prod(np.where(np.abs(diff) < 1e-30,
                                          1e-30, diff))
        sgn = (-1.0) ** np.arange(r + 1)
        den = np.dot(b, sgn / we)
        if not np.isfinite(den) or abs(den) < 1e-300 or \
                not np.isfinite(np.dot(b, de)):
            # degenerate extremal set (coincident points from degenerate
            # band specs): rotate the set by one grid point and retry
            # instead of dividing by ~0 and propagating inf/NaN
            ext = np.unique((ext + 1) % ngrid)
            while len(ext) < r + 1:
                ext = np.unique(np.append(ext, (ext[-1] + 1) % ngrid))
            ext = np.sort(ext[: r + 1])
            continue
        delta = np.dot(b, de) / den
        # polynomial values at extremal points (desired -+ delta/w)
        ye = de - sgn * delta / we
        # evaluate on the whole grid via barycentric interpolation over
        # the first r extremal points
        xk = xe[:r]
        yk = ye[:r]
        bk = np.ones(r)
        for k in range(r):
            diff = xk[k] - np.delete(xk, k)
            bk[k] = 1.0 / np.prod(np.where(np.abs(diff) < 1e-30,
                                           1e-30, diff))
        H = np.empty(ngrid)
        for i in range(ngrid):
            dx = x_grid[i] - xk
            hit = np.argmin(np.abs(dx))
            if np.abs(dx[hit]) < 1e-12:
                H[i] = yk[hit]
            else:
                c = bk / dx
                den = np.sum(c)
                H[i] = np.dot(c, yk) / den if abs(den) > 1e-300 else \
                    yk[hit]
        # error and new extrema (NaNs — e.g. from a barycentric node
        # collision — must not poison the sign comparisons below)
        err = wt * (des - H)
        err = np.where(np.isfinite(err), err, 0.0)
        # find local extrema of |err|
        cand = [0]
        for i in range(1, ngrid - 1):
            if (err[i] - err[i - 1]) * (err[i + 1] - err[i]) <= 0:
                cand.append(i)
        cand.append(ngrid - 1)
        cand = np.asarray(sorted(set(cand)))
        # keep the r+1 with alternating signs and largest magnitude
        # simple selection: sort candidates by |err| descending, enforce
        # alternation by a sweep
        mags = np.abs(err[cand])
        order = cand[np.argsort(-mags)]
        chosen = []
        for idx in sorted(order.tolist()):
            if not chosen:
                chosen.append(idx)
            elif np.sign(err[idx]) != np.sign(err[chosen[-1]]):
                chosen.append(idx)
            elif np.abs(err[idx]) > np.abs(err[chosen[-1]]):
                chosen[-1] = idx
        while len(chosen) > r + 1:
            # drop the smallest-magnitude endpoint
            if np.abs(err[chosen[0]]) < np.abs(err[chosen[-1]]):
                chosen.pop(0)
            else:
                chosen.pop()
        if len(chosen) < r + 1:
            # refill from remaining largest candidates
            extra = [c for c in order.tolist() if c not in chosen]
            chosen = sorted(set(chosen + extra[: r + 1 - len(chosen)]))
        if len(chosen) < r + 1:
            # still short (e.g. degenerate single-point bands): pad with
            # uniformly spaced unused grid points so the barycentric
            # system stays full-rank
            unused = [i for i in
                      np.linspace(0, ngrid - 1, 2 * (r + 1)).astype(int)
                      if i not in chosen]
            chosen = sorted(set(chosen + unused[: r + 1 - len(chosen)]))
        new_ext = np.asarray(sorted(chosen[: r + 1]))
        if len(new_ext) == len(ext) and np.array_equal(new_ext, ext):
            ext = new_ext
            break
        ext = new_ext
    return H, delta


def firdespm(h_len: int, bands, des, weights=None,
             grid_density: int = 16, wtype=None) -> np.ndarray:
    """Design a linear-phase equiripple FIR filter.

    bands: list of (f_lo, f_hi) pairs with f in [0, 0.5]; a degenerate
    pair (f, f) pins a single grid point (reference hM3.c band layout);
    des: desired amplitude per band; weights: per-band weight;
    wtype: per-band weighting function, 'flat' | 'exp' | 'lin'
    (reference firdespm.c:405-416: exp = e^{2 j df}, lin = 1 + 2.7 j df
    over the in-band grid index j).
    (reference firdespm_run, firdespm.c:115)
    """
    bands = np.asarray(bands, np.float64).reshape(-1, 2)
    des = np.asarray(des, np.float64)
    if weights is None:
        weights = np.ones(len(bands))
    weights = np.asarray(weights, np.float64)
    if wtype is None:
        wtype = ["flat"] * len(bands)
    if len(des) != len(bands) or len(weights) != len(bands) or \
            len(wtype) != len(bands):
        raise ValueError("bands, des, weights must have equal length")
    if np.any(bands < 0) or np.any(bands > 0.5):
        raise ValueError("band edges must lie in [0, 0.5]")
    if np.any(bands[:, 1] < bands[:, 0]):
        raise ValueError("each band must satisfy f_lo <= f_hi")
    if h_len < 3:
        raise ValueError("filter length must be at least 3")
    odd = h_len % 2
    r = (h_len + 1) // 2 if odd else h_len // 2  # cosine basis size
    # dense grid over the bands
    grid, gdes, gwt = [], [], []
    for (lo, hi), d, w, wt in zip(bands, des, weights, wtype):
        if hi <= lo:
            grid.append(np.asarray([lo]))
            gdes.append(np.asarray([d]))
            gwt.append(np.asarray([w]))
            continue
        npts = max(int((hi - lo) * 2 * grid_density * r), 8)
        f = np.linspace(lo, hi, npts)
        df = f[1] - f[0]
        j = np.arange(npts)
        if wt == "exp":
            fw = np.exp(2.0 * j * df)
        elif wt == "lin":
            fw = 1.0 + 2.7 * j * df
        elif wt == "flat":
            fw = np.ones(npts)
        else:
            raise ValueError(f"unknown weighting type {wt!r}")
        grid.append(f)
        gdes.append(np.full(npts, d))
        gwt.append(np.full(npts, w) * fw)
    grid = np.concatenate(grid)
    gdes = np.concatenate(gdes)
    gwt = np.concatenate(gwt)
    if not odd:
        # type-II: factor out cos(pi f); basis reduces by the envelope
        c = np.cos(np.pi * grid)
        c = np.where(np.abs(c) < 1e-9, 1e-9, c)
        gdes = gdes / c
        gwt = gwt * np.abs(c)
    H, delta = _remez_exchange(r, grid, gdes, gwt)
    # recover coefficients a_k from H samples: least-squares on the
    # cosine basis (overdetermined, numerically robust)
    basis = np.cos(2 * np.pi * np.outer(grid, np.arange(r)))
    a, *_ = np.linalg.lstsq(basis, H, rcond=None)
    if odd:
        M = (h_len - 1) // 2
        h = np.zeros(h_len)
        h[M] = a[0]
        for k in range(1, r):
            h[M + k] = a[k] / 2
            h[M - k] = a[k] / 2
    else:
        # type-II reconstruction: sample G(f) = H(f)*cos(pi f) with the
        # linear-phase factor and inverse-DFT (robust against the
        # direct b_k -> h mapping's edge cases)
        nfft = 1024
        f = np.arange(nfft // 2 + 1) / nfft
        basis_f = np.cos(2 * np.pi * np.outer(f, np.arange(r)))
        Hf = basis_f @ a * np.cos(np.pi * f)
        full = np.zeros(nfft, complex)
        ph = np.exp(-2j * np.pi * f * (h_len - 1) / 2)
        full[: nfft // 2 + 1] = Hf * ph
        full[nfft // 2 + 1:] = np.conj(full[1: nfft // 2][::-1])
        ht = np.fft.ifft(full).real
        return ht[:h_len].astype(np.float64)
    return h.astype(np.float64)


def firdespm_lowpass(h_len: int, fc: float, as_db: float = 60.0,
                     mu: float = 0.0) -> np.ndarray:
    """Equiripple lowpass helper (reference firdespm_lowpass): transition
    band sized from the Kaiser estimate."""
    from .firdes import estimate_req_filter_df
    df = estimate_req_filter_df(as_db, h_len)
    f_stop = min(fc + df, 0.495)
    # weight stopband by the attenuation ratio
    k = 10.0 ** (as_db / 20.0)
    return firdespm(h_len, [(0.0, fc), (f_stop, 0.5)], [1.0, 0.0],
                    [1.0, k / 10.0])
