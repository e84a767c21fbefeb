"""Dense matrix math and sparse matrices (`liquid_dsp_tpu/utils/matrix.py`).

Reference analog (studied, not copied): reference src/matrix/src/
(matrix.*.c: add/aug/mul/trans/LU/QR/Cholesky/inverse/linsolve/cgsolve/
gramschmidt; smatrix.c sparse bool/float/int).

Thin, explicitly-named wrappers over torch linear algebra with the
reference's conventions (row-major flat arrays in the golden vectors;
Doolittle LU with P*A = L*U; reduced QR; lower Cholesky).  The dense
functions take tensors (processed where they lie) or host arrays (sent to
``device``, the card unless the caller names another, in the JAX
package's 32-bit dtypes); `torch.linalg` stands in for `jnp.linalg`.  No
function here lets a product use TF32: `_mm` switches it off around each
matmul.  `matrix_ludecomp` and `SMatrix` are host numpy, as in the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import entry_tensor, full_f32 as _full_f32

__all__ = [
    "matrix_add", "matrix_sub", "matrix_mul", "matrix_aug",
    "matrix_trans", "matrix_hermitian", "matrix_transmul",
    "matrix_multrans", "matrix_inv", "matrix_linsolve", "matrix_cgsolve",
    "matrix_ludecomp", "matrix_qrdecomp", "matrix_chol",
    "matrix_gramschmidt", "SMatrix",
]


def _mm(a, b):
    with _full_f32():
        return a @ b


def _pair(a, b, device):
    a = entry_tensor(a, device)
    return a, entry_tensor(b, a.device)


def matrix_add(a, b, device="cuda"):
    a, b = _pair(a, b, device)
    return a + b


def matrix_sub(a, b, device="cuda"):
    a, b = _pair(a, b, device)
    return a - b


def matrix_mul(a, b, device="cuda"):
    a, b = _pair(a, b, device)
    return _mm(a, b)


def matrix_aug(a, b, device="cuda"):
    """[A | B] (reference matrixf_aug)."""
    a, b = _pair(a, b, device)
    return torch.cat([a, b], dim=-1)


def matrix_trans(a, device="cuda"):
    return entry_tensor(a, device).transpose(-1, -2)


def matrix_hermitian(a, device="cuda"):
    return torch.conj(matrix_trans(a, device)).resolve_conj()


def matrix_transmul(a, device="cuda"):
    """A^H A (reference matrix_transmul)."""
    a = entry_tensor(a, device)
    return _mm(matrix_hermitian(a), a)


def matrix_multrans(a, device="cuda"):
    """A A^H (reference matrix_multrans)."""
    a = entry_tensor(a, device)
    return _mm(a, matrix_hermitian(a))


def matrix_inv(a, device="cuda"):
    return torch.linalg.inv(entry_tensor(a, device))


def matrix_linsolve(a, b, device="cuda"):
    """Solve A x = b."""
    a, b = _pair(a, b, device)
    return torch.linalg.solve(a, b)


def matrix_cgsolve(a, b, max_iters: int | None = None, tol: float = 1e-6,
                   device="cuda"):
    """Conjugate-gradient solve for symmetric positive definite A
    (reference matrix.cgsolve.c); a fixed 4n iterations unless given, as
    the JAX package (``tol`` is not read there either)."""
    A, b = _pair(a, b, device)
    b = b.reshape(-1)
    n = b.shape[0]
    iters = max_iters or 4 * n
    x = torch.zeros_like(b)
    r = b - _mm(A, x)
    p = r
    rs = torch.vdot(r, r).real
    for _ in range(iters):
        Ap = _mm(A, p)
        alpha = rs / torch.clamp(torch.vdot(p, Ap).real, min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.vdot(r, r).real
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
    return x


def matrix_ludecomp(a):
    """Doolittle LU without pivoting (reference matrix.ludecomp.c):
    A = L U with unit-diagonal L.  Returns (L, U), host numpy computed in
    float64 and returned in the JAX package's 32-bit dtype."""
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else a
    A = np.array(a, dtype=np.result_type(np.asarray(a).dtype, np.float64))
    n = A.shape[0]
    L = np.eye(n, dtype=A.dtype)
    U = np.zeros_like(A)
    for i in range(n):
        for j in range(i, n):
            U[i, j] = A[i, j] - L[i, :i] @ U[:i, j]
        for j in range(i + 1, n):
            L[j, i] = (A[j, i] - L[j, :i] @ U[:i, i]) / U[i, i]
    out = np.complex64 if np.iscomplexobj(A) else np.float32
    return L.astype(out), U.astype(out)


def _sign_fix(d):
    """sign(d) with 0 -> 1 (d real)."""
    s = torch.sign(d)
    return torch.where(s == 0, torch.ones_like(s), s)


def matrix_qrdecomp(a, device="cuda"):
    """Reduced QR (Gram-Schmidt, reference matrix.qrdecomp.c), with R's
    diagonal made non-negative (the reference's sign convention; the same
    fix makes any Householder convention give the same Q and R)."""
    Q, R = torch.linalg.qr(entry_tensor(a, device))
    d = _sign_fix(torch.diagonal(R).real).to(Q.dtype)
    return Q * d[None, :], R * d[:, None]


def matrix_chol(a, device="cuda"):
    """Lower-triangular Cholesky factor (reference matrix.chol.c)."""
    return torch.linalg.cholesky(entry_tensor(a, device))


def matrix_gramschmidt(a, device="cuda"):
    """Orthonormalize the columns of A (reference matrix.gramschmidt.c)."""
    A = entry_tensor(a, device)
    Q, _ = torch.linalg.qr(A)
    # each column's sign follows A's (the reference's normalization)
    d = _sign_fix(torch.sum(torch.conj(Q) * A, dim=0).real).to(Q.dtype)
    return Q * d[None, :]


class SMatrix:
    """Sparse matrix (reference smatrix{b,f,i}): COO-style dict of keys
    with the reference's small API surface."""

    def __init__(self, m: int, n: int, dtype=np.float32):
        self.m = m
        self.n = n
        self.dtype = dtype
        self.data: dict[tuple[int, int], object] = {}

    def set(self, i: int, j: int, v):
        if not (0 <= i < self.m and 0 <= j < self.n):
            raise IndexError("smatrix index out of range")
        if v:
            self.data[(i, j)] = self.dtype(v)
        else:
            self.data.pop((i, j), None)

    def get(self, i: int, j: int):
        return self.data.get((i, j), self.dtype(0))

    def isset(self, i: int, j: int) -> bool:
        return (i, j) in self.data

    def nnz(self) -> int:
        return len(self.data)

    def todense(self) -> np.ndarray:
        out = np.zeros((self.m, self.n), self.dtype)
        for (i, j), v in self.data.items():
            out[i, j] = v
        return out

    def mul(self, other: "SMatrix") -> "SMatrix":
        if self.n != other.m:
            raise ValueError("smatrix dimension mismatch")
        out = SMatrix(self.m, other.n, self.dtype)
        dense = self.todense() @ other.todense()
        for i, j in zip(*np.nonzero(dense)):
            out.set(int(i), int(j), dense[i, j])
        return out

    def vmul(self, x) -> np.ndarray:
        return self.todense() @ np.asarray(x)

    def mulf(self, other: "SMatrix") -> np.ndarray:
        """Multiply treating entries as 0/1 masks over FLOAT values
        (reference smatrixb_mulf: boolean structure, float arithmetic)."""
        if self.n != other.m:
            raise ValueError("smatrix dimension mismatch")
        return (self.todense().astype(np.float32) @
                other.todense().astype(np.float32))

    def vmulf(self, x) -> np.ndarray:
        """Boolean-structure x float-vector product (reference
        smatrixb_vmulf)."""
        return self.todense().astype(np.float32) @ np.asarray(x, np.float32)
