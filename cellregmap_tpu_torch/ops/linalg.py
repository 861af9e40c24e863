"""Small symmetric PSD linear algebra in torch.

Every linear system of the interaction scan is a GLS normal equation or a
Gram, symmetric PSD, so a ridge + Cholesky is the robust path.  The
component-form routines take the entries of a batch of tiny (p+1)^2
systems as separate broadcast-compatible tensors and unroll the
factorization over the static size: every op is elementwise over the batch,
with no trailing small axes and no host synchronisation.
"""
from __future__ import annotations

import torch


def _ridge(A: torch.Tensor, rcond: float) -> torch.Tensor:
    """A + rcond * max(max|diag|, 1) * I, the minimal PD-ification of a
    PSD matrix: keeps collinear normal systems solvable at a relative
    perturbation of ~rcond."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    eps = rcond * torch.clamp(diag.abs().amax(dim=-1), min=1.0)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return A + eps[..., None, None] * eye


def _chol(A: torch.Tensor) -> torch.Tensor:
    # cholesky_ex without error checking: no host sync on the card; a
    # failed factorization shows up as NaN downstream, as in the JAX engine
    return torch.linalg.cholesky_ex(A, check_errors=False)[0]


def sym_pseudo_solve(A: torch.Tensor, b: torch.Tensor,
                     rcond: float = 1e-12) -> torch.Tensor:
    """Robust solve of a symmetric PSD system (ridge + Cholesky)."""
    return torch.cholesky_solve(b, _chol(_ridge(A, rcond)))


def sym_pseudo_logdet(A: torch.Tensor, rcond: float = 1e-12) -> torch.Tensor:
    L = _chol(_ridge(A, rcond))
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(dim=-1)


def unrolled_chol_factor(A_rows, rcond: float = 1e-12):
    """Cholesky factor on component tensors (tiny static dimension).

    ``A_rows[i][j]`` (j <= i) hold the (i, j) entries of a batch of small
    SPD systems.  A ridge of rcond * max(max diag, 1) keeps rank-deficient
    systems solvable.  Returns the lower-triangular factor as a
    list-of-lists of tensors.
    """
    m = len(A_rows)
    diag_max = A_rows[0][0]
    for i in range(1, m):
        diag_max = torch.maximum(diag_max, A_rows[i][i])
    ridge = rcond * torch.clamp(diag_max, min=1.0)

    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = A_rows[i][j]
            if i == j:
                s = s + ridge
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = torch.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    return L


def unrolled_chol_solve(L, b):
    """Solve with a component factor from :func:`unrolled_chol_factor`."""
    m = len(L)
    z = [None] * m
    for i in range(m):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s / L[i][i]
    x = [None] * m
    for i in reversed(range(m)):
        s = z[i]
        for k in range(i + 1, m):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def unrolled_chol_logdet(L):
    return 2.0 * sum(torch.log(L[i][i]) for i in range(len(L)))


def unrolled_chol_solve_logdet(A_rows, b, rcond: float = 1e-12):
    """(solve, logdet) of batched small SPD systems in component form."""
    L = unrolled_chol_factor(A_rows, rcond)
    return unrolled_chol_solve(L, b), unrolled_chol_logdet(L)


def sym_components_full(A_rows):
    """full[i][j] = A_rows[max(i,j)][min(i,j)]."""
    m = len(A_rows)
    return [[A_rows[max(i, j)][min(i, j)] for j in range(m)]
            for i in range(m)]


def sym_components_matvec(A_rows, x):
    """y = A x on symmetric lower components; x, y are component lists."""
    full = sym_components_full(A_rows)
    return [sum(full[i][k] * x[k] for k in range(len(x)))
            for i in range(len(A_rows))]
