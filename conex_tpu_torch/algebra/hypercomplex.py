"""Hypercomplex matrix algebras: real, complex, quaternion, octonion.

Twin of ``conex_tpu/algebra/hypercomplex.py``.  A matrix over a division
algebra of dimension d in {1, 2, 4, 8} is a tensor (..., d, n, n): the
reference's "vector of real matrices" (jordan_matrix_algebra.h:8) as a
stacked axis.  The 8x8 sign and index tables of the octonion basis
(jordan_matrix_algebra.cc:106-122) give a constant (d, d, d) structure
tensor T; one algebra product is the d^2 real matrix products x_i y_j in
one batched matmul, then their signed sums through T.

For the associative algebras (d <= 4) the faithful real representation
R(X) (dn x dn) turns spectral questions into ordinary real linear algebra:
eigenvalues of the algebra element appear with multiplicity d.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# The 8x8 sign table M and index table of the octonion (Cayley) basis;
# upper-left d x d blocks give the complex/quaternion subalgebras.
# reference: jordan_matrix_algebra.cc:106-122.
_SIGNS = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 1],
        [1, -1, -1, 1, -1, 1, 1, -1],
        [1, 1, -1, -1, -1, -1, 1, 1],
        [1, -1, 1, -1, -1, 1, -1, 1],
        [1, 1, 1, 1, -1, -1, -1, -1],
        [1, -1, 1, -1, 1, -1, 1, -1],
        [1, -1, -1, 1, 1, -1, -1, 1],
        [1, 1, -1, -1, 1, 1, -1, -1],
    ],
    dtype=np.float64,
)
_INDEX = np.array(
    [
        [0, 1, 2, 3, 4, 5, 6, 7],
        [1, 0, 3, 2, 5, 4, 7, 6],
        [2, 3, 0, 1, 6, 7, 4, 5],
        [3, 2, 1, 0, 7, 6, 5, 4],
        [4, 5, 6, 7, 0, 1, 2, 3],
        [5, 4, 7, 6, 1, 0, 3, 2],
        [6, 7, 4, 5, 2, 3, 0, 1],
        [7, 6, 5, 4, 3, 2, 1, 0],
    ],
    dtype=np.int64,
)


@functools.lru_cache(maxsize=None)
def structure_tensor(d: int) -> np.ndarray:
    """T[i, j, k] = sign(e_i e_j) if e_i e_j = +/- e_k else 0."""
    if d not in (1, 2, 4, 8):
        raise ValueError("division algebra dimension must be 1, 2, 4, or 8")
    T = np.zeros((d, d, d))
    for i in range(d):
        for j in range(d):
            k = _INDEX[i, j]
            if k < d:
                T[i, j, k] = _SIGNS[i, j]
    return T


_TENSORS = {}


def _constant(name, d, dtype, device):
    """A constant of the algebra as a tensor, made once per (d, dtype,
    device): the structure tensor, or the conjugation signs."""
    key = (name, d, dtype, torch.device(device))
    t = _TENSORS.get(key)
    if t is None:
        if name == "T":
            value = structure_tensor(d)
        else:
            value = np.concatenate([[1.0], -np.ones(d - 1)])
        t = _TENSORS[key] = torch.as_tensor(value, dtype=dtype, device=device)
    return t


def multiply(x, y):
    """Algebra matrix product Z = X Y (jordan_matrix_algebra.cc:100-138):
    Z_k = sum_ij T[i, j, k] X_i Y_j.  The leading axes broadcast."""
    d = x.shape[-3]
    T = _constant("T", d, x.dtype, x.device)
    P = x.unsqueeze(-3) @ y.unsqueeze(-4)  # (..., i, j, n, n): X_i Y_j
    return torch.einsum("ijk,...ijac->...kac", T, P)


def conj_transpose(x):
    """Conjugate transpose (jordan_matrix_algebra.cc:89-98)."""
    signs = _constant("signs", x.shape[-3], x.dtype, x.device)
    return signs[:, None, None] * x.transpose(-2, -1)


def jordan_multiply(x, y):
    """x o y = (xy + yx)/2 (jordan_matrix_algebra.cc:163-169)."""
    return 0.5 * (multiply(x, y) + multiply(y, x))


def quadratic_representation(x, y):
    """Q(x) y = 2 x o (x o y) - (x o x) o y
    (jordan_matrix_algebra.cc:171-177)."""
    return 2.0 * jordan_multiply(x, jordan_multiply(x, y)) - jordan_multiply(
        jordan_multiply(x, x), y
    )


def trace_inner_product(x, y):
    """<x, y> = sum_i <X_i, Y_i> (jordan_matrix_algebra.cc:203-210)."""
    return torch.sum(x * y, dim=(-3, -2, -1))


def identity(d: int, n: int, dtype=torch.float64, device="cpu"):
    e = torch.zeros((d, n, n), dtype=dtype, device=device)
    e[0] = torch.eye(n, dtype=dtype, device=device)
    return e


def make_hermitian(x):
    """(x + x^H)/2."""
    return 0.5 * (x + conj_transpose(x))


def real_representation(x):
    """Faithful real matrix representation (d <= 4 only): R(X) is the
    (d n) x (d n) real matrix of left-multiplication by X.  Eigenvalues of a
    Hermitian algebra element appear in R(X) with multiplicity d."""
    d, n = x.shape[-3], x.shape[-1]
    if d == 8:
        raise ValueError("octonions have no faithful real representation")
    T = _constant("T", d, x.dtype, x.device)
    # R[(k,a),(j,b)] = sum_i T[i,j,k] X_i[a,b]
    R = torch.einsum("ijk,...iab->...kajb", T, x)
    return R.reshape(x.shape[:-3] + (d * n, d * n))


def eigenvalues(x) -> torch.Tensor:
    """Exact eigenvalues of a Hermitian algebra element (single, unbatched),
    sorted, as a float64 tensor on the CPU.

    reference: MinimalPolynomial + Roots (jordan_matrix_algebra.cc:36-58):
    the coefficients of the degree-n annihilating polynomial of x under the
    Jordan product are found by least squares on the vectorized Jordan
    powers, and its roots are the eigenvalues (companion-matrix
    eigenvalues).  Works for every algebra including octonions (the Jordan
    algebra is power associative).  A host-side test oracle for the fast
    estimators; the solve never calls it.
    """
    x = torch.as_tensor(x).detach().to("cpu", torch.float64)
    d, n = x.shape[-3], x.shape[-1]
    cols = []
    xpow = identity(d, n)
    for _ in range(n):
        cols.append(xpow.reshape(-1).numpy())
        xpow = jordan_multiply(xpow, x)
    M = np.stack(cols, axis=1)  # (d n^2, n)
    coef, *_ = np.linalg.lstsq(M, -xpow.reshape(-1).numpy(), rcond=None)
    # Monic polynomial t^n + coef[n-1] t^{n-1} + ... + coef[0].
    roots = np.roots(np.concatenate([[1.0], coef[::-1]]))
    return torch.sort(torch.as_tensor(np.real(roots)))[0]


def exponential_map(x):
    """exp(x) via degree-2 Taylor of exp(x/4) + two squarings.

    reference: DoExponentialMap (exponential_map.cc:15-41).
    """
    xs = x / 4.0
    d, n = x.shape[-3], x.shape[-1]
    eye = identity(d, n, x.dtype, x.device)
    y = eye + xs + 0.5 * multiply(xs, xs)
    y = multiply(y, y)
    return multiply(y, y)


def geodesic_update(w, s):
    """Series sum_k Q(w) [Q(s) .]^... / k! with re-Hermitization.

    reference: DoGeodesicUpdate (exponential_map.cc:67-85).
    """
    fact = [1, 1, 2, 6, 24, 120, 720, 5040, 40320, 362880, 3628800, 39916800]
    y1 = w
    y2 = quadratic_representation(w, s)
    y = y1 + y2
    for i in range(1, 6):
        y1 = quadratic_representation(w, quadratic_representation(s, y1))
        y2 = quadratic_representation(w, quadratic_representation(s, y2))
        y = y + y1 / fact[2 * i] + y2 / fact[2 * i + 1]
        y1 = make_hermitian(y1)
        y2 = make_hermitian(y2)
        y = make_hermitian(y)
    return y


def geodesic_update_scaled(w, s):
    """Closed-form degree-2 geodesic update (used for octonions):
    c^2 w + 2ck Q(w)s + k^2 Q(w)Q(s)w, c = 1.5, k = 0.5.

    reference: DoGeodesicUpdateScaled (exponential_map.cc:133-170).
    """
    c, k = 1.5, 0.5
    return make_hermitian(
        c * c * w
        + 2.0 * k * c * quadratic_representation(w, s)
        + k * k * quadratic_representation(w, quadratic_representation(s, w))
    )
