"""Closed-form symmetric 3x3 eigendecomposition + Cholesky — elementwise math.

JAX replacement for the reference's Eigen::SelfAdjointEigenSolver
(used in GICP per-point covariance regularization, SURVEY.md §2.1 row
"Per-point covariance estimation") and for the dense factorizations Ceres
performs internally. Everything here is branchless, batched via leading
dims, and avoids lapack-style iteration so it fuses into surrounding XLA
programs instead of falling back to host/loop code.

Key algebraic shortcut used by the covariance hot path: the GICP clamp
    C_reg = R diag(1, 1, eps) R^T
depends only on the *smallest*-eigenvalue eigenvector n (the surface
normal), because diag(1,1,eps) = I - (1-eps) e3 e3^T in the eigenbasis:
    C_reg = I - (1 - eps) n n^T.
`smallest_eigvec` computes exactly that one robust eigenvector.
"""

from __future__ import annotations

import jax.numpy as jnp


def _sym_parts(A):
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    return a00, a01, a02, a11, a12, a22


def eigvals3x3(A):
    """Eigenvalues of symmetric (...,3,3), descending — trigonometric method."""
    a00, a01, a02, a11, a12, a22 = _sym_parts(A)
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    # floor keeps p**3 in normal f32 range: with the old 1e-30 floor,
    # p**3 = 1e-45 flushes to zero and detb/(2 p^3) goes 0/0 = NaN on an
    # exactly-zero matrix (e.g. the empirical covariance of a
    # single-point neighborhood). Matrices with eigenvalue spread below
    # 1e-10 are spherical to f32 anyway — the ±2p cos terms then perturb
    # q by <=2e-10, which is noise at that scale.
    p = jnp.sqrt(jnp.clip(p2 / 6.0, 1e-20))
    # det(B)/2 with B = (A - q I)/p
    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    # p^3 ~ 1e-30 stays normal here (p >= 1e-10 via the 1e-20 clip), but
    # clamp anyway so an isotropic input can never reach 0/0 (sibling of
    # the sym3.eigvals underflow the SEMICP_DEBUG_NANS lane caught)
    r = jnp.clip(detb / jnp.maximum(2.0 * p * p * p, 1e-30), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    # Diagonal / near-spherical guard: p1 ~ 0 means A is (almost) diagonal
    diag = jnp.stack([a00, a11, a22], -1)
    dsort = jnp.sort(diag, -1)[..., ::-1]
    # absolute term must stay in normal f32 range (1e-30 * 1e-12 would
    # flush to zero and drop the guard exactly when A ~ 0 needs it)
    near_diag = (p1 < 1e-12 * (q * q + 1e-12))[..., None]
    return jnp.where(near_diag, dsort, jnp.stack([e1, e2, e3], -1))


def _eigvec_for(A, lam, fallback):
    """Robust eigenvector of symmetric A for (well-separated) eigenvalue lam.

    Rows of (A - lam I) are orthogonal to the eigenvector; the three
    pairwise cross products are candidates, pick the largest. `fallback`
    is used branchlessly when all candidates vanish (degenerate pair).
    """
    eye = jnp.eye(3, dtype=A.dtype)
    M = A - lam[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = jnp.cross(r0, r1)
    c1 = jnp.cross(r0, r2)
    c2 = jnp.cross(r1, r2)
    cands = jnp.stack([c0, c1, c2], -2)
    n2 = jnp.sum(cands * cands, -1)
    best = jnp.argmax(n2, -1)
    v = jnp.take_along_axis(cands, best[..., None, None].repeat(3, -1), -2)[..., 0, :]
    vn2 = jnp.sum(v * v, -1, keepdims=True)
    ok = vn2 > 1e-24
    v = jnp.where(ok, v / jnp.sqrt(jnp.where(ok, vn2, 1.0)), fallback)
    return v


def smallest_eigvec(A):
    """Unit eigenvector of the smallest eigenvalue of symmetric (...,3,3).

    This is the GICP surface normal. Degenerate (spherical) neighborhoods
    fall back to +z — for an isotropic covariance the clamp direction is
    immaterial.
    """
    lam = eigvals3x3(A)[..., 2]
    fb = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], dtype=A.dtype), A.shape[:-1])
    return _eigvec_for(A, lam, fb)


def eigh3x3(A):
    """Full decomposition of symmetric (...,3,3): (eigvals desc, eigvecs cols).

    Returns (w, V) with w[...,k] descending and V[...,:,k] the matching
    unit eigenvectors forming a right-handed orthonormal basis. Built from
    the two best-separated eigenvectors; the middle one is their cross
    product, so orthonormality is exact even for near-degenerate pairs.
    """
    w = eigvals3x3(A)
    fb1 = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], dtype=A.dtype), A.shape[:-1])
    fb3 = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], dtype=A.dtype), A.shape[:-1])
    v1 = _eigvec_for(A, w[..., 0], fb1)
    v3 = _eigvec_for(A, w[..., 2], fb3)
    # If the spectrum is tightly clustered the two extreme vectors may not be
    # orthogonal; re-orthogonalize v3 against v1 branchlessly.
    v3 = v3 - jnp.sum(v3 * v1, -1, keepdims=True) * v1
    n3 = jnp.linalg.norm(v3, axis=-1, keepdims=True)
    v3 = jnp.where(n3 > 1e-12, v3 / jnp.clip(n3, 1e-12), fb3 - jnp.sum(fb3 * v1, -1, keepdims=True) * v1)
    v3 = v3 / jnp.linalg.norm(v3, axis=-1, keepdims=True)
    v2 = jnp.cross(v3, v1)
    V = jnp.stack([v1, v2, v3], -1)
    return w, V


def gicp_regularize(C, eps):
    """GICP plane-to-plane clamp: C -> R diag(1,1,eps) R^T == I - (1-eps) n n^T."""
    n = smallest_eigvec(C)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=C.dtype), C.shape)
    return eye - (1.0 - eps) * n[..., :, None] * n[..., None, :]


def cholesky3x3(A, jitter=0.0):
    """Closed-form lower Cholesky of SPD (...,3,3) (+ optional diagonal jitter)."""
    a00, a01, a02, a11, a12, a22 = _sym_parts(A)
    a00 = a00 + jitter
    a11 = a11 + jitter
    a22 = a22 + jitter
    l00 = jnp.sqrt(jnp.clip(a00, 1e-30))
    l10 = a01 / l00
    l20 = a02 / l00
    l11 = jnp.sqrt(jnp.clip(a11 - l10 * l10, 1e-30))
    l21 = (a12 - l20 * l10) / l11
    l22 = jnp.sqrt(jnp.clip(a22 - l20 * l20 - l21 * l21, 1e-30))
    z = jnp.zeros_like(l00)
    return jnp.stack(
        [
            jnp.stack([l00, z, z], -1),
            jnp.stack([l10, l11, z], -1),
            jnp.stack([l20, l21, l22], -1),
        ],
        -2,
    )


def tri_solve3x3(L, b):
    """Forward-substitution solve L y = b for lower-triangular (...,3,3), b (...,3)."""
    y0 = b[..., 0] / L[..., 0, 0]
    y1 = (b[..., 1] - L[..., 1, 0] * y0) / L[..., 1, 1]
    y2 = (b[..., 2] - L[..., 2, 0] * y0 - L[..., 2, 1] * y1) / L[..., 2, 2]
    return jnp.stack([y0, y1, y2], -1)


def tri_solve3x3_mat(L, B):
    """Solve L Y = B for (...,3,3) B column-wise (whitening a Jacobian block)."""
    cols = [tri_solve3x3(L, B[..., :, k]) for k in range(3)]
    return jnp.stack(cols, -1)


def cho_solve3x3(L, b):
    """Solve (L L^T) x = b."""
    y = tri_solve3x3(L, b)
    # back substitution with L^T (upper)
    x2 = y[..., 2] / L[..., 2, 2]
    x1 = (y[..., 1] - L[..., 2, 1] * x2) / L[..., 1, 1]
    x0 = (y[..., 0] - L[..., 1, 0] * x1 - L[..., 2, 0] * x2) / L[..., 0, 0]
    return jnp.stack([x0, x1, x2], -1)
