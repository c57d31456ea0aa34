"""Planar symmetric-3x3 algebra — component arrays, not (...,3,3) tensors.

THE core layout decision of this framework: *planar structure-of-arrays*.
A symmetric 3x3 field over N points is six (N,)-shaped component
planes; a point field is three planes. Each plane is contiguous along N,
so reads coalesce and no small minor dimension (3 or 3x3) is padded or
strided. Every operation here is closed-form scalar math applied
elementwise to planes, which XLA fuses freely.

Component order everywhere: (xx, yy, zz, xy, xz, yz) — index by the
S3 enum-like constants below. A "sym" is any pytree of six same-shaped
arrays (tuple convention); a "vec" is three.

Replaces: Eigen::SelfAdjointEigenSolver + dense 3x3 matrix algebra in
the reference (SURVEY.md §2.1 "Per-point covariance estimation",
"GICP Mahalanobis cost").
"""

from __future__ import annotations

import jax.numpy as jnp

XX, YY, ZZ, XY, XZ, YZ = range(6)


def from_matrix(M):
    """(...,3,3) symmetric -> 6-tuple of (...,) planes."""
    return (M[..., 0, 0], M[..., 1, 1], M[..., 2, 2],
            M[..., 0, 1], M[..., 0, 2], M[..., 1, 2])


def to_matrix(c):
    """6-tuple -> (...,3,3)."""
    xx, yy, zz, xy, xz, yz = c
    row0 = jnp.stack([xx, xy, xz], -1)
    row1 = jnp.stack([xy, yy, yz], -1)
    row2 = jnp.stack([xz, yz, zz], -1)
    return jnp.stack([row0, row1, row2], -2)


def identity_like(x, scale=1.0):
    one = jnp.full_like(x, scale)
    zero = jnp.zeros_like(x)
    return (one, one, one, zero, zero, zero)


def add(a, b):
    return tuple(ai + bi for ai, bi in zip(a, b))


def scale(a, s):
    return tuple(ai * s for ai in a)


def matvec(c, v):
    """Symmetric matrix-vector product on planes: returns (3,) vec planes."""
    xx, yy, zz, xy, xz, yz = c
    vx, vy, vz = v
    return (xx * vx + xy * vy + xz * vz,
            xy * vx + yy * vy + yz * vz,
            xz * vx + yz * vy + zz * vz)


def rotate(R, c):
    """R C R^T for a single 3x3 rotation R (scalars) and planar sym C.

    R is a (3,3) array of traced scalars (one pose), C is planar over N.
    Expanded closed form: M_ab = sum_cd R_ac C_cd R_bd.
    """
    xx, yy, zz, xy, xz, yz = c

    def row(a):
        # (C R^T)_cb for b-th output uses column of R; build C @ R^T rows
        r0, r1, r2 = R[a, 0], R[a, 1], R[a, 2]
        cx = xx * r0 + xy * r1 + xz * r2
        cy = xy * r0 + yy * r1 + yz * r2
        cz = xz * r0 + yz * r1 + zz * r2
        return cx, cy, cz

    a0 = row(0)
    a1 = row(1)
    a2 = row(2)

    def dot(av, b):
        return av[0] * R[b, 0] + av[1] * R[b, 1] + av[2] * R[b, 2]

    return (dot(a0, 0), dot(a1, 1), dot(a2, 2), dot(a0, 1), dot(a0, 2), dot(a1, 2))


def det(c):
    xx, yy, zz, xy, xz, yz = c
    return (xx * (yy * zz - yz * yz)
            - xy * (xy * zz - yz * xz)
            + xz * (xy * yz - yy * xz))


def inv(c, det_c=None):
    """Closed-form symmetric inverse via adjugate; returns planar sym."""
    xx, yy, zz, xy, xz, yz = c
    d = det(c) if det_c is None else det_c
    rd = 1.0 / d
    return ((yy * zz - yz * yz) * rd,
            (xx * zz - xz * xz) * rd,
            (xx * yy - xy * xy) * rd,
            (xz * yz - xy * zz) * rd,
            (xy * yz - xz * yy) * rd,
            (xy * xz - xx * yz) * rd)


def chol(c, jitter=0.0):
    """Closed-form lower Cholesky; returns (l00,l10,l11,l20,l21,l22) planes."""
    xx, yy, zz, xy, xz, yz = c
    l00 = jnp.sqrt(jnp.clip(xx + jitter, 1e-30))
    l10 = xy / l00
    l20 = xz / l00
    l11 = jnp.sqrt(jnp.clip(yy + jitter - l10 * l10, 1e-30))
    l21 = (yz - l20 * l10) / l11
    l22 = jnp.sqrt(jnp.clip(zz + jitter - l20 * l20 - l21 * l21, 1e-30))
    return (l00, l10, l11, l20, l21, l22)


def chol_logdet(L):
    l00, _, l11, _, _, l22 = L
    return 2.0 * (jnp.log(l00) + jnp.log(l11) + jnp.log(l22))


def chol_maha(L, v):
    """v^T (L L^T)^{-1} v via forward substitution on planes."""
    l00, l10, l11, l20, l21, l22 = L
    vx, vy, vz = v
    e0 = vx / l00
    e1 = (vy - l10 * e0) / l11
    e2 = (vz - l20 * e0 - l21 * e1) / l22
    return e0 * e0 + e1 * e1 + e2 * e2


def eigvals(c):
    """Eigenvalues (descending 3-tuple of planes) — trigonometric method."""
    xx, yy, zz, xy, xz, yz = c
    p1 = xy * xy + xz * xz + yz * yz
    q = (xx + yy + zz) / 3.0
    b00, b11, b22 = xx - q, yy - q, zz - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.clip(p2 / 6.0, 1e-30))
    detb = (b00 * (b11 * b22 - yz * yz)
            - xy * (xy * b22 - yz * xz)
            + xz * (xy * yz - b11 * xz))
    # p >= ~1e-15 after the clip, but p^3 ~ 1e-45 UNDERFLOWS f32 to 0 for
    # isotropic matrices -> 0/0 NaN (caught by the SEMICP_DEBUG_NANS
    # lane; masked downstream by near_diag, but jax_debug_nans traps at
    # the primitive). Clamp the denominator instead.
    r = jnp.clip(detb / jnp.maximum(2.0 * p * p * p, 1e-30), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    near_diag = p1 < 1e-12 * (q * q + 1e-30)
    dmax = jnp.maximum(jnp.maximum(xx, yy), zz)
    dmin = jnp.minimum(jnp.minimum(xx, yy), zz)
    dmid = xx + yy + zz - dmax - dmin
    return (jnp.where(near_diag, dmax, e1),
            jnp.where(near_diag, dmid, e2),
            jnp.where(near_diag, dmin, e3))


def smallest_eigvec(c):
    """Unit eigenvector planes (nx,ny,nz) for the smallest eigenvalue.

    Cross-product method on rows of (C - lam_min I); the largest of the
    three candidate cross products wins; isotropic fallback +z.
    """
    lam = eigvals(c)[2]
    xx, yy, zz, xy, xz, yz = c
    m00, m11, m22 = xx - lam, yy - lam, zz - lam
    # rows: (m00, xy, xz), (xy, m11, yz), (xz, yz, m22)
    c0 = (xy * yz - xz * m11, xz * xy - m00 * yz, m00 * m11 - xy * xy)
    c1 = (xy * m22 - xz * yz, xz * xz - m00 * m22, m00 * yz - xy * xz)
    c2 = (m11 * m22 - yz * yz, yz * xz - xy * m22, xy * yz - m11 * xz)
    n0 = c0[0] ** 2 + c0[1] ** 2 + c0[2] ** 2
    n1 = c1[0] ** 2 + c1[1] ** 2 + c1[2] ** 2
    n2 = c2[0] ** 2 + c2[1] ** 2 + c2[2] ** 2
    use1 = n1 > n0
    bx = jnp.where(use1, c1[0], c0[0])
    by = jnp.where(use1, c1[1], c0[1])
    bz = jnp.where(use1, c1[2], c0[2])
    bn = jnp.where(use1, n1, n0)
    use2 = n2 > bn
    bx = jnp.where(use2, c2[0], bx)
    by = jnp.where(use2, c2[1], by)
    bz = jnp.where(use2, c2[2], bz)
    bn = jnp.where(use2, n2, bn)
    ok = bn > 1e-24
    rn = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, bn, 1.0)), 0.0)
    return (bx * rn, by * rn, jnp.where(ok, bz * rn, jnp.ones_like(bz)))


def regularize_gicp(c, eps):
    """GICP clamp on planes: C -> I - (1-eps) n n^T (see geom/eig3.py)."""
    nx, ny, nz = smallest_eigvec(c)
    k = 1.0 - eps
    one = jnp.ones_like(nx)
    return (one - k * nx * nx, one - k * ny * ny, one - k * nz * nz,
            -k * nx * ny, -k * nx * nz, -k * ny * nz)


def pack(c):
    """6-tuple of (...,) planes -> (6, ...) array (for storage in pytrees)."""
    return jnp.stack(c, 0)


def unpack(a):
    """(6, ...) array -> 6-tuple of planes."""
    return tuple(a[i] for i in range(6))
