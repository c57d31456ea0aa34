"""SE(3) Lie group math — pure JAX, branchless, jit/vmap-safe.

JAX replacement for the reference's Sophus::SE3d + Ceres
LocalParameterization stack (SURVEY.md §2.1 rows "SE(3) parameterization"
and expected files `local_parameterization_se3.h`). Instead of a 7-param
quaternion storage with a manifold plus-operator handed to a solver, poses
are stored as explicit (4,4) homogeneous matrices and updated
left-multiplicatively: T <- exp(delta) @ T with delta in R^6.

Tangent convention: delta = [v, w] — translation part first, rotation
(so(3)) part second. All small-angle paths are handled branchlessly with
Taylor fallbacks selected by jnp.where on a safe denominator, so the same
compiled program is correct for delta == 0 (important inside lax.while_loop
convergence tails).
"""

from __future__ import annotations

import jax.numpy as jnp

_SMALL = 1e-8


def _taylor_safe(theta2):
    """Return (theta, small_mask, safe_theta2) for branchless series selection."""
    small = theta2 < _SMALL
    safe2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    return jnp.sqrt(safe2), small, safe2


def so3_hat(w):
    """(...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], -1),
            jnp.stack([wz, z, -wx], -1),
            jnp.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def so3_exp(w):
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation matrix."""
    theta2 = jnp.sum(w * w, -1)
    theta, small, _ = _taylor_safe(theta2)
    # sin(t)/t and (1-cos(t))/t^2 with 2nd-order Taylor fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2))
    W = so3_hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def rotmat_to_quat(R):
    """(...,3,3) -> (...,4) unit quaternion (w, x, y, z), branchless Shepperd.

    Computes all four candidate extractions and selects the one whose
    pivot (the quantity under the sqrt) is largest — numerically robust
    for any rotation including theta ~ pi, with no data-dependent branches.
    """
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    # Four pivots: 1+tr, 1+2*rii-tr for i in 0..2
    p0 = 1.0 + tr
    p1 = 1.0 + 2.0 * r00 - tr
    p2 = 1.0 + 2.0 * r11 - tr
    p3 = 1.0 + 2.0 * r22 - tr
    pivots = jnp.stack([p0, p1, p2, p3], -1)
    best = jnp.argmax(pivots, -1)
    s = jnp.sqrt(jnp.clip(jnp.take_along_axis(pivots, best[..., None], -1)[..., 0], 1e-12)) * 2.0

    # Candidate quaternions per pivot (w, x, y, z)
    q0 = jnp.stack([0.25 * s, (r21 - r12) / s, (r02 - r20) / s, (r10 - r01) / s], -1)
    q1 = jnp.stack([(r21 - r12) / s, 0.25 * s, (r01 + r10) / s, (r02 + r20) / s], -1)
    q2 = jnp.stack([(r02 - r20) / s, (r01 + r10) / s, 0.25 * s, (r12 + r21) / s], -1)
    q3 = jnp.stack([(r10 - r01) / s, (r02 + r20) / s, (r12 + r21) / s, 0.25 * s], -1)
    cands = jnp.stack([q0, q1, q2, q3], -2)  # (...,4cand,4)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), -2)[..., 0, :]
    # Canonicalize sign (w >= 0) and normalize
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rotmat(q):
    """(...,4) (w,x,y,z) unit quaternion -> (...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def so3_log(R):
    """(...,3,3) -> (...,3) axis-angle; robust up to theta = pi via quaternion."""
    q = rotmat_to_quat(R)
    w, v = q[..., 0], q[..., 1:]
    vn2 = jnp.sum(v * v, -1)
    vn = jnp.sqrt(jnp.where(vn2 < _SMALL, 1.0, vn2))
    theta = 2.0 * jnp.arctan2(jnp.sqrt(vn2), w)
    # theta/sin(theta/2) == theta/|v| scale; Taylor: 2/w for small |v|
    scale = jnp.where(vn2 < _SMALL, 2.0 / jnp.clip(w, 1e-6), theta / vn)
    return v * scale[..., None]


def _left_jacobian_coeffs(theta2, dtype):
    """Coefficients (a, b) of V = I + a*W + b*W^2 for the SO(3) left Jacobian."""
    theta, small, safe2 = _taylor_safe(theta2)
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe2)
    b = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (safe2 * theta))
    return a.astype(dtype), b.astype(dtype)


def se3_exp(delta):
    """(...,6) tangent [v, w] -> (...,4,4) homogeneous transform.

    T = [ exp(w^)  V(w) v ]  with V the SO(3) left Jacobian.
        [   0         1   ]
    """
    v, w = delta[..., :3], delta[..., 3:]
    theta2 = jnp.sum(w * w, -1)
    R = so3_exp(w)
    a, b = _left_jacobian_coeffs(theta2, delta.dtype)
    W = so3_hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=delta.dtype), W.shape)
    V = eye + a[..., None, None] * W + b[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    top = jnp.concatenate([R, t[..., None]], -1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=delta.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], -2)


def se3_log(T):
    """(...,4,4) -> (...,6) tangent [v, w]; inverse of se3_exp."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = jnp.sum(w * w, -1)
    theta, small, safe2 = _taylor_safe(theta2)
    W = so3_hat(w)
    W2 = W @ W
    # V^-1 = I - W/2 + c*W^2, c = (1/t^2 - (1+cos t)/(2 t sin t)); Taylor c -> 1/12
    sin_t = jnp.sin(theta)
    c = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / safe2) - (1.0 + jnp.cos(theta)) / (2.0 * theta * jnp.where(small, 1.0, sin_t)),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Vinv = eye - 0.5 * W + c[..., None, None] * W2
    v = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], -1)


def se3_identity(dtype=jnp.float32, batch=()):
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), batch + (4, 4))


def se3_inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    top = jnp.concatenate([Rt, ti[..., None]], -1)
    bottom = jnp.broadcast_to(jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), top.shape[:-2] + (1, 4))
    return jnp.concatenate([top, bottom], -2)


def se3_compose(A, B):
    return A @ B


def se3_apply(T, pts):
    """Apply (...,4,4) to points (...,N,3) -> (...,N,3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def se3_adjoint(T):
    """(...,4,4) -> (...,6,6) adjoint for the [v, w] tangent ordering.

    Ad(T) = [ R  t^ R ]
            [ 0    R  ]
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = so3_hat(t) @ R
    z = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], -1)
    bottom = jnp.concatenate([z, R], -1)
    return jnp.concatenate([top, bottom], -2)
