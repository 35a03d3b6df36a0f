"""Sampling warps, MIS heuristics, and piecewise-constant distributions.

Batched counterpart of the reference's `util/sampling.h` (60 KB): every warp
is a pure elementwise function over batched [0,1)^k samples — exactly the shape
the VPU wants. Distribution1D/2D sampling is binary search over prefix sums
(searchsorted = log-depth vectorized compare, no data-dependent loops).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import vecmath as vm

Array = jax.Array

INV_PI = 0.31830988618379067154
INV_2PI = 0.15915494309189533577
INV_4PI = 0.07957747154594766788
PI_OVER_2 = 1.57079632679489661923
PI_OVER_4 = 0.78539816339744830961


# ---------------------------------------------------------------------------
# MIS heuristics (sampling.h PowerHeuristic/BalanceHeuristic)
# ---------------------------------------------------------------------------

def balance_heuristic(nf: Array, f_pdf: Array, ng: Array, g_pdf: Array) -> Array:
    return (nf * f_pdf) / jnp.maximum(nf * f_pdf + ng * g_pdf, 1e-20)


def power_heuristic(nf: Array, f_pdf: Array, ng: Array, g_pdf: Array) -> Array:
    # clamp instead of the isinf-select: inf in the untaken where-branch
    # poisons reverse-mode gradients (0 * nan)
    f = jnp.minimum(nf * f_pdf, 1e18)
    g = jnp.minimum(ng * g_pdf, 1e18)
    return (f * f) / jnp.maximum(f * f + g * g, 1e-20)


# ---------------------------------------------------------------------------
# warps
# ---------------------------------------------------------------------------

def sample_uniform_disk_concentric(u: Array) -> Array:
    """Shirley–Chiu concentric disk map (sampling.h SampleUniformDiskConcentric).
    u: (...,2) -> (...,2)."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0) & (oy == 0)
    use_x = jnp.abs(ox) > jnp.abs(oy)
    r = jnp.where(use_x, ox, oy)
    theta = jnp.where(
        use_x,
        PI_OVER_4 * (oy / jnp.where(ox == 0, 1.0, ox)),
        PI_OVER_2 - PI_OVER_4 * (ox / jnp.where(oy == 0, 1.0, oy)),
    )
    p = r[..., None] * jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
    return jnp.where(zero[..., None], 0.0, p)


def sample_cosine_hemisphere(u: Array) -> Array:
    """Malley's method; pdf = cos(theta)/pi. u:(...,2) -> (...,3) with +z up."""
    d = sample_uniform_disk_concentric(u)
    z = vm.safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return jnp.stack([d[..., 0], d[..., 1], z], axis=-1)


def cosine_hemisphere_pdf(cos_theta: Array) -> Array:
    return cos_theta * INV_PI


def sample_uniform_sphere(u: Array) -> Array:
    z = 1.0 - 2.0 * u[..., 0]
    r = vm.safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


UNIFORM_SPHERE_PDF = INV_4PI


def sample_uniform_hemisphere(u: Array) -> Array:
    z = u[..., 0]
    r = vm.safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


UNIFORM_HEMISPHERE_PDF = INV_2PI


def sample_uniform_cone(u: Array, cos_theta_max: Array) -> Array:
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = vm.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * jnp.pi * u[..., 1]
    return vm.spherical_direction(sin_theta, cos_theta, phi)


def uniform_cone_pdf(cos_theta_max: Array) -> Array:
    return 1.0 / (2.0 * jnp.pi * jnp.maximum(1.0 - cos_theta_max, 1e-9))


def sample_uniform_triangle(u: Array) -> Array:
    """Low-distortion triangle warp (sampling.h SampleUniformTriangle).
    Returns barycentrics (...,3)."""
    flip = u[..., 0] < u[..., 1]
    b0 = jnp.where(flip, u[..., 0] / 2.0, u[..., 0] - u[..., 1] / 2.0)
    b1 = jnp.where(flip, u[..., 1] - b0, u[..., 1] / 2.0)
    return jnp.stack([b0, b1, 1.0 - b0 - b1], axis=-1)


def sample_spherical_triangle(v0: Array, v1: Array, v2: Array, p: Array, u: Array):
    """Solid-angle (Arvo) sampling of triangle (v0,v1,v2) from point p.

    Reference: sampling.h:38 SampleSphericalTriangle / sampling.cpp. Returns
    (barycentrics (...,3), pdf = 1/solid_angle). All math batched, branch-free.
    """
    a = vm.normalize(v0 - p)
    b = vm.normalize(v1 - p)
    c = vm.normalize(v2 - p)
    # normals of great-circle planes
    n_ab = vm.cross(a, b)
    n_bc = vm.cross(b, c)
    n_ca = vm.cross(c, a)
    n_ab = vm.normalize(n_ab)
    n_bc = vm.normalize(n_bc)
    n_ca = vm.normalize(n_ca)
    # interior dihedral angles
    alpha = vm.safe_acos(vm.dot(n_ab, -n_ca))
    beta = vm.safe_acos(vm.dot(n_bc, -n_ab))
    gamma = vm.safe_acos(vm.dot(n_ca, -n_bc))
    A_full = alpha + beta + gamma - jnp.pi  # spherical area
    pdf = 1.0 / jnp.maximum(A_full, 1e-12)

    # sample sub-area
    Ap = u[..., 0] * A_full
    # Arvo's construction
    cos_alpha = jnp.cos(alpha)
    sin_alpha = jnp.sin(alpha)
    sinPhi = jnp.sin(Ap) * cos_alpha - jnp.cos(Ap) * sin_alpha * 0.0  # placeholder
    # Use the pbrt formulation:
    cosAp = jnp.cos(Ap)
    sinAp = jnp.sin(Ap)
    s = sinAp * cos_alpha - cosAp * sin_alpha  # sin(Ap - alpha)
    t = cosAp * cos_alpha + sinAp * sin_alpha  # cos(Ap - alpha)
    cos_c_angle = vm.dot(a, b)  # cos of edge length c' (a..b)
    u_ = t - cos_alpha
    v_ = s + sin_alpha * cos_c_angle
    q = ((v_ * t - u_ * s) * cos_alpha - v_) / jnp.maximum(
        (v_ * s + u_ * t) * sin_alpha, 1e-12
    )
    q = jnp.clip(q, -1.0, 1.0)
    # new vertex c-hat on arc a..c
    c_perp = vm.normalize(c - vm.dot(c, a)[..., None] * a)
    c_hat = q[..., None] * a + vm.safe_sqrt(1.0 - q * q)[..., None] * c_perp
    # sample along arc b..c_hat
    z = 1.0 - u[..., 1] * (1.0 - vm.dot(c_hat, b))
    z = jnp.clip(z, -1.0, 1.0)
    b_perp = vm.normalize(c_hat - vm.dot(c_hat, b)[..., None] * b)
    w = z[..., None] * b + vm.safe_sqrt(1.0 - z * z)[..., None] * b_perp

    # recover barycentrics: intersect ray (p, w) with triangle plane
    e1 = v1 - v0
    e2 = v2 - v0
    ng = vm.cross(e1, e2)
    denom = vm.dot(w, ng)
    t_hit = vm.dot(v0 - p, ng) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    ph = p + t_hit[..., None] * w
    # project to barycentric via normal-equations (2x2 solve)
    d = ph - v0
    d11 = vm.dot(e1, e1)
    d12 = vm.dot(e1, e2)
    d22 = vm.dot(e2, e2)
    dx1 = vm.dot(d, e1)
    dx2 = vm.dot(d, e2)
    det = jnp.maximum(d11 * d22 - d12 * d12, 1e-20)
    b1 = jnp.clip((d22 * dx1 - d12 * dx2) / det, 0.0, 1.0)
    b2 = jnp.clip((d11 * dx2 - d12 * dx1) / det, 0.0, 1.0)
    b0 = jnp.clip(1.0 - b1 - b2, 0.0, 1.0)
    bary = jnp.stack([b0, b1, b2], axis=-1)
    degenerate = A_full < 1e-5
    # fall back to area sampling for tiny solid angles
    bary_area = sample_uniform_triangle(u)
    bary = jnp.where(degenerate[..., None], bary_area, bary)
    return bary, pdf, degenerate


def sample_exponential(u: Array, a: Array) -> Array:
    return -jnp.log(jnp.maximum(1.0 - u, 1e-38)) / a


def sample_visible_wavelengths(u: Array) -> Array:
    """Importance sample wavelengths by visible-sensitivity pdf
    (sampling.h SampleVisibleWavelengths)."""
    return 538.0 - 138.888889 * jnp.arctanh(0.85691062 - 1.82750197 * u)


def visible_wavelengths_pdf(lam: Array) -> Array:
    ok = (lam >= 360.0) & (lam <= 830.0)
    x = jnp.cosh(0.0072 * (lam - 538.0))
    return jnp.where(ok, 0.0039398042 / (x * x), 0.0)


# ---------------------------------------------------------------------------
# piecewise-constant distributions (sampling.h PiecewiseConstant1D/2D)
# ---------------------------------------------------------------------------

def make_distribution_1d(f: Array):
    """Build a 1D piecewise-constant distribution over [0,1].

    Returns dict with 'cdf' (n+1,), 'func' (n,), 'integral' ().
    """
    f = jnp.abs(f)
    n = f.shape[-1]
    cdf = jnp.concatenate(
        [jnp.zeros(f.shape[:-1] + (1,), f.dtype), jnp.cumsum(f, axis=-1) / n], axis=-1
    )
    integral = cdf[..., -1]
    safe = integral > 0
    cdf = jnp.where(
        safe[..., None],
        cdf / jnp.maximum(integral[..., None], 1e-20),
        jnp.linspace(0.0, 1.0, n + 1),
    )
    return {"cdf": cdf, "func": f, "integral": integral}


def sample_distribution_1d(dist, u: Array):
    """Sample; returns (x in [0,1], pdf, index)."""
    cdf = dist["cdf"]
    f = dist["func"]
    n = f.shape[-1]
    idx = jnp.clip(jnp.searchsorted(cdf, u, side="right") - 1, 0, n - 1)
    c0 = jnp.take(cdf, idx, axis=-1)
    c1 = jnp.take(cdf, idx + 1, axis=-1)
    du = jnp.where(c1 > c0, (u - c0) / jnp.maximum(c1 - c0, 1e-20), 0.0)
    x = (idx.astype(jnp.float32) + du) / n
    pdf = jnp.take(f, idx, axis=-1) / jnp.maximum(dist["integral"], 1e-20)
    return x, pdf, idx


def make_distribution_2d(f: Array):
    """2D distribution over [0,1]^2 from an (h, w) function (env-map sampling).

    Conditional rows + marginal over row integrals; sampling is two
    searchsorteds (reference PiecewiseConstant2D).
    """
    h, w = f.shape
    f = jnp.abs(f)
    row_int = jnp.mean(f, axis=1)  # (h,)
    cond_cdf = jnp.concatenate(
        [jnp.zeros((h, 1), f.dtype), jnp.cumsum(f, axis=1) / w], axis=1
    )
    cond_cdf = cond_cdf / jnp.maximum(row_int[:, None], 1e-20)
    marg = make_distribution_1d(row_int)
    return {"f": f, "cond_cdf": cond_cdf, "marg": marg, "h": h, "w": w}


def sample_distribution_2d(dist, u: Array):
    """u:(...,2) -> ((...,2) point in [0,1]^2, pdf)."""
    h, w = dist["h"], dist["w"]
    y, pdf_y, iy = sample_distribution_1d(dist["marg"], u[..., 1])
    cond = dist["cond_cdf"][iy]  # (..., w+1)
    ux = u[..., 0]
    ix = jnp.clip(
        jax.vmap(jnp.searchsorted, in_axes=(0, 0))(
            cond.reshape(-1, w + 1), ux.reshape(-1)
        ).reshape(ux.shape)
        - 1,
        0,
        w - 1,
    )
    c0 = jnp.take_along_axis(cond, ix[..., None], axis=-1)[..., 0]
    c1 = jnp.take_along_axis(cond, ix[..., None] + 1, axis=-1)[..., 0]
    du = jnp.where(c1 > c0, (ux - c0) / jnp.maximum(c1 - c0, 1e-20), 0.0)
    x = (ix.astype(jnp.float32) + du) / w
    f_xy = dist["f"][iy, ix]
    integral = jnp.maximum(dist["marg"]["integral"], 1e-20)
    pdf = f_xy / integral
    return jnp.stack([x, y], axis=-1), pdf


def distribution_2d_pdf(dist, p: Array) -> Array:
    h, w = dist["h"], dist["w"]
    ix = jnp.clip((p[..., 0] * w).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip((p[..., 1] * h).astype(jnp.int32), 0, h - 1)
    return dist["f"][iy, ix] / jnp.maximum(dist["marg"]["integral"], 1e-20)


# ---------------------------------------------------------------------------
# equal-area / misc
# ---------------------------------------------------------------------------

def sample_discrete(weights: Array, u: Array):
    """Sample index from unnormalized weights along last axis; returns (idx, pmf, u_remapped)."""
    cdf = jnp.cumsum(weights, axis=-1)
    total = cdf[..., -1:]
    cdf = cdf / jnp.maximum(total, 1e-20)
    idx = jnp.clip(
        jnp.sum((u[..., None] >= cdf).astype(jnp.int32), axis=-1), 0, weights.shape[-1] - 1
    )
    pmf = jnp.take_along_axis(weights, idx[..., None], axis=-1)[..., 0] / jnp.maximum(
        total[..., 0], 1e-20
    )
    lo = jnp.where(
        idx == 0,
        0.0,
        jnp.take_along_axis(cdf, jnp.maximum(idx - 1, 0)[..., None], axis=-1)[..., 0],
    )
    hi = jnp.take_along_axis(cdf, idx[..., None], axis=-1)[..., 0]
    u_new = jnp.clip((u - lo) / jnp.maximum(hi - lo, 1e-20), 0.0, 1.0 - 2**-24)
    return idx, pmf, u_new
