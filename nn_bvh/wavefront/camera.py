"""Cameras: batched ray generation.

Counterpart of the reference camera family (`base/camera.h:34`, `cameras.h`):
PerspectiveCamera (with thin-lens depth of field), OrthographicCamera,
SphericalCamera (equirectangular + equal-area octahedral mappings,
cameras.h SphericalCamera) and RealisticCamera (spherical lens-element stack
tracing, cameras.h:RealisticCamera / TraceLensesFromFilm) as batched pure
functions — the GenerateCameraRays stage of the wavefront pipeline
(`wavefront/camera.cpp:18`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import sampling, vecmath as vm
from ..geometry import transform as xf

Array = jax.Array

PERSPECTIVE = 0
ORTHOGRAPHIC = 1
SPHERICAL_EQUIRECT = 2
SPHERICAL_EQUALAREA = 3
REALISTIC = 4


class Camera(NamedTuple):
    kind: int                 # static
    cam_to_world: Array       # (4,4) f32 — pbrt LookAt convention (+z forward)
    fov: float                # degrees, shorter image axis (perspective)
    width: int
    height: int
    lens_radius: float
    focal_distance: float
    screen_scale: float       # ortho half-height
    # realistic camera: lens element table (E, 4) rows rear-to-front:
    # [curvature_radius, thickness, eta, aperture_radius] (lens .dat format)
    lens_elements: Array | None = None
    film_diag: float = 0.035  # film diagonal (m), RealisticCamera filmdiag
    # camera motion blur (AnimatedTransform, util/transform.h:444 +
    # shutteropen/shutterclose): K pre-slerped cam_to_world keyframes over
    # the shutter interval; None = static camera
    motion_keys: Array | None = None  # (K, 4, 4)


from ..utils.pytree import register_static as _register_static

_register_static(
    Camera, ("kind", "fov", "width", "height", "lens_radius", "focal_distance",
             "screen_scale", "film_diag")
)


def make_perspective(cam_to_world: np.ndarray, fov: float, width: int, height: int,
                     lens_radius: float = 0.0, focal_distance: float = 1e6) -> Camera:
    return Camera(PERSPECTIVE, jnp.asarray(cam_to_world, jnp.float32), float(fov),
                  int(width), int(height), float(lens_radius), float(focal_distance), 1.0)


def make_orthographic(cam_to_world: np.ndarray, half_height: float, width: int,
                      height: int) -> Camera:
    return Camera(ORTHOGRAPHIC, jnp.asarray(cam_to_world, jnp.float32), 0.0,
                  int(width), int(height), 0.0, 1e6, float(half_height))


def make_spherical(cam_to_world: np.ndarray, width: int, height: int,
                   mapping: str = "equalarea") -> Camera:
    """SphericalCamera (cameras.h): whole-sphere image; mapping is
    'equirectangular' or 'equalarea' (the reference's default octahedral)."""
    kind = {"equirectangular": SPHERICAL_EQUIRECT, "equirect": SPHERICAL_EQUIRECT,
            "equalarea": SPHERICAL_EQUALAREA}[mapping]
    return Camera(kind, jnp.asarray(cam_to_world, jnp.float32), 0.0,
                  int(width), int(height), 0.0, 1e6, 1.0)


# Built-in lens: a symmetric biconvex singlet (f = 1/((n-1)(1/R1+1/R2))
# ~ 48 mm for R=50, n=1.52) with a front aperture stop. Rows rear-to-front:
# [curvature radius, gap from the previous surface (film for row 0), IOR of
# the medium AFTER crossing toward the scene, aperture radius] — units mm.
# Real lens prescriptions (pbrt lenses/*.dat style tables) can be passed to
# make_realistic(lens_elements=...).
_BICONVEX = np.array(
    [
        #  curv   gap    eta    ap
        [50.0, 48.0, 1.52, 12.0],   # rear surface (convex toward film)
        [-50.0, 6.0, 1.0, 12.0],    # front surface (into air)
        [0.0, 1.0, 1.0, 9.0],       # aperture stop
    ],
    np.float32,
)


def make_realistic(cam_to_world: np.ndarray, width: int, height: int,
                   lens_elements: np.ndarray | None = None,
                   aperture_diameter: float | None = None,
                   focus_distance: float = 1000.0,
                   film_diag: float = 35.0) -> Camera:
    """RealisticCamera (cameras.h / cameras.cpp RealisticCamera): traces film
    rays through a spherical lens-element stack. Units are millimeters like
    pbrt's lens files. The focus shift is applied as extra rear thickness
    found by a focal-distance bisection on host."""
    el = np.array(lens_elements if lens_elements is not None else _BICONVEX,
                  np.float32).reshape(-1, 4)
    if aperture_diameter is not None:
        stop = np.abs(el[:, 0]) < 1e-6
        el[stop, 3] = aperture_diameter / 2.0
    # focus: bisect the rear gap so a point at focus_distance images on film
    el = _focus_lens(el, focus_distance)
    return Camera(REALISTIC, jnp.asarray(cam_to_world, jnp.float32), 0.0,
                  int(width), int(height), 0.0, float(focus_distance), 1.0,
                  lens_elements=jnp.asarray(el), film_diag=float(film_diag))


def _trace_lenses_from_film(elements, o, d):
    """Trace camera-space rays from the film (z<0 side, pointing +z is INTO
    the lens in our convention: film at z=0, elements stacked toward -z like
    pbrt's TraceLensesFromFilm with z flipped to keep +z = world forward).

    elements: (E, 4) rear-to-front. Returns (o', d', valid)."""
    E = elements.shape[0]
    valid = jnp.ones(o.shape[:-1], bool)
    # work in pbrt's lens space: rays travel toward -z... we keep +z travel
    # and flip curvatures, which is equivalent.
    z = jnp.zeros((), jnp.float32)
    for i in range(E):
        curv, thick, eta_next, ap = (elements[i, 0], elements[i, 1],
                                     elements[i, 2], elements[i, 3])
        z = z + thick
        is_stop = jnp.abs(curv) < 1e-6

        # intersect sphere centered at z + curv (or plane at z for the stop)
        oz = o[..., 2]
        dz = d[..., 2]
        t_plane = (z - oz) / jnp.where(jnp.abs(dz) < 1e-9, 1e-9, dz)
        center = z + curv
        oc = o - jnp.stack([jnp.zeros_like(oz), jnp.zeros_like(oz),
                            jnp.broadcast_to(center, oz.shape)], -1)
        b = vm.dot(oc, d)
        c = vm.length_squared(oc) - curv * curv
        disc = b * b - c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        # pick the hit on the correct side (pbrt IntersectSphericalElement:
        # use far hit when ray exits toward center side)
        use_near = (d[..., 2] > 0) ^ (curv < 0)
        t_sph = jnp.where(use_near, -b - sq, -b + sq)
        t = jnp.where(is_stop, t_plane, t_sph)
        ok = jnp.where(is_stop, t_plane > 0, (disc >= 0) & (t > 1e-7))
        p = o + t[..., None] * d
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        ok = ok & (r2 <= ap * ap)

        if True:  # refraction at non-stop surfaces
            n = vm.normalize(p - jnp.stack(
                [jnp.zeros_like(oz), jnp.zeros_like(oz),
                 jnp.broadcast_to(center, oz.shape)], -1))
            n = vm.face_forward(n, -d)
            eta_prev = elements[i - 1, 2] if i > 0 else jnp.float32(1.0)
            eta_rel = jnp.where(is_stop, 1.0,
                                eta_prev / jnp.where(eta_next < 1e-6, 1.0, eta_next))
            ok_r, _, wt = vm.refract(-d, n, 1.0 / jnp.maximum(eta_rel, 1e-6))
            d_new = jnp.where(is_stop[..., None] | ~ok_r[..., None], d, wt)
            ok = ok & (is_stop | ok_r)
        o = jnp.where(ok[..., None], p, o)
        d = jnp.where(ok[..., None], vm.normalize(d_new), d)
        valid = valid & ok
    return o, d, valid


def _focus_lens(el: np.ndarray, focus_distance: float) -> np.ndarray:
    """Adjust the rear gap (first element thickness) so the plane at
    focus_distance (mm) is imaged onto the film (bisection on host; the
    reference solves the thick-lens equation, cameras.cpp FocusThickLens)."""
    def film_blur(extra):
        e = el.copy()
        e[0, 1] += extra
        # trace a near-axis fan from the focus plane through the lens front->
        # back is complex; instead trace from film and measure where the rays
        # converge: spot z of intersection of two film rays
        o = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], jnp.float32)
        r = 0.3 * e[-1, 3]
        d = jnp.asarray(
            [[r, 0.0, e[:, 1].sum()], [-r, 0.0, e[:, 1].sum()]], jnp.float32)
        d = d / np.linalg.norm(np.asarray(d), axis=-1, keepdims=True)
        oo, dd, ok = _trace_lenses_from_film(jnp.asarray(e), o, d)
        oo, dd = np.asarray(oo), np.asarray(dd)
        if not np.all(np.asarray(ok)):
            return None
        # intersect the two exit rays (x-z plane) -> crossing z
        # o1+t1 d1 = o2+t2 d2 in x: solve 2x2
        a = np.array([[dd[0, 0], -dd[1, 0]], [dd[0, 2], -dd[1, 2]]])
        b = np.array([oo[1, 0] - oo[0, 0], oo[1, 2] - oo[0, 2]])
        try:
            t = np.linalg.solve(a, b)
        except np.linalg.LinAlgError:
            return None
        zc = oo[0, 2] + t[0] * dd[0, 2]
        return zc - el[:, 1].sum()  # distance past the front vertex

    lo, hi = -0.5 * el[0, 1], 10.0
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        zb = film_blur(mid)
        if zb is None or zb < 0:
            # diverging exit fan: film inside the focal length -> more gap
            lo = mid
            continue
        if zb > focus_distance:
            lo = mid
        else:
            hi = mid
    out = el.copy()
    out[0, 1] = max(out[0, 1] + 0.5 * (lo + hi), 1.0)
    return out


def interpolate_motion(cam: Camera, u_time: Array) -> Array:
    """Per-lane camera matrix for shutter times u_time (R,) in [0,1):
    piecewise-linear blend of the pre-slerped keyframe matrices (the slerp
    nonlinearity is baked into the K keys at build; AnimatedTransform
    interpolation, transform.h:444)."""
    keys = cam.motion_keys
    K = keys.shape[0]
    f = jnp.clip(u_time, 0.0, 1.0 - 1e-6) * (K - 1)
    i0 = f.astype(jnp.int32)
    fr = (f - i0)[..., None, None]
    return keys[i0] * (1.0 - fr) + keys[i0 + 1] * fr


def with_motion(cam: Camera, cam_to_world_end, n_keys: int = 16) -> Camera:
    """Attach a shutter-close transform: pre-slerps n_keys matrices between
    the camera's transform (shutter open) and cam_to_world_end."""
    from ..geometry import animated

    at = animated.AnimatedTransform(
        np.asarray(cam.cam_to_world), 0.0,
        np.asarray(cam_to_world_end), 1.0)
    keys = np.stack([at.interpolate(i / (n_keys - 1))
                     for i in range(n_keys)])
    return cam._replace(motion_keys=jnp.asarray(keys, jnp.float32))


def generate_rays(cam: Camera, pixel_idx: Array, u_pixel: Array, u_lens: Array,
                  u_time: Array | None = None):
    """pixel_idx: (R,) flat pixel index; u_pixel/u_lens: (R,2) jitters;
    u_time: (R,) shutter times (camera motion blur; ignored when static).

    Returns (o, d) world-space rays. Screen-window convention follows pbrt
    (cameras.cpp): FOV spans the shorter axis, +y up in screen space.
    """
    W, H = cam.width, cam.height
    px = (pixel_idx % W).astype(jnp.float32) + u_pixel[..., 0]
    py = (pixel_idx // W).astype(jnp.float32) + u_pixel[..., 1]
    aspect = W / H
    sx = 2.0 * px / W - 1.0
    sy = 1.0 - 2.0 * py / H
    if aspect >= 1.0:
        sx = sx * aspect
    else:
        sy = sy / aspect

    if cam.kind in (SPHERICAL_EQUIRECT, SPHERICAL_EQUALAREA):
        # SphericalCamera (cameras.h): full-sphere image, origin at the camera
        u = px / W
        v = py / H
        if cam.kind == SPHERICAL_EQUIRECT:
            theta = jnp.pi * v
            phi = 2.0 * jnp.pi * u
            st, ct = jnp.sin(theta), jnp.cos(theta)
            d_cam = jnp.stack([st * jnp.cos(phi), ct, st * jnp.sin(phi)], -1)
        else:
            d_cam = vm.equal_area_square_to_sphere(jnp.stack([u, v], -1))
        o_cam = jnp.zeros_like(d_cam)
        R3 = cam.cam_to_world[:3, :3]
        t3 = cam.cam_to_world[:3, 3]
        return o_cam @ R3.T + t3, d_cam @ R3.T

    if cam.kind == REALISTIC:
        # RealisticCamera: sample a point on the rear lens element, trace
        # film->lens stack (cameras.cpp GenerateRay). Lens units are mm; the
        # exit ray is rescaled to scene units (mm -> m).
        el = cam.lens_elements
        half_diag = cam.film_diag / 2.0
        aspect_n = jnp.sqrt(1.0 + (W / H) ** 2)
        half_x = half_diag * (W / H) / aspect_n
        half_y = half_diag / aspect_n
        # film point (image is inverted through the lens: flip)
        fx = -(2.0 * px / W - 1.0) * half_x
        fy = (1.0 - 2.0 * py / H) * half_y
        o_film = jnp.stack([fx, fy, jnp.zeros_like(fx)], -1)
        # aim at a sampled point on the rear element disk
        rear_r = el[0, 3]
        p_lens2 = rear_r * sampling.sample_uniform_disk_concentric(u_lens)
        rear_z = el[0, 1]
        p_rear = jnp.concatenate(
            [p_lens2, jnp.broadcast_to(rear_z, p_lens2[..., :1].shape)], -1)
        d0 = vm.normalize(p_rear - o_film)
        o_cam, d_cam, ok = _trace_lenses_from_film(el, o_film, d0)
        # vignetted rays: keep direction but zero radiance via degenerate dir?
        # -> send them along +z with origin far behind everything (they miss);
        # the film weight of a vignetted ray is 0 in pbrt — approximated by
        # pointing the ray at nothing (no env contribution is a small bias
        # only for env-lit scenes; documented deviation).
        d_cam = jnp.where(ok[..., None], d_cam,
                          jnp.asarray([0.0, 0.0, 1.0], jnp.float32))
        o_cam = o_cam * 1e-3  # mm -> scene meters
        o_cam = jnp.where(ok[..., None], o_cam,
                          jnp.asarray([0.0, 0.0, -1e9], jnp.float32))
        R3 = cam.cam_to_world[:3, :3]
        t3 = cam.cam_to_world[:3, 3]
        return o_cam @ R3.T + t3, d_cam @ R3.T

    if cam.kind == PERSPECTIVE:
        tan_half = float(np.tan(np.deg2rad(cam.fov) / 2.0))
        d_cam = jnp.stack([sx * tan_half, sy * tan_half, jnp.ones_like(sx)], axis=-1)
        o_cam = jnp.zeros_like(d_cam)
        if cam.lens_radius > 0.0:
            # thin-lens depth of field (cameras.h PerspectiveCamera aperture)
            p_lens = cam.lens_radius * sampling.sample_uniform_disk_concentric(u_lens)
            ft = cam.focal_distance  # d_cam.z == 1
            p_focus = d_cam * ft
            o_cam = jnp.concatenate([p_lens, jnp.zeros_like(p_lens[..., :1])], axis=-1)
            d_cam = p_focus - o_cam
        # normalize + to world
        d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    else:
        o_cam = jnp.stack(
            [sx * cam.screen_scale, sy * cam.screen_scale, jnp.zeros_like(sx)], axis=-1
        )
        d_cam = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32), o_cam.shape)

    if cam.motion_keys is not None and u_time is not None:
        # per-lane shutter-time camera matrix (camera motion blur)
        m = interpolate_motion(cam, u_time)            # (R, 4, 4)
        Rm = m[..., :3, :3]
        tm = m[..., :3, 3]
        hi = jax.lax.Precision.HIGHEST  # float32 ray origins/directions
        o = jnp.einsum("rij,rj->ri", Rm, o_cam, precision=hi) + tm
        d = jnp.einsum("rij,rj->ri", Rm, d_cam, precision=hi)
        return o, d
    R = cam.cam_to_world[:3, :3]
    t = cam.cam_to_world[:3, 3]
    o = o_cam @ R.T + t
    d = d_cam @ R.T
    return o, d
