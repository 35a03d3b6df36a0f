"""Light tracing (LightPathIntegrator) + FunctionIntegrator.

Counterparts of the reference's LightPathIntegrator (cpu/integrators.h:322,
impl integrators.cpp: paths start at lights via SampleLe and splat to the
camera through PerspectiveCamera::SampleWi/We) and FunctionIntegrator
(cpu/integrators.h:481: renders an arbitrary 2D function — the sampler
convergence harness used with pspec).

Mapping: one wave = a dense batch of light subpaths; every vertex's
camera connection is a shadow-ray batch + a film *splat* scatter-add
(film.add_splats — the AddSplat/AtomicFloat path of the reference, film.h).
Pinhole-perspective importance only (lens sampling later):
  We(w) = 1 / (A cos^4 theta)   within the frustum (cameras.cpp We)
  SampleWi pdf = dist^2 / cos theta (unit "lens area" delta)
Shading-normal transport asymmetry correction is omitted (geometric normals
dominate our scenes); noted deviation from integrators.cpp.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import vecmath as vm, sampling, spectrum, samplers, rng
from ..geometry import scene as scene_mod, triangle
from ..scatter import bxdf, lights, lightsamplers
from .. import accel
from ..accel import dispatch
from . import camera as camera_mod, film as film_mod
from .integrator import IntegratorConfig, _shading_point

Array = jax.Array


def _camera_screen_area(cam: camera_mod.Camera) -> float:
    """Area of the screen window on the z=1 plane (cameras.cpp A)."""
    tan_half = float(np.tan(np.deg2rad(cam.fov) / 2.0))
    aspect = cam.width / cam.height
    if aspect >= 1.0:
        return (2 * tan_half * aspect) * (2 * tan_half)
    return (2 * tan_half) * (2 * tan_half / aspect)


def camera_project(cam: camera_mod.Camera, p_world: Array):
    """World point -> (flat pixel index, cos theta, valid) for the pinhole
    perspective camera (the film-projection half of SampleWi)."""
    R3 = cam.cam_to_world[:3, :3]
    t3 = cam.cam_to_world[:3, 3]
    pc = (p_world - t3) @ R3  # world -> camera (R orthonormal)
    z = pc[..., 2]
    valid = z > 1e-6
    sx = pc[..., 0] / jnp.maximum(z, 1e-6)
    sy = pc[..., 1] / jnp.maximum(z, 1e-6)
    tan_half = float(np.tan(np.deg2rad(cam.fov) / 2.0))
    aspect = cam.width / cam.height
    hx = tan_half * aspect if aspect >= 1.0 else tan_half
    hy = tan_half if aspect >= 1.0 else tan_half / aspect
    px = (sx / hx * 0.5 + 0.5) * cam.width
    py = (0.5 - sy / hy * 0.5) * cam.height
    inside = (px >= 0) & (px < cam.width) & (py >= 0) & (py < cam.height)
    pix = (jnp.clip(py.astype(jnp.int32), 0, cam.height - 1) * cam.width
           + jnp.clip(px.astype(jnp.int32), 0, cam.width - 1))
    cos_t = z / jnp.maximum(vm.length(pc), 1e-9)
    return pix, cos_t, valid & inside


def sample_le(scene, light_all, light_id, lam, u_pos, u_dir):
    """Light::SampleLe analog for area-tri + point lights: returns
    (p, ng, dir, beta0) with beta0 = Le cos / (pdf_pos pdf_dir) so that
    beta0 * sel_pmf^-1 starts the light path."""
    rec = light_all[jnp.maximum(light_id, 0)]
    ltype = rec[..., 0].astype(jnp.int32)
    emit = lights.record_spectrum(rec, lam)

    # area triangle: uniform area point + cosine-weighted direction
    tri_idx = rec[..., 8].astype(jnp.int32)
    tv = scene.tri_shade[jnp.maximum(tri_idx, 0)][..., 0:9]
    v0, v1, v2 = tv[..., 0:3], tv[..., 3:6], tv[..., 6:9]
    bary = sampling.sample_uniform_triangle(u_pos)
    p_area = (bary[..., 0:1] * v0 + bary[..., 1:2] * v1 + bary[..., 2:3] * v2)
    ng = triangle.geometric_normal(v0, v1, v2)
    area = jnp.maximum(triangle.area(v0, v1, v2), 1e-12)
    two_sided = rec[..., 9] > 0
    # flip to a random side for two-sided lights (reuse u_dir[0] fraction)
    flip = two_sided & (u_dir[..., 0] > 0.5)
    u0 = jnp.where(flip, 2 * u_dir[..., 0] - 1, jnp.where(
        two_sided, 2 * u_dir[..., 0], u_dir[..., 0]))
    ng_eff = jnp.where(flip[..., None], -ng, ng)
    d_local = sampling.sample_cosine_hemisphere(
        jnp.stack([u0, u_dir[..., 1]], -1))
    d_area = vm.from_local(ng_eff, d_local)
    cos_l = jnp.maximum(vm.dot(ng_eff, d_area), 0.0)
    pdf_dir = sampling.cosine_hemisphere_pdf(cos_l)
    pdf_pos = 1.0 / area
    # beta0 = Le cos / (pdf_pos pdf_dir) = Le * pi * area (cosine cancels)
    beta_area = emit * (cos_l / jnp.maximum(pdf_pos * pdf_dir, 1e-20))[..., None]
    beta_area = jnp.where(two_sided[..., None], beta_area * 2.0, beta_area)

    # point light: uniform sphere
    lpos = rec[..., 1:4]
    d_pt = sampling.sample_uniform_sphere(u_dir)
    beta_pt = emit / sampling.UNIFORM_SPHERE_PDF

    # sphere area light: uniform area point + cosine direction off the
    # outward normal (Sphere::SampleLe semantics); two-sided spheres (e.g.
    # emissive furnace shells seen from inside) flip to the inward normal
    # with probability 1/2, mirroring the area-tri branch above
    radius = rec[..., 8]
    n_sph = sampling.sample_uniform_sphere(u_pos)
    p_sph = lpos + radius[..., None] * n_sph
    flip_s = two_sided & (u_dir[..., 0] <= 0.5)
    u0s = jnp.where(flip_s, 1.0 - 2.0 * u_dir[..., 0], jnp.where(
        two_sided, 2.0 * u_dir[..., 0] - 1.0, u_dir[..., 0]))
    n_sph_eff = jnp.where(flip_s[..., None], -n_sph, n_sph)
    d_sph_local = sampling.sample_cosine_hemisphere(
        jnp.stack([u0s, u_dir[..., 1]], -1))
    d_sph = vm.from_local(n_sph_eff, d_sph_local)
    cos_sph = jnp.maximum(vm.dot(n_sph_eff, d_sph), 0.0)
    area_sph = jnp.maximum(4.0 * jnp.pi * radius * radius, 1e-12)
    pdf_dir_sph = sampling.cosine_hemisphere_pdf(cos_sph)
    beta_sph = emit * (cos_sph * area_sph
                       / jnp.maximum(pdf_dir_sph, 1e-20))[..., None]
    beta_sph = jnp.where(two_sided[..., None], beta_sph * 2.0, beta_sph)

    is_area = ltype == scene_mod.LIGHT_AREA_TRI
    is_point = ltype == scene_mod.LIGHT_POINT
    is_sphere = ltype == scene_mod.LIGHT_SPHERE_AREA
    p = jnp.where(is_area[..., None], p_area,
                  jnp.where(is_sphere[..., None], p_sph, lpos))
    ng_out = jnp.where(
        is_area[..., None], ng_eff,
        jnp.where(is_sphere[..., None], n_sph,
                  jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), p.shape)))
    d = jnp.where(is_area[..., None], d_area,
                  jnp.where(is_sphere[..., None], d_sph, d_pt))
    beta0 = jnp.where(is_area[..., None], beta_area,
                      jnp.where(is_sphere[..., None], beta_sph, beta_pt))
    ok = is_area | is_point | is_sphere
    return p, ng_out, d, jnp.where(ok[..., None], beta0, 0.0), \
        is_area | is_sphere


def trace_light_wave(
    scene: scene_mod.CompiledScene,
    dbvh: accel.DeviceBVH,
    cam: camera_mod.Camera,
    sampler_cfg: samplers.SamplerConfig,
    cfg: IntegratorConfig,
    n_paths: int,
    sample_idx: Array,
    ls_tables: lightsamplers.LightSamplerTables | None = None,
    isect: "dispatch.Intersectors | None" = None,
):
    """One light-tracing wave of n_paths subpaths. Returns
    (pixel_idx (R*(D+1),), splat L, lam, lam_pdf) for film.add_splats."""
    if ls_tables is None:
        ls_tables = lightsamplers.build(scene, cfg.light_sampler)
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh, traversal=cfg.traversal)
    scene = jax.tree.map(jnp.asarray, scene)
    dbvh = jax.tree.map(jnp.asarray, dbvh)
    _closest, _any = isect.closest, isect.any_hit
    sg = jax.lax.stop_gradient
    isect_closest = lambda *a: jax.tree.map(sg, _closest(*map(sg, a)))
    isect_any = lambda *a: sg(_any(*map(sg, a)))

    R = n_paths
    path_idx = jnp.arange(R, dtype=jnp.int32)
    sidx = jnp.broadcast_to(jnp.asarray(sample_idx, jnp.int32), (R,))

    def _rand(*salts):
        return rng.hash_float(path_idx, sidx, jnp.uint32(sampler_cfg.seed),
                              *[jnp.asarray(s, jnp.uint32) for s in salts])

    lam, lam_pdf = spectrum.sample_wavelengths_visible(_rand(1))
    light_all = lights.light_records(scene)
    mat_all = bxdf.material_records(scene)

    light_id, sel_pmf, _ = lightsamplers.sample(ls_tables, _rand(2))
    u_pos = jnp.stack([_rand(3), _rand(4)], -1)
    u_dir = jnp.stack([_rand(5), _rand(6)], -1)
    p, ng, d, beta0, is_area = sample_le(scene, light_all, light_id, lam,
                                         u_pos, u_dir)
    beta = beta0 / jnp.maximum(sel_pmf, 1e-12)[..., None]
    active = (light_id >= 0) & jnp.any(beta > 0, axis=-1)
    o = vm.offset_ray_origin(p, ng, d)

    cam_pos = cam.cam_to_world[:3, 3]
    A = _camera_screen_area(cam)
    S = spectrum.N_SPECTRUM_SAMPLES

    splat_pix = []
    splat_L = []

    def connect_vertex(depth, p_v, ns_v, wo_world, ctx, active_v):
        """Connect a surface vertex to the pinhole camera: splat
        beta * f * cos * We / pdf_wi (SampleWi + We, cameras.cpp)."""
        to_cam = cam_pos - p_v
        dist2 = jnp.maximum(vm.length_squared(to_cam), 1e-12)
        wi_cam = to_cam * jax.lax.rsqrt(dist2)[..., None]
        pix, cos_cam, in_frustum = camera_project(cam, p_v)
        f, _ = bxdf.evaluate(ctx, vm.to_local(ns_v, wo_world),
                             vm.to_local(ns_v, wi_cam))
        cos_v = vm.absdot(wi_cam, ns_v)
        want = active_v & in_frustum & jnp.any(f > 0, axis=-1) & (cos_v > 0)
        so = vm.offset_ray_origin(p_v, vm.face_forward(ns_v, wi_cam), wi_cam)
        t_sh = jnp.where(want, jnp.sqrt(dist2) * 0.999, -1.0)
        occluded = isect_any(so, wi_cam, t_sh)
        we = 1.0 / (A * jnp.maximum(cos_cam, 1e-6) ** 4)
        pdf_wi = dist2 / jnp.maximum(cos_cam, 1e-6)
        contrib = beta * f * (cos_v * we / pdf_wi)[..., None]
        ok = want & ~occluded
        splat_pix.append(jnp.where(ok, pix, 0))
        splat_L.append(jnp.where(ok[..., None], contrib, 0.0))

    # area-light vertex 0 connects as pure emitter (camera sees Le directly
    # through the path tracer's emission; the reference's LightPath also only
    # splats from depth >= 1 surface vertices and handles Le via hitting)
    for depth in range(cfg.max_depth):
        t_max = jnp.where(active, 1e30, -1.0)
        hit = isect_closest(o, d, t_max)
        found = active & (hit.prim >= 0)
        sp = _shading_point(scene, hit, o, d)
        wo = -d
        ctx = bxdf.gather_material(scene, sp.mat, lam, mat_all, sp.uv,
                                   _rand(7, depth))
        surf = found & (sp.mat >= 0)
        connect_vertex(depth, sp.p, sp.ns, wo, ctx, surf)

        # continue the light path
        uc = _rand(8, depth)
        u2 = jnp.stack([_rand(9, depth), _rand(10, depth)], -1)
        # light subpaths carry importance (TransportMode::Importance)
        bs = bxdf.sample(ctx, vm.to_local(sp.ns, wo), uc, u2,
                         mode="importance")
        wi_world = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_world, sp.ns)
        beta = jnp.where(
            (surf & bs.valid)[..., None],
            beta * bs.f * (cos_b / jnp.maximum(bs.pdf, 1e-20))[..., None],
            beta)
        active = surf & bs.valid & jnp.any(beta > 0, axis=-1)
        # Russian roulette
        u_rr = _rand(11, depth)
        m = jnp.max(beta, axis=-1)
        q = jnp.where(depth >= 2, jnp.clip(1.0 - m, 0.0, 0.95), 0.0)
        die = active & (u_rr < q)
        active = active & ~die
        beta = jnp.where(active[..., None],
                         beta / jnp.maximum(1.0 - q, 1e-6)[..., None], beta)
        ng_o = vm.face_forward(sp.ng, wi_world)
        o = jnp.where(active[..., None],
                      vm.offset_ray_origin(sp.p, ng_o, wi_world), o)
        d = jnp.where(active[..., None], wi_world, d)

    pix = jnp.concatenate(splat_pix)
    Ls = jnp.concatenate(splat_L)
    reps = len(splat_pix)
    return (pix, Ls, jnp.tile(lam, (reps, 1)), jnp.tile(lam_pdf, (reps, 1)))


def render_lightpath(
    scene, dbvh, cam, spp: int = 16, sampler: str = "independent",
    seed: int = 0, cfg: IntegratorConfig = IntegratorConfig(),
    paths_per_wave: int | None = None,
):
    """LightPathIntegrator render loop: n waves of light subpaths splatted to
    the film; develop with splat_scale = 1 / (paths per pixel-equivalent)."""
    R = cam.width * cam.height
    n_paths = paths_per_wave or R
    sampler_cfg = samplers.make_sampler(sampler, seed=seed, spp=spp,
                                        width=cam.width)
    film = film_mod.make_film(cam.height, cam.width)
    ls_tables = lightsamplers.build(scene, cfg.light_sampler)
    isect = dispatch.make_intersectors(scene, dbvh, traversal=cfg.traversal)
    scene_d, dbvh_d, ls_d = jax.tree.map(jnp.asarray, (scene, dbvh, ls_tables))

    # big arrays as jit ARGS, not closures (see dispatch.py jit-boundary rule)
    @jax.jit
    def wave(f, s, scene, dbvh, ls_tables, tables):
        pix, L, lam, lam_pdf = trace_light_wave(
            scene, dbvh, cam, sampler_cfg, cfg, n_paths, s, ls_tables,
            isect.bind(tables))
        return film_mod.add_splats(f, pix, L, lam, lam_pdf)

    for s in range(spp):
        film = wave(film, jnp.int32(s), scene_d, dbvh_d, ls_d, isect.tables)
    # measurement normalization: each wave spreads n_paths paths over the
    # whole film; scale splats by n_pixels / (n_paths * spp)
    scale = R / (n_paths * spp)
    return film_mod.develop(film, splat_scale=scale)


def render_function(fn, width: int = 128, height: int = 128, spp: int = 16,
                    sampler: str = "sobol", seed: int = 0) -> Array:
    """FunctionIntegrator (cpu/integrators.h:481): render fn(u, v) over the
    image with the given sampler — the sampler-convergence harness."""
    sampler_cfg = samplers.make_sampler(sampler, seed=seed, spp=spp,
                                        width=width)
    R = width * height
    pix = jnp.arange(R, dtype=jnp.int32)

    @jax.jit
    def accum(acc, s):
        sidx = jnp.full((R,), s, jnp.int32)
        ux, uy = samplers.get_2d(sampler_cfg, pix, sidx, 0)
        px = ((pix % width).astype(jnp.float32) + ux) / width
        py = ((pix // width).astype(jnp.float32) + uy) / height
        return acc + fn(px, py)

    acc = jnp.zeros((R,), jnp.float32)
    for s in range(spp):
        acc = accum(acc, jnp.int32(s))
    return (acc / spp).reshape(height, width)
