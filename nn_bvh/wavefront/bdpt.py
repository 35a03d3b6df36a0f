"""Bidirectional path tracing (BDPTIntegrator, cpu/integrators.h:345).

The reference BDPT (cpu/integrators.cpp:2218 area: GenerateCameraSubpath /
GenerateLightSubpath / ConnectBDPT / MISWeight) builds per-path vertex arrays
and combines every (s,t) connection strategy with the Veach balance-style
weight computed from forward/reverse area-measure pdfs stored on each vertex.

Re-design: subpaths are generated as dense SoA vertex arrays over the
whole wave (one camera + one light subpath per pixel sample), each vertex a
set of (R,...) arrays in a static Python list (the depth axis is static —
no ragged paths). Every (s,t) strategy is one batched connection: a shadow-ray
batch plus the masked MIS-weight recurrence, unrolled over the static vertex
index. t=1 strategies splat through the camera (film.add_splats, like
lightpath.py); everything else accumulates into the pixel's own L.

Strategy/weight semantics follow integrators.cpp MISWeight exactly:
ri-products of remap0(pdfRev)/remap0(pdfFwd) walked back along both subpaths,
with connection-specific pdf overrides at the four vertices nearest the
connection edge. Infinite lights never start light subpaths here (deviation:
the reference supports it); env contributions are instead weighted with the
{BSDF-hit, NEE} power-heuristic pair — the only two strategies that can
produce env paths in this design — which keeps the estimator consistent.
"""

from __future__ import annotations

from typing import NamedTuple

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
from .lightpath import _camera_screen_area, camera_project, sample_le

Array = jax.Array


class Vertex(NamedTuple):
    """One subpath vertex over the wave (all fields (R,...) arrays)."""

    p: Array          # (R,3)
    ns: Array         # shading normal
    ng: Array         # geometric normal
    wo: Array         # unit dir toward the PREVIOUS vertex (world)
    ctx: bxdf.MaterialCtx | None   # shading context (None for pure emitters)
    beta: Array       # (R,4) throughput arriving at this vertex
    pdf_fwd: Array    # (R,) area-measure pdf of sampling this vertex forward
    pdf_rev: Array    # (R,) area-measure pdf of re-sampling it backward
    delta: Array      # (R,) bool — reached via a delta bounce
    active: Array     # (R,) bool — lane carries a real vertex
    light: Array      # (R,) i32 area-light id if emissive hit (-1 none)
    tri_area: Array   # (R,) area of the hit triangle (for light-origin pdf)


def _remap0(x: Array) -> Array:
    """MISWeight's remap0: treat 0 pdfs as 1 so delta terms cancel."""
    return jnp.where(x > 0, x, 1.0)


def _to_area(pdf_sa: Array, p_from: Array, p_to: Array, ng_to: Array) -> Array:
    """Solid-angle pdf at p_from -> area-measure pdf at p_to
    (Vertex::ConvertDensity, integrators.cpp)."""
    d = p_to - p_from
    d2 = jnp.maximum(vm.length_squared(d), 1e-12)
    w = d * jax.lax.rsqrt(d2)[..., None]
    return pdf_sa * vm.absdot(ng_to, w) / d2


def _bsdf_pdf(v: Vertex, wo_w: Array, wi_w: Array) -> Array:
    """pdf of sampling wi_w at v given incidence wo_w (both world)."""
    _, pdf = bxdf.evaluate(v.ctx, vm.to_local(v.ns, wo_w),
                           vm.to_local(v.ns, wi_w))
    return pdf


def _bsdf_f(v: Vertex, wo_w: Array, wi_w: Array) -> Array:
    f, _ = bxdf.evaluate(v.ctx, vm.to_local(v.ns, wo_w),
                         vm.to_local(v.ns, wi_w))
    return f


def _dirto(a: Array, b: Array):
    d = b - a
    d2 = jnp.maximum(vm.length_squared(d), 1e-12)
    return d * jax.lax.rsqrt(d2)[..., None], d2


def _light_dir_pdf(lrec: Array, ng_l: Array, w: Array) -> Array:
    """Emission-direction pdf of our SampleLe: cosine hemisphere for area +
    sphere-area lights (x0.5 two-sided), uniform sphere for point lights."""
    ltype = lrec[..., 0].astype(jnp.int32)
    two_sided = lrec[..., 9] > 0
    c = vm.dot(ng_l, w)
    pdf_area = jnp.where(
        two_sided,
        0.5 * sampling.cosine_hemisphere_pdf(jnp.abs(c)),
        jnp.where(c > 0, sampling.cosine_hemisphere_pdf(c), 0.0))
    is_surf = ((ltype == scene_mod.LIGHT_AREA_TRI)
               | (ltype == scene_mod.LIGHT_SPHERE_AREA))
    return jnp.where(is_surf, pdf_area, sampling.UNIFORM_SPHERE_PDF)


def _light_origin_area(lrec: Array, tri_area: Array) -> Array:
    """Surface area the light-origin position pdf is uniform over:
    the emitting triangle for per-tri area lights, 4 pi r^2 for the
    analytic sphere light (PdfLightOrigin's pdfPos counterpart)."""
    ltype = lrec[..., 0].astype(jnp.int32)
    r = lrec[..., 8]
    sph_area = jnp.maximum(4.0 * jnp.pi * r * r, 1e-12)
    return jnp.where(ltype == scene_mod.LIGHT_SPHERE_AREA, sph_area,
                     jnp.maximum(tri_area, 1e-12))


def _random_walk(scene, isect_closest, mat_all, o, d, beta, pdf_dir, n_steps,
                 active0, rand, prev_p0, on_env, mode="radiance"):
    """Shared camera/light subpath walk (GenerateCameraSubpath /
    GenerateLightSubpath, integrators.cpp): returns a list of Vertex.

    on_env(depth, o, d, beta, active, pdf_dir, escaped): callback for rays
    that leave the scene (env handling on the camera walk; no-op for light).
    """
    verts: list[Vertex] = []
    active = active0
    prev_p = prev_p0
    prev_delta = jnp.zeros_like(active0)
    R = o.shape[0]
    for depth in range(n_steps):
        t_max = jnp.where(active, 1e30, -1.0)
        hit = isect_closest(o, d, t_max)
        found = active & (hit.prim >= 0)
        if on_env is not None:
            on_env(depth, o, d, beta, active & (hit.prim < 0), pdf_dir)
        sp = _shading_point(scene, hit, o, d)
        ctx = bxdf.gather_material(scene, sp.mat, rand.lam, mat_all, sp.uv,
                                   rand(20, depth))
        found = found & (sp.mat >= 0)
        _, d2_prev = _dirto(prev_p, sp.p)
        pdf_fwd = jnp.where(prev_delta, 0.0,
                            pdf_dir * vm.absdot(sp.ng, d) / d2_prev)
        v = Vertex(p=sp.p, ns=sp.ns, ng=sp.ng, wo=-d, ctx=ctx, beta=beta,
                   pdf_fwd=pdf_fwd, pdf_rev=jnp.zeros((R,)),
                   delta=prev_delta, active=found, light=sp.light,
                   tri_area=jnp.maximum(
                       triangle.area(sp.v0, sp.v1, sp.v2), 1e-12))
        # bounce
        uc = rand(21, depth)
        u2 = jnp.stack([rand(22, depth), rand(23, depth)], -1)
        bs = bxdf.sample(ctx, vm.to_local(sp.ns, -d), uc, u2, mode=mode)
        wi_w = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_w, sp.ns)
        nxt = found & bs.valid
        # reverse pdf of the PREVIOUS vertex: pdf at this vertex of sampling
        # back toward it, converted to area there
        if depth > 0:
            pv = verts[-1]
            rev_sa = _bsdf_pdf(v, wi_w, -d)
            pdf_rev_prev = jnp.where(
                bs.specular, 0.0, _to_area(rev_sa, sp.p, pv.p, pv.ng))
            verts[-1] = pv._replace(
                pdf_rev=jnp.where(nxt, pdf_rev_prev, pv.pdf_rev))
        beta = jnp.where(
            nxt[..., None],
            beta * bs.f * (cos_b / jnp.maximum(bs.pdf, 1e-20))[..., None],
            beta)
        active = nxt & jnp.any(beta > 0, axis=-1)
        prev_delta = bs.specular
        pdf_dir = jnp.where(bs.specular, 0.0, bs.pdf)
        prev_p = sp.p
        ng_o = vm.face_forward(sp.ng, wi_w)
        o = jnp.where(active[..., None],
                      vm.offset_ray_origin(sp.p, ng_o, wi_w), o)
        d = jnp.where(active[..., None], wi_w, d)
        verts.append(v)
    return verts


def _mis_weight(cam: list[Vertex], lig: list[Vertex], t_s: int, s: int,
                cam_rev: dict[int, Array], lig_rev: dict[int, Array],
                light_delta0: Array) -> Array:
    """MISWeight (integrators.cpp): 1 / (1 + sum ri) with connection-local
    pdf_rev overrides. t_s = camera SURFACE vertices used (pbrt t = t_s+1),
    s = light vertices used."""
    sum_ri = 0.0
    ri = 1.0
    for i in range(t_s - 1, -1, -1):
        pr = cam_rev.get(i, cam[i].pdf_rev)
        ri = ri * _remap0(pr) / _remap0(cam[i].pdf_fwd)
        prev_delta = cam[i - 1].delta if i > 0 else jnp.zeros_like(cam[0].delta)
        use = ~cam[i].delta & ~prev_delta
        sum_ri = sum_ri + jnp.where(use, ri, 0.0)
    ri = 1.0
    for i in range(s - 1, -1, -1):
        pr = lig_rev.get(i, lig[i].pdf_rev)
        ri = ri * _remap0(pr) / _remap0(lig[i].pdf_fwd)
        prev_delta = lig[i - 1].delta if i > 0 else light_delta0
        use = ~lig[i].delta & ~prev_delta
        sum_ri = sum_ri + jnp.where(use, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


class _Rand:
    """Counter-based per-(path, sample) uniforms; lam cached for the walk."""

    def __init__(self, pixel_idx, sidx, seed, lam):
        self._pi, self._si, self._seed = pixel_idx, sidx, seed
        self.lam = lam

    def __call__(self, *salts):
        return rng.hash_float(
            self._pi, self._si, jnp.uint32(self._seed),
            *[jnp.asarray(s, jnp.uint32) for s in salts])


def trace_bdpt_wave(scene, dbvh, cam, sampler_cfg, cfg: IntegratorConfig,
                    pixel_idx, sample_idx, ls_tables=None, isect=None):
    """One BDPT wave. Returns (L (R,4), lam, lam_pdf, splat_pix, splat_L)."""
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

    R = pixel_idx.shape[0]
    sidx = jnp.broadcast_to(jnp.asarray(sample_idx, jnp.int32), (R,))
    max_depth = cfg.max_depth
    # pbrt sizing (BDPTIntegrator::Render): t <= maxDepth+2 camera vertices
    # incl. the camera itself, s <= maxDepth+1 light vertices; every strategy
    # keeps total vertices t_s + s + 1 <= maxDepth + 2
    T = max_depth + 1        # camera surface vertices
    S = max_depth + 1        # light vertices incl. the origin one

    # wavelengths + camera ray
    upx, upy = samplers.get_2d(sampler_cfg, pixel_idx, sidx, 0)
    ul = samplers.get_1d(sampler_cfg, pixel_idx, sidx, 2)
    lam, lam_pdf = spectrum.sample_wavelengths_visible(ul)
    rand = _Rand(pixel_idx, sidx, sampler_cfg.seed, lam)
    o0, d0 = camera_mod.generate_rays(
        cam, pixel_idx, jnp.stack([upx, upy], -1), jnp.full((R, 2), 0.5))

    light_all = lights.light_records(scene)
    mat_all = bxdf.material_records(scene)
    n_lights = scene.n_lights

    SANS = spectrum.N_SPECTRUM_SAMPLES
    L = jnp.zeros((R, SANS))
    A = _camera_screen_area(cam)
    cam_pos = cam.cam_to_world[:3, 3]

    # env handling on the camera walk: {BSDF, NEE} power-heuristic pair
    inf_pmf = jnp.sum(jnp.where(
        scene.light_type == scene_mod.LIGHT_UNIFORM_INFINITE,
        ls_tables.pmf, 0.0)) if n_lights else 0.0
    env_pmf = jnp.sum(jnp.where(
        scene.light_type == scene_mod.LIGHT_IMAGE_INFINITE,
        ls_tables.pmf, 0.0)) if n_lights else 0.0
    env_box = [L * 0.0]

    def on_env(depth, o, d, beta, escaped, pdf_dir):
        if n_lights == 0:
            return
        le = lights.infinite_le(scene, d, lam)
        pdf_l = sampling.UNIFORM_SPHERE_PDF * inf_pmf
        if lights.has_env_map(scene):
            pdf_l = pdf_l + env_pmf * lights.env_pdf_dir(scene, d)
        w = jnp.where(
            (depth == 0) | (pdf_dir <= 0), 1.0,
            sampling.power_heuristic(1.0, pdf_dir,
                                     1.0, jnp.broadcast_to(pdf_l, (R,))))
        env_box[0] = env_box[0] + jnp.where(
            escaped[..., None], beta * le * w[..., None], 0.0)

    # --- camera subpath ----------------------------------------------------
    # first-vertex forward pdf: pinhole direction pdf 1/(A cos^3)
    cos_cam0 = vm.absdot(d0, cam.cam_to_world[:3, 2])
    pdf_cam_dir0 = 1.0 / (A * jnp.maximum(cos_cam0, 1e-6) ** 3)
    cam_v = _random_walk(
        scene, isect_closest, mat_all, o0, d0,
        jnp.ones((R, SANS)), pdf_cam_dir0, T,
        jnp.ones((R,), bool), rand, o0, on_env)
    L = L + env_box[0]

    # --- light subpath -------------------------------------------------------
    lig_v: list[Vertex] = []
    light_delta0 = jnp.zeros((R,), bool)
    if n_lights > 0:
        light_id, sel_pmf, _ = lightsamplers.sample(ls_tables, rand(2))
        lrec0 = light_all[jnp.maximum(light_id, 0)]
        p0, ng0, dL, beta0, is_area0 = sample_le(
            scene, light_all, light_id, lam,
            jnp.stack([rand(3), rand(4)], -1),
            jnp.stack([rand(5), rand(6)], -1))
        sel_pmf = jnp.maximum(sel_pmf, 1e-12)
        beta_l = beta0 / sel_pmf[..., None]
        act0 = (light_id >= 0) & jnp.any(beta_l > 0, axis=-1)
        is_point0 = lrec0[..., 0].astype(jnp.int32) == scene_mod.LIGHT_POINT
        light_delta0 = is_point0
        tri_a0 = jnp.ones((R,))
        if True:  # area of the emitting triangle (for light-origin pdf)
            tid = lrec0[..., 8].astype(jnp.int32)
            tv = scene.tri_shade[jnp.maximum(tid, 0)][..., 0:9]
            tri_a0 = jnp.where(is_area0, jnp.maximum(
                triangle.area(tv[..., 0:3], tv[..., 3:6], tv[..., 6:9]),
                1e-12), 1.0)
        origin_a0 = _light_origin_area(lrec0, tri_a0)
        v0 = Vertex(
            p=p0, ns=ng0, ng=ng0, wo=ng0, ctx=None,
            beta=lights.record_spectrum(lrec0, lam) / sel_pmf[..., None],
            pdf_fwd=jnp.where(is_area0, 1.0 / origin_a0, 1.0) * sel_pmf,
            pdf_rev=jnp.zeros((R,)), delta=is_point0, active=act0,
            light=light_id, tri_area=origin_a0)
        pdf_dir0 = _light_dir_pdf(lrec0, ng0, dL)
        oL = vm.offset_ray_origin(p0, vm.face_forward(ng0, dL), dL)
        walk = _random_walk(
            scene, isect_closest, mat_all, oL, dL, beta_l, pdf_dir0, S - 1,
            act0, _Rand(pixel_idx, sidx, sampler_cfg.seed + 7, lam), p0, None,
            mode="importance")
        # reverse pdf of the light origin from its first walk vertex
        if walk:
            w1 = walk[0]
            to0, _ = _dirto(w1.p, p0)
            rev_sa = _bsdf_pdf(w1, w1.wo, to0)
            v0 = v0._replace(pdf_rev=jnp.where(
                w1.active, _to_area(rev_sa, w1.p, p0, ng0), 0.0))
        lig_v = [v0] + walk

    splat_pix: list[Array] = []
    splat_L: list[Array] = []

    def pmf_of(p_ref: Array, lid: Array) -> Array:
        return lightsamplers.pmf_ctx(ls_tables, p_ref, lid)

    # --- strategies ----------------------------------------------------------
    for t_s in range(1, T + 1):
        pt = cam_v[t_s - 1]
        pt_prev_p = cam_v[t_s - 2].p if t_s >= 2 else jnp.broadcast_to(
            cam_pos, (R, 3))

        # ---- s = 0: camera path hits an emitter --------------------------
        if n_lights > 0:
            lrec = light_all[jnp.maximum(pt.light, 0)]
            has_l = pt.active & (pt.light >= 0)
            le = lights.area_light_l_rec(lrec, has_l, pt.ng, pt.wo, lam)
            sel = pmf_of(pt_prev_p, pt.light)
            cam_rev = {t_s - 1: sel / _light_origin_area(lrec, pt.tri_area)}
            if t_s >= 2:
                pdf_dir = _light_dir_pdf(lrec, pt.ng, -pt.wo)
                cam_rev[t_s - 2] = _to_area(
                    pdf_dir, pt.p, cam_v[t_s - 2].p, cam_v[t_s - 2].ng)
            # s + t == 2 (pbrt t = t_s+1): the 2-vertex path has exactly
            # one strategy -> weight 1 (MISWeight's early-out)
            if t_s == 1:
                w = jnp.ones((R,))
            else:
                w = _mis_weight(cam_v, lig_v, t_s, 0, cam_rev, {},
                                light_delta0)
            L = L + jnp.where(has_l[..., None], pt.beta * le * w[..., None],
                              0.0)

        # ---- s = 1: sample a light at pt (NEE) ----------------------------
        if n_lights > 0 and t_s + 1 <= max_depth + 1:
            u_sel = rand(30, t_s)
            u2 = jnp.stack([rand(31, t_s), rand(32, t_s)], -1)
            lid, sel_pmf, _ = lightsamplers.sample_ctx(ls_tables, pt.p, u_sel)
            ls = lights.sample_li(scene, light_all, lid, pt.p, lam, u2)
            lrec = light_all[jnp.maximum(lid, 0)]
            ltype = lrec[..., 0].astype(jnp.int32)
            is_inf = ((ltype == scene_mod.LIGHT_UNIFORM_INFINITE)
                      | (ltype == scene_mod.LIGHT_IMAGE_INFINITE)
                      | (ltype == scene_mod.LIGHT_PORTAL_ENV)
                      | (ltype == scene_mod.LIGHT_DISTANT))
            f = _bsdf_f(pt, pt.wo, ls.wi)
            cos_pt = vm.absdot(ls.wi, pt.ns)
            pdf_l = jnp.maximum(ls.pdf * sel_pmf, 1e-20)
            want = (pt.active & ls.valid & (cos_pt > 0)
                    & jnp.any(f > 0, axis=-1))
            so = vm.offset_ray_origin(pt.p, vm.face_forward(pt.ng, ls.wi),
                                      ls.wi)
            occ = isect_any(so, ls.wi, jnp.where(
                want, jnp.minimum(ls.dist * 0.999, 1e30), -1.0))
            # weights: full BDPT for finite lights, PT pair for infinite
            pdf_b = _bsdf_pdf(pt, pt.wo, ls.wi)
            q_p = pt.p + ls.wi * jnp.where(
                jnp.isfinite(ls.dist), ls.dist, 1.0)[..., None]
            tid = lrec[..., 8].astype(jnp.int32)
            tv = scene.tri_shade[jnp.maximum(tid, 0)][..., 0:9]
            ng_q = triangle.geometric_normal(tv[..., 0:3], tv[..., 3:6],
                                             tv[..., 6:9])
            # analytic sphere light: surface normal at the sampled point,
            # origin pdf over the full 4 pi r^2 (tid above is the radius
            # bit-pattern for spheres — ignore it there)
            is_sph_q = ltype == scene_mod.LIGHT_SPHERE_AREA
            ng_sph = vm.normalize(q_p - lrec[..., 1:4])
            ng_q = jnp.where(is_sph_q[..., None], ng_sph, ng_q)
            tri_aq = jnp.maximum(triangle.area(
                tv[..., 0:3], tv[..., 3:6], tv[..., 6:9]), 1e-12)
            origin_aq = _light_origin_area(lrec, tri_aq)
            is_area_q = (ltype == scene_mod.LIGHT_AREA_TRI) | is_sph_q
            q_delta = ls.is_delta
            q_vert = Vertex(
                p=q_p, ns=ng_q, ng=ng_q, wo=-ls.wi, ctx=None,
                beta=ls.li, pdf_fwd=jnp.where(
                    is_area_q, sel_pmf / origin_aq, sel_pmf),
                pdf_rev=jnp.zeros((R,)), delta=q_delta, active=want,
                light=lid, tri_area=origin_aq)
            lig_rev = {0: jnp.where(
                q_delta, 0.0, _to_area(pdf_b, pt.p, q_p, ng_q))}
            pdf_dir_q = _light_dir_pdf(lrec, ng_q, -ls.wi)
            cam_rev = {t_s - 1: _to_area(pdf_dir_q, q_p, pt.p, pt.ng)}
            if t_s >= 2:
                rev_sa = _bsdf_pdf(pt, ls.wi, vm.normalize(pt_prev_p - pt.p))
                cam_rev[t_s - 2] = _to_area(rev_sa, pt.p,
                                            cam_v[t_s - 2].p,
                                            cam_v[t_s - 2].ng)
            w_bdpt = _mis_weight(cam_v, [q_vert], t_s, 1, cam_rev, lig_rev,
                                 q_delta)
            w_pt = jnp.where(ls.is_delta, 1.0,
                             sampling.power_heuristic(1.0, pdf_l, 1.0, pdf_b))
            w = jnp.where(is_inf, w_pt, w_bdpt)
            contrib = pt.beta * f * (cos_pt / pdf_l * w)[..., None] * ls.li
            L = L + jnp.where((want & ~occ)[..., None], contrib, 0.0)

        # ---- s >= 2: connect to a light-subpath vertex --------------------
        for s in range(2, S + 1):
            if s > len(lig_v) or t_s + s > max_depth + 1:
                continue
            qs = lig_v[s - 1]
            qs_prev = lig_v[s - 2]
            wi_c, d2_c = _dirto(pt.p, qs.p)   # pt -> qs
            f_pt = _bsdf_f(pt, pt.wo, wi_c)
            f_qs = _bsdf_f(qs, qs.wo, -wi_c)
            g = vm.absdot(wi_c, pt.ns) * vm.absdot(wi_c, qs.ns) / d2_c
            want = (pt.active & qs.active & jnp.any(f_pt > 0, axis=-1)
                    & jnp.any(f_qs > 0, axis=-1))
            so = vm.offset_ray_origin(pt.p, vm.face_forward(pt.ng, wi_c),
                                      wi_c)
            occ = isect_any(so, wi_c, jnp.where(
                want, jnp.sqrt(d2_c) * 0.998, -1.0))
            # pdf_rev overrides at the 4 connection vertices
            cam_rev = {t_s - 1: _to_area(_bsdf_pdf(qs, qs.wo, -wi_c),
                                         qs.p, pt.p, pt.ng)}
            if t_s >= 2:
                rev_sa = _bsdf_pdf(pt, wi_c, vm.normalize(pt_prev_p - pt.p))
                cam_rev[t_s - 2] = _to_area(
                    rev_sa, pt.p, cam_v[t_s - 2].p, cam_v[t_s - 2].ng)
            lig_rev = {s - 1: _to_area(_bsdf_pdf(pt, pt.wo, wi_c),
                                       pt.p, qs.p, qs.ng)}
            rev_sa_q = (_bsdf_pdf(qs, -wi_c, vm.normalize(qs_prev.p - qs.p))
                        if qs.ctx is not None else jnp.zeros((R,)))
            lig_rev[s - 2] = _to_area(rev_sa_q, qs.p, qs_prev.p, qs_prev.ng)
            w = _mis_weight(cam_v, lig_v, t_s, s, cam_rev, lig_rev,
                            light_delta0)
            contrib = pt.beta * f_pt * f_qs * qs.beta * (g * w)[..., None]
            L = L + jnp.where((want & ~occ)[..., None], contrib, 0.0)

    # ---- t = 1: splat light vertices to the camera ------------------------
    for s in range(2, S + 1):
        if s > len(lig_v) or s > max_depth + 1:
            continue
        qs = lig_v[s - 1]
        qs_prev = lig_v[s - 2]
        to_cam = cam_pos - qs.p
        d2 = jnp.maximum(vm.length_squared(to_cam), 1e-12)
        wi_cam = to_cam * jax.lax.rsqrt(d2)[..., None]
        pix, cos_cam, in_f = camera_project(cam, qs.p)
        f = _bsdf_f(qs, qs.wo, wi_cam)
        cos_q = vm.absdot(wi_cam, qs.ns)
        want = qs.active & in_f & jnp.any(f > 0, axis=-1) & (cos_q > 0)
        so = vm.offset_ray_origin(qs.p, vm.face_forward(qs.ng, wi_cam),
                                  wi_cam)
        occ = isect_any(so, wi_cam, jnp.where(want, jnp.sqrt(d2) * 0.999,
                                              -1.0))
        we = 1.0 / (A * jnp.maximum(cos_cam, 1e-6) ** 4)
        pdf_wi = d2 / jnp.maximum(cos_cam, 1e-6)
        # MIS: camera pdf of the connection direction -> area at qs
        pdf_cam_dir = 1.0 / (A * jnp.maximum(cos_cam, 1e-6) ** 3)
        lig_rev = {s - 1: _to_area(pdf_cam_dir, cam_pos, qs.p, qs.ng)}
        rev_sa_q = _bsdf_pdf(qs, wi_cam, vm.normalize(qs_prev.p - qs.p))
        lig_rev[s - 2] = _to_area(rev_sa_q, qs.p, qs_prev.p, qs_prev.ng)
        w = _mis_weight([], lig_v, 0, s, {}, lig_rev, light_delta0)
        contrib = qs.beta * f * (cos_q * we / pdf_wi * w)[..., None]
        ok = want & ~occ
        splat_pix.append(jnp.where(ok, pix, 0))
        splat_L.append(jnp.where(ok[..., None], contrib, 0.0))

    if splat_pix:
        sp_pix = jnp.concatenate(splat_pix)
        sp_L = jnp.concatenate(splat_L)
        reps = len(splat_pix)
        sp_lam = jnp.tile(lam, (reps, 1))
        sp_lpdf = jnp.tile(lam_pdf, (reps, 1))
    else:
        sp_pix = jnp.zeros((0,), jnp.int32)
        sp_L = jnp.zeros((0, SANS))
        sp_lam = jnp.zeros((0, SANS))
        sp_lpdf = jnp.zeros((0, SANS))
    return L, lam, lam_pdf, sp_pix, sp_L, sp_lam, sp_lpdf


def render_bdpt(scene, dbvh, cam, spp: int = 16, sampler: str = "independent",
                seed: int = 0, cfg: IntegratorConfig = IntegratorConfig()):
    """BDPT render loop: per-pixel strategies into the film plus t=1 camera
    splats (develop with splat_scale = 1/spp, BDPTIntegrator::Render)."""
    R = cam.width * cam.height
    sampler_cfg = samplers.make_sampler(sampler, seed=seed, spp=spp,
                                        width=cam.width)
    film = film_mod.make_film(cam.height, cam.width)
    ls_tables = lightsamplers.build(scene, cfg.light_sampler)
    isect = dispatch.make_intersectors(scene, dbvh, traversal=cfg.traversal)
    scene_d, dbvh_d, ls_d = jax.tree.map(jnp.asarray, (scene, dbvh, ls_tables))

    # big arrays as jit ARGS, not closures (see dispatch.py jit-boundary rule)
    @jax.jit
    def wave(f, s, scene, dbvh, ls_tables, tables):
        pix = jnp.arange(R, dtype=jnp.int32)
        L, lam, lam_pdf, sp_pix, sp_L, sp_lam, sp_lpdf = trace_bdpt_wave(
            scene, dbvh, cam, sampler_cfg, cfg, pix, s, ls_tables,
            isect.bind(tables))
        f = film_mod.add_samples(f, pix, L, lam, lam_pdf, sequential=True)
        if sp_pix.shape[0]:
            f = film_mod.add_splats(f, sp_pix, sp_L, sp_lam, sp_lpdf)
        return f

    for s in range(spp):
        film = wave(film, jnp.int32(s), scene_d, dbvh_d, ls_d, isect.tables)
    return film_mod.develop(film, splat_scale=1.0 / spp)
