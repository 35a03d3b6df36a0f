"""Wavefront path-tracing integrators.

This is the re-design of the reference's wavefront backend
(`wavefront/integrator.cpp:290` stage loop): per sample-per-pixel wave, all
pixels form one dense SoA ray batch; the bounce loop unrolls statically and
every stage (camera rays, intersect, escaped/emissive handling, material eval,
shadow rays, film update) is a fused batched op. The reference's atomic
WorkQueue push/pop (`workqueue.h:92`) becomes lane masking — queues never
materialize; XLA fuses the stage pipeline instead. Film accumulation is a
scatter-add (no AtomicFloat).

Integrator semantics implemented:
- SimplePath (cpu/integrators.h:183): uniform light sampling + BSDF sampling,
  no MIS, no Russian roulette. Emission only on specular/first bounces.
- Path (cpu/integrators.h:207): power-heuristic MIS between light and BSDF
  sampling, Russian roulette on throughput (integrators.cpp:828-area).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import vecmath as vm, sampling, spectrum, samplers, rng
from ..geometry import scene as scene_mod, triangle
from ..scatter import bxdf, lights, lightsamplers
from .. import accel
from ..accel import dispatch, raysort
from . import camera as camera_mod, film as film_mod

Array = jax.Array

# sampler dimension layout per pixel sample (GenerateRaySamples analog,
# wavefront/samples.cpp:19): fixed static schedule
DIM_PIXEL = 0       # 2 dims
DIM_WAVELENGTH = 2  # 1 dim
DIM_LENS = 3        # 2 dims
DIM_PATH_BASE = 5
DIMS_PER_DEPTH = 7  # [bsdf_uc, bsdf_u, bsdf_v, light_select, light_u, light_v, rr]


class IntegratorConfig(NamedTuple):
    max_depth: int = 5
    mis: bool = True              # False = SimplePath semantics
    rr_depth: int = 1             # start RR after this depth (Path only)
    sample_lights: bool = True
    sample_bsdf: bool = True
    light_sampler: str = "power"  # uniform | power | bvh (lightsamplers.h analog)
    kind: str = "path"            # path | simplepath (via mis) | randomwalk |
    #   ao | volpath (wavefront/volpath.py)
    ao_max_dist: float = 1e30     # AOIntegrator maxDistance (cpu/integrators.h:296)
    max_null_steps: int = 64      # cap on null-scattering events per segment
    max_shadow_segments: int = 4  # shadow-ray re-spawns across boundaries
    filt: object = None           # filters.FilterConfig; None = box(0.5) jitter
    collect_stats: bool = False   # per-pixel stats counters (STAT_PIXEL_*
    #   analog, stats.cpp:443): trace_wave returns an extra (R, 4) array
    #   [bounces, shadow_rays, hits, rr_terms]
    traversal: str = "auto"       # "auto" | "xla" | "cuda": how rays meet
    #   the BVH (accel/dispatch.py); auto = XLA walk on CPU, CUDA kernel on GPU
    compact: bool = True          # volpath phase-ladder wavefront
    #   compaction (volpath.make_phased_wave): re-tile the wave to smaller
    #   static shapes as lanes die — the analog of the reference's shrinking
    #   WorkQueue sizes. Requires early_exit; skipped for animated scenes.
    resort: bool = True           # re-sort the LANE STATE each bounce by
    #   (dead, octant, Morton) of the outgoing rays so one argsort serves
    #   every traversal in the bounce, and dead lanes form a suffix (which
    #   the phase ladder slices away). Intersectors then run unsorted.
    early_exit: bool = True       # bounce loop = lax.while_loop that stops
    #   when every lane is dead — the analog of the reference's wavefront
    #   ray queue draining empty (integrator.cpp:374 loop just finds no
    #   work). Essential for maxdepth-100 scenes (crown) where RR kills
    #   ~all paths by depth ~15. MUST be False under jax.grad: while_loop
    #   has no reverse rule (diff paths: learn/joint, tools/crown_grad,
    #   tests/test_diff set it explicitly).


def _filter_jitter(cfg: IntegratorConfig, u2: Array):
    """Filter importance sampling of the in-pixel position (FilterSampler,
    filters.h): returns (pixel-corner offset in [~0,~1]+spill, film weight)."""
    if cfg.filt is None:
        return u2, jnp.ones(u2.shape[:-1], jnp.float32)
    from . import filters

    off, w = filters.sample(cfg.filt, u2)
    return 0.5 + off, w


class ShadingPoint(NamedTuple):
    p: Array       # (R,3) hit position
    ng: Array      # geometric normal (faces the incoming ray side for offsets)
    ns: Array      # interpolated shading normal
    uv: Array      # (R,2)
    mat: Array     # (R,) i32
    prim: Array    # (R,) i32
    light: Array   # (R,) i32 area-light id of the hit triangle (-1 none)
    v0: Array      # (R,3) hit-triangle vertices (for emissive-hit MIS pdf)
    v1: Array
    v2: Array
    uv_scale: Array  # (R,) uv-length per world-length (ray-cone texture LOD)
    t: Array       # (R,) hit distance (cone width accumulation)


def _shading_point(scene: scene_mod.CompiledScene, hit: accel.Hit, o: Array, d: Array) -> ShadingPoint:
    """Hit shading data via ONE fused tri_shade gather (gathers are
    latency-bound; this replaces 5 separate table gathers)."""
    prim = jnp.maximum(hit.prim, 0)
    rec = scene.tri_shade[prim]  # (R, 26)
    v0, v1, v2 = rec[..., 0:3], rec[..., 3:6], rec[..., 6:9]
    b0 = 1.0 - hit.b1 - hit.b2
    p = o + jnp.where(jnp.isfinite(hit.t), hit.t, 0.0)[..., None] * d
    ng = vm.normalize(vm.cross(v1 - v0, v2 - v0))
    ns = vm.normalize(
        b0[..., None] * rec[..., 9:12]
        + hit.b1[..., None] * rec[..., 12:15]
        + hit.b2[..., None] * rec[..., 15:18]
    )
    ns = jnp.where(vm.length_squared(ns)[..., None] < 0.5, ng, ns)
    uv = (
        b0[..., None] * rec[..., 18:20]
        + hit.b1[..., None] * rec[..., 20:22]
        + hit.b2[..., None] * rec[..., 22:24]
    )
    # per-triangle uv-length per world-length: sqrt(uv_area / world_area)
    # (the ray-cone texture-LOD scale; mipmap.h footprint analog)
    duv1 = rec[..., 20:22] - rec[..., 18:20]
    duv2 = rec[..., 22:24] - rec[..., 18:20]
    uv_area = 0.5 * jnp.abs(duv1[..., 0] * duv2[..., 1]
                            - duv1[..., 1] * duv2[..., 0])
    # safe_sqrt everywhere: tris without UVs have uv_area == 0 and padding/
    # degenerate tris have zero geometric area — sqrt'(0) = inf meets the
    # masked lanes' zero cotangent as 0*inf = NaN in the crown-scale pixel
    # gradients (the r4 64x64 NaN hunt)
    w_area = 0.5 * vm.safe_sqrt(vm.length_squared(vm.cross(v1 - v0, v2 - v0)))
    uv_scale = vm.safe_sqrt(uv_area / jnp.maximum(w_area, 1e-20))
    if getattr(scene, "n_quadrics", 0):
        # analytic-quadric lanes (prim >= padded tri count): exact position/
        # normal/uv (geometry/quadrics.py); mat/light/medium already came
        # through the appended tri_shade rows above
        from ..geometry import quadrics as quadrics_mod

        quad_base = scene.tri_p.shape[0]
        is_q = prim >= quad_base
        qidx = jnp.where(is_q, prim - quad_base, 0)
        pq, nq = quadrics_mod.shading(scene.quad_type, scene.quad_params,
                                      qidx, o, d, hit.t,
                                      u=hit.b1, v=hit.b2)
        pq = jnp.where(jnp.isfinite(pq), pq, 0.0)
        isq1 = is_q[..., None]
        p = jnp.where(isq1, pq, p)
        ng = jnp.where(isq1, nq, ng)
        ns = jnp.where(isq1, nq, ns)
        uv = jnp.where(isq1, jnp.stack([hit.b1, hit.b2], -1), uv)
        uv_scale = jnp.where(is_q, scene.quad_uv_scale[qidx], uv_scale)
    return ShadingPoint(
        p=p, ng=ng, ns=ns, uv=uv,
        mat=rec[..., 24].astype(jnp.int32),
        prim=hit.prim,
        light=rec[..., 25].astype(jnp.int32),
        v0=v0, v1=v1, v2=v2,
        uv_scale=uv_scale,
        t=jnp.where(jnp.isfinite(hit.t), hit.t, 0.0),
    )


def trace_wave(
    scene: scene_mod.CompiledScene,
    dbvh: accel.DeviceBVH,
    cam: camera_mod.Camera,
    sampler_cfg: samplers.SamplerConfig,
    cfg: IntegratorConfig,
    pixel_idx: Array,
    sample_idx: Array,
    ls_tables: lightsamplers.LightSamplerTables | None = None,
    isect: "dispatch.Intersectors | None" = None,
):
    """Trace one path per entry of pixel_idx -> (L, lam, lam_pdf, film_w)."""
    if ls_tables is None:
        ls_tables = lightsamplers.build(scene, cfg.light_sampler)
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh,
                                           traversal=cfg.traversal,
                                           sort=not cfg.resort)
    # host-numpy scenes become jnp constants (numpy can't index by tracers)
    scene = jax.tree.map(jnp.asarray, scene)
    dbvh = jax.tree.map(jnp.asarray, dbvh)
    _closest, _any = isect.closest, isect.any_hit
    do_resort = cfg.resort
    sort_blo = jnp.asarray(scene.bounds[0], jnp.float32)
    sort_bext = jnp.maximum(
        jnp.asarray(scene.bounds[1], jnp.float32) - sort_blo, 1e-9)

    # visibility is gradient-detached (SURVEY.md §7.1 diff/: gradients flow
    # through shading, not geometry) — and the traversal while_loop has no
    # reverse rule anyway
    sg = jax.lax.stop_gradient
    isect_closest = lambda *a: jax.tree.map(sg, _closest(*map(sg, a)))
    isect_any = lambda *a: sg(_any(*map(sg, a)))
    R = pixel_idx.shape[0]
    sidx = jnp.broadcast_to(jnp.asarray(sample_idx, jnp.int32), (R,))

    # --- camera rays (kernel 1) ------------------------------------------
    upx, upy = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_PIXEL)
    u_pix, film_w = _filter_jitter(cfg, jnp.stack([upx, upy], -1))
    ulx, uly = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_LENS)
    # shutter time (camera motion blur): a dim consumed ONLY for animated
    # cameras so static scenes keep their exact sample sequences
    animated_cam = cam.motion_keys is not None
    u_time = (samplers.get_1d(sampler_cfg, pixel_idx, sidx, DIM_PATH_BASE)
              if animated_cam else None)
    o, d = camera_mod.generate_rays(
        cam, pixel_idx, u_pix, jnp.stack([ulx, uly], -1), u_time=u_time
    )

    # --- wavelengths ------------------------------------------------------
    ul = samplers.get_1d(sampler_cfg, pixel_idx, sidx, DIM_WAVELENGTH)
    lam, lam_pdf = spectrum.sample_wavelengths_visible(ul)

    S = spectrum.N_SPECTRUM_SAMPLES
    # derive every scan-carry init from a device-varying zero so shard_map's
    # vma rules see consistent carry types (constant-in / varying-out carries
    # are rejected; see accel.traverse._traverse_one for the same trick)
    zv = upx * 0.0
    L = jnp.zeros((R, S), jnp.float32) + zv[:, None]
    beta = jnp.ones((R, S), jnp.float32) + zv[:, None]
    active = zv == 0.0
    specular_prev = zv == 0.0  # camera "bounce" counts as specular
    prev_pdf = 1.0 + zv
    prev_p = o
    eta_scale = 1.0 + zv
    # per-pixel stats accumulators (--pixelstats; util/stats.h:88
    # STAT_PIXEL_COUNTER analog — device counter lanes, no thread-locals)
    st = jnp.zeros((R, 4), jnp.float32) + zv[:, None] if cfg.collect_stats \
        else None
    # ray-cone texture LOD state (geometry/texture.py): width at the ray
    # origin + spread angle; camera spread from the pixel solid angle
    from ..geometry import texture as texture_mod

    cone_w = zv
    cone_s = texture_mod.camera_spread(
        cam.fov if cam.kind == camera_mod.PERSPECTIVE else 60.0,
        cam.height) + zv

    n_lights = scene.n_lights
    mat_all = bxdf.material_records(scene)
    if n_lights > 0:
        light_all = lights.light_records(scene)
        inf_sel_pmf = jnp.sum(
            jnp.where(
                scene.light_type == scene_mod.LIGHT_UNIFORM_INFINITE,
                ls_tables.pmf, 0.0,
            )
        )
        env_sel_pmf = jnp.sum(
            jnp.where(
                scene.light_type == scene_mod.LIGHT_IMAGE_INFINITE,
                ls_tables.pmf, 0.0,
            )
        )
        portal_sel_pmf = jnp.sum(
            jnp.where(
                scene.light_type == scene_mod.LIGHT_PORTAL_ENV,
                ls_tables.pmf, 0.0,
            )
        )
        use_portal = lights.has_portal(scene)

    def add_emission(depth, o, d, L, beta, active, specular_prev, prev_pdf,
                     prev_p, lam):
        """Intersect + escaped-ray + emissive-hit contributions; returns
        (L, found, sp, wo, hit)."""
        t_max = jnp.where(active, 1e30, -1.0)
        hit = isect_closest(o, d, t_max)
        found = active & (hit.prim >= 0)

        # escaped rays: infinite lights (HandleEscapedRays, integrator.cpp:495)
        escaped = active & (hit.prim < 0)
        if n_lights > 0:
            le_inf = lights.infinite_le(scene, d, lam)
            if cfg.mis and cfg.sample_lights:
                pdf_l = sampling.UNIFORM_SPHERE_PDF * inf_sel_pmf
                if lights.has_env_map(scene):
                    pdf_l = pdf_l + env_sel_pmf * lights.env_pdf_dir(scene, d)
                if use_portal:
                    pdf_l = pdf_l + portal_sel_pmf * lights.portal_pdf_dir(
                        scene, light_all, prev_p, d)
                w_mis = jnp.where(
                    specular_prev,
                    1.0,
                    sampling.power_heuristic(
                        1.0, prev_pdf, 1.0, jnp.broadcast_to(pdf_l, (R,))
                    ),
                )
            else:
                w_mis = jnp.where(specular_prev | (not cfg.sample_lights), 1.0, 0.0)
            L = L + jnp.where(escaped[..., None], beta * le_inf * w_mis[..., None], 0.0)

        sp = _shading_point(scene, hit, o, d)
        wo = -d

        # emissive hits (HandleEmissiveIntersection, integrator.cpp:539)
        if n_lights > 0:
            lrec = light_all[jnp.maximum(sp.light, 0)]  # 1 gather
            has_light = found & (sp.light >= 0)
            le = lights.area_light_l_rec(lrec, has_light, sp.ng, wo, lam)
            if cfg.mis and cfg.sample_lights:
                # pdf of the light-sampling strategy for this hit direction:
                # per-triangle solid-angle pdf for mesh lights, analytic cone
                # pdf for sphere shape lights (Sphere::PDF, shapes.h:372)
                pdf_shape = lights.area_pdf_li_from_verts(
                    sp.v0, sp.v1, sp.v2, prev_p)
                is_sph = lrec[..., 0].astype(jnp.int32) \
                    == scene_mod.LIGHT_SPHERE_AREA
                pdf_shape = jnp.where(
                    is_sph, lights.sphere_pdf_li(lrec, prev_p, sp.p, sp.ng),
                    pdf_shape)
                pdf_l = pdf_shape * lightsamplers.pmf_ctx(
                    ls_tables, prev_p, sp.light)
                w_mis = jnp.where(
                    specular_prev,
                    1.0,
                    sampling.power_heuristic(1.0, prev_pdf, 1.0, pdf_l),
                )
            else:
                w_mis = jnp.where(specular_prev | (not cfg.sample_lights), 1.0, 0.0)
            L = L + jnp.where(found[..., None], beta * le * w_mis[..., None], 0.0)
        return L, found, sp, wo

    def bounce(depth, state):
        """One full wavefront bounce. `depth` is a traced loop counter — the
        whole path loop compiles ONCE (lax.scan) instead of unrolling,
        which keeps XLA compile time of the wave under control (an unrolled
        loop compiles the bounce body max_depth times)."""
        (o, d, L, beta, active, specular_prev, prev_pdf, prev_p, eta_scale,
         cone_w, cone_s, st, pixel_idx, lam, perm) = state
        base = DIM_PATH_BASE + (1 if animated_cam else 0) \
            + depth * DIMS_PER_DEPTH

        if do_resort:
            # one argsort per bounce re-clusters the whole lane state (dead
            # lanes + octant/Morton); every traversal below runs pre-sorted
            key = raysort.ray_sort_key(
                jax.lax.stop_gradient(o), jax.lax.stop_gradient(d),
                sort_blo, sort_bext, jnp.where(active, 1.0, -1.0))
            order = jnp.argsort(key)
            (o, d, L, beta, active, specular_prev, prev_pdf, prev_p,
             eta_scale, cone_w, cone_s, st, pixel_idx, lam, perm) = \
                jax.tree.map(lambda a: a[order],
                             (o, d, L, beta, active, specular_prev, prev_pdf,
                              prev_p, eta_scale, cone_w, cone_s, st,
                              pixel_idx, lam, perm))

        L, found, sp, wo = add_emission(
            depth, o, d, L, beta, active, specular_prev, prev_pdf, prev_p, lam
        )
        if cfg.collect_stats:
            st = st.at[:, 0].add(active.astype(jnp.float32))      # bounces
            st = st.at[:, 2].add(found.astype(jnp.float32))       # hits
        active = found

        # material context (one fused gather; MixMaterial resolved per lane)
        u_mix = rng.hash_float(pixel_idx, sidx, jnp.asarray(depth, jnp.uint32),
                               jnp.uint32(0x77))
        cone_at_hit = cone_w + sp.t * cone_s
        foot = texture_mod.cone_foot_log2(
            cone_at_hit, vm.absdot(d, sp.ns), sp.uv_scale)
        ctx = bxdf.gather_material(scene, sp.mat, lam, mat_all, sp.uv, u_mix,
                                   foot_log2=foot)
        active = active & (sp.mat >= 0)
        wo_local = vm.to_local(sp.ns, wo)

        # subsurface transition (SampleSubsurface, wavefront/subsurface.cpp
        # analog): MAT_SUBSURFACE lanes either mirror at the interface or
        # move sp to a BSSRDF-sampled exit point (statically gated)
        if bxdf._feat(scene, "feat_subsurface", scene_mod.MAT_SUBSURFACE):
            from . import subsurface as sss_mod

            sp, ctx, wo_local, beta, active = sss_mod.transition(
                scene, isect_closest, _shading_point, sp, wo, wo_local, ctx,
                lam, beta, active, pixel_idx, sidx, depth)

        # direct lighting (SampleLd, integrators.cpp:764 / TraceShadowRays)
        if cfg.sample_lights and n_lights > 0:
            u_sel = samplers.get_1d(sampler_cfg, pixel_idx, sidx, base + 3)
            ulu, ulv = samplers.get_2d(sampler_cfg, pixel_idx, sidx, base + 4)
            light_id, sel_pmf, _ = lightsamplers.sample_ctx(ls_tables, sp.p, u_sel)
            ls = lights.sample_li(scene, light_all, light_id, sp.p, lam,
                                  jnp.stack([ulu, ulv], -1))
            wi_l = ls.wi
            f_l, pdf_b = bxdf.evaluate(ctx, wo_local, vm.to_local(sp.ns, wi_l))
            cos_l = vm.absdot(wi_l, sp.ns)
            want = active & ls.valid & (cos_l > 0) & jnp.any(f_l > 0, axis=-1)
            ng_o = vm.face_forward(sp.ng, wi_l)
            so = vm.offset_ray_origin(sp.p, ng_o, wi_l)
            s_tmax = jnp.where(want, jnp.minimum(ls.dist * 0.999, 1e30), -1.0)
            occluded = isect_any(so, wi_l, s_tmax)
            if cfg.collect_stats:
                st = st.at[:, 1].add(want.astype(jnp.float32))    # shadow rays
            pdf_light = ls.pdf * sel_pmf
            if cfg.mis:
                w_l = jnp.where(
                    ls.is_delta,
                    1.0,
                    sampling.power_heuristic(1.0, pdf_light, 1.0, pdf_b),
                )
            else:
                w_l = jnp.ones((R,), jnp.float32)
            # double-where: masked lanes must not form the (possibly inf)
            # product at all — its VJP factor times the zero cotangent is
            # 0*inf = NaN. The r5 bisect (tools/crown_grad.py, 64x64 crop,
            # depth 2: finite without NEE, NaN with NEE) localized the crown
            # gradient NaN to THIS block, so every factor is masked before
            # the product, not just the division: a near-delta GGX lobe can
            # make f_l inf on a lane that take later rejects.
            take = want & ~occluded
            w_over = jnp.where(
                take, cos_l * w_l / jnp.maximum(pdf_light, 1e-20), 0.0)
            f_l_m = jnp.where(take[..., None], f_l, 0.0)
            li_m = jnp.where(take[..., None], ls.li, 0.0)
            L = L + beta * f_l_m * w_over[..., None] * li_m

        # BSDF sampling / next bounce (EvaluateMaterialsAndBSDFs, surfscatter.cpp:39)
        uc = samplers.get_1d(sampler_cfg, pixel_idx, sidx, base + 0)
        ubu, ubv = samplers.get_2d(sampler_cfg, pixel_idx, sidx, base + 1)
        if cfg.kind == "randomwalk":
            # RandomWalkIntegrator (cpu/integrators.h:115): uniform-sphere
            # direction, f evaluated, pdf = 1/4pi — the teaching estimator
            wi_rw = sampling.sample_uniform_sphere(jnp.stack([ubu, ubv], -1))
            f_rw, _ = bxdf.evaluate(ctx, wo_local, wi_rw)
            bs = bxdf.BSDFSample(
                wi=wi_rw, f=f_rw,
                pdf=jnp.full((R,), sampling.UNIFORM_SPHERE_PDF),
                specular=jnp.zeros((R,), bool),
                transmission=jnp.zeros((R,), bool),
                eta=jnp.ones((R,)),
                valid=jnp.any(f_rw > 0, axis=-1),
            )
        else:
            bs = bxdf.sample(ctx, wo_local, uc, jnp.stack([ubu, ubv], -1))
        wi_world = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_world, sp.ns)
        inv_pdf_b = jnp.where(bs.valid,
                              1.0 / jnp.maximum(bs.pdf, 1e-20), 0.0)
        beta_new = beta * bs.f * (cos_b * inv_pdf_b)[..., None]
        active = active & bs.valid & jnp.any(beta_new > 0, axis=-1)
        beta = jnp.where(active[..., None], beta_new, beta)
        specular_prev = jnp.where(active, bs.specular, specular_prev)
        prev_pdf = jnp.where(active, bs.pdf, prev_pdf)
        prev_p = jnp.where(active[..., None], sp.p, prev_p)
        eta_scale = jnp.where(active, eta_scale * bs.eta * bs.eta, eta_scale)

        ng_o = vm.face_forward(sp.ng, wi_world)
        o = jnp.where(active[..., None], vm.offset_ray_origin(sp.p, ng_o, wi_world), o)
        d = jnp.where(active[..., None], wi_world, d)
        # cone update: width accumulates; spread widens after the first
        # non-specular bounce (indirect lookups read coarse mips — the
        # wavefront reference similarly degrades differentials per bounce)
        cone_w = jnp.where(active, cone_at_hit, cone_w)
        cone_s = jnp.where(active & ~bs.specular,
                           jnp.maximum(cone_s, 0.25), cone_s)

        # Russian roulette (Path only; integrators.cpp RR on beta*etaScale),
        # gated by the traced depth
        if cfg.mis:
            u_rr = samplers.get_1d(sampler_cfg, pixel_idx, sidx, base + 6)
            m = jnp.max(beta, axis=-1) * eta_scale
            q = jnp.where(depth >= cfg.rr_depth, jnp.maximum(0.0, 1.0 - m), 0.0)
            die = active & (u_rr < q)
            if cfg.collect_stats:
                st = st.at[:, 3].add(die.astype(jnp.float32))     # RR deaths
            active = active & ~die
            beta = jnp.where(
                active[..., None], beta / jnp.maximum(1.0 - q, 1e-6)[..., None], beta
            )

        return (o, d, L, beta, active, specular_prev, prev_pdf, prev_p,
                eta_scale, cone_w, cone_s, st, pixel_idx, lam, perm)

    perm0 = jnp.arange(R, dtype=jnp.int32) + zv.astype(jnp.int32)
    state = (o, d, L, beta, active, specular_prev, prev_pdf, prev_p, eta_scale,
             cone_w, cone_s, st, pixel_idx, lam, perm0)
    if cfg.max_depth > 0:
        if cfg.early_exit:
            # all-dead early exit (active is state[4])
            def wcond(carry):
                depth, s = carry
                return (depth < cfg.max_depth) & jnp.any(s[4])

            def wbody(carry):
                depth, s = carry
                return depth + 1, bounce(depth, s)

            _, state = jax.lax.while_loop(
                wcond, wbody, (jnp.int32(0), state))
        else:
            # lax.scan (not fori_loop): the body compiles once AND reverse-
            # mode autodiff works; jax.checkpoint bounds backward memory to
            # one bounce
            def scan_body(s, depth):
                return bounce(depth, s), None

            state, _ = jax.lax.scan(
                jax.checkpoint(scan_body), state, jnp.arange(cfg.max_depth)
            )
    (o, d, L, beta, active, specular_prev, prev_pdf, prev_p, eta_scale,
     cone_w, cone_s, st, pix_f, lam_f, perm_f) = state
    # trailing emission-only segment (the depth == max_depth break)
    L, _, _, _ = add_emission(
        cfg.max_depth, o, d, L, beta, active, specular_prev, prev_pdf, prev_p,
        lam_f
    )
    # scatter back to caller lane order (perm[i] = original lane of lane i)
    L = jnp.zeros_like(L).at[perm_f].set(L)
    if cfg.collect_stats:
        st = jnp.zeros_like(st).at[perm_f].set(st)
        return L, lam, lam_pdf, film_w, st
    return L, lam, lam_pdf, film_w


def trace_ao(
    scene: scene_mod.CompiledScene,
    dbvh: accel.DeviceBVH,
    cam: camera_mod.Camera,
    sampler_cfg: samplers.SamplerConfig,
    cfg: IntegratorConfig,
    pixel_idx: Array,
    sample_idx: Array,
    isect: "dispatch.Intersectors | None" = None,
):
    """Ambient occlusion (AOIntegrator, cpu/integrators.h:296): cosine-sampled
    visibility within ao_max_dist. Returns (L, lam, lam_pdf)."""
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh,
                                           traversal=cfg.traversal)
    scene = jax.tree.map(jnp.asarray, scene)
    dbvh = jax.tree.map(jnp.asarray, dbvh)
    isect_closest, isect_any = isect.closest, isect.any_hit

    R = pixel_idx.shape[0]
    sidx = jnp.broadcast_to(jnp.asarray(sample_idx, jnp.int32), (R,))
    upx, upy = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_PIXEL)
    u_pix, film_w = _filter_jitter(cfg, jnp.stack([upx, upy], -1))
    ulx, uly = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_LENS)
    # shutter time (camera motion blur): a dim consumed ONLY for animated
    # cameras so static scenes keep their exact sample sequences
    animated_cam = cam.motion_keys is not None
    u_time = (samplers.get_1d(sampler_cfg, pixel_idx, sidx, DIM_PATH_BASE)
              if animated_cam else None)
    o, d = camera_mod.generate_rays(
        cam, pixel_idx, u_pix, jnp.stack([ulx, uly], -1), u_time=u_time
    )
    ul = samplers.get_1d(sampler_cfg, pixel_idx, sidx, DIM_WAVELENGTH)
    lam, lam_pdf = spectrum.sample_wavelengths_visible(ul)

    hit = isect_closest(o, d, jnp.full((R,), 1e30))
    found = hit.prim >= 0
    sp = _shading_point(scene, hit, o, d)
    ns = vm.face_forward(sp.ns, -d)
    u1, u2v = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_PATH_BASE)
    wi = vm.from_local(ns, sampling.sample_cosine_hemisphere(jnp.stack([u1, u2v], -1)))
    so = vm.offset_ray_origin(sp.p, vm.face_forward(sp.ng, wi), wi)
    s_tmax = jnp.where(found, cfg.ao_max_dist, -1.0)
    occ = isect_any(so, wi, s_tmax)
    vis = found & ~occ
    # cosine-sampled estimator of (1/pi) * integral cos * V  ==> visibility
    # flat unit spectrum -> near-white RGB after the sensor; misses are 0
    L = jnp.where(vis[..., None], jnp.ones((R, spectrum.N_SPECTRUM_SAMPLES)), 0.0)
    return L, lam, lam_pdf, film_w


def render_pixel_stats(
    scene: scene_mod.CompiledScene,
    dbvh: accel.DeviceBVH,
    cam: camera_mod.Camera,
    spp: int = 4,
    sampler: str = "sobol",
    seed: int = 0,
    cfg: IntegratorConfig = IntegratorConfig(),
):
    """Per-pixel statistics images (--pixelstats; StatsWritePixelImages,
    stats.cpp:443): returns {"bounces", "shadow_rays", "hits", "rr_terms"}
    as (H, W) float arrays averaged over spp, plus scalar totals."""
    cfg = cfg._replace(collect_stats=True)
    sampler_cfg = samplers.make_sampler(sampler, seed=seed, spp=spp,
                                        width=cam.width)
    R = cam.width * cam.height
    pixel_idx = jnp.arange(R, dtype=jnp.int32)
    ls = lightsamplers.build(scene, cfg.light_sampler)
    isect = dispatch.make_intersectors(scene, dbvh, traversal=cfg.traversal)
    scene_d = jax.tree.map(jnp.asarray, scene)
    dbvh_d = jax.tree.map(jnp.asarray, dbvh)
    ls_d = jax.tree.map(jnp.asarray, ls)

    @partial(jax.jit, static_argnums=())
    def one(s, scene_d, dbvh_d, ls_d, tables):
        out = trace_wave(scene_d, dbvh_d, cam, sampler_cfg, cfg, pixel_idx,
                         s, ls_d, isect.bind(tables))
        return out[4]

    acc = jnp.zeros((R, 4), jnp.float32)
    for s in range(spp):
        acc = acc + one(jnp.int32(s), scene_d, dbvh_d, ls_d, isect.tables)
    acc = acc / spp
    import numpy as np

    imgs = {}
    names = ("bounces", "shadow_rays", "hits", "rr_terms")
    a = np.asarray(acc)
    for i, n in enumerate(names):
        imgs[n] = a[:, i].reshape(cam.height, cam.width)
    totals = {f"stats/{n}": float(a[:, i].sum() * spp)
              for i, n in enumerate(names)}
    return imgs, totals


def render_gbuffer(
    scene: scene_mod.CompiledScene,
    dbvh: accel.DeviceBVH,
    cam: camera_mod.Camera,
):
    """GBufferFilm analog (film.h:319 / VisibleSurface film.h:134): first-hit
    AOVs for denoising + ML — returns a dict of (H,W,C) arrays:
    position(3), normal ns(3), geometric normal(3), uv(2), depth(1),
    albedo(3), hit mask(1). Albedo is the material base color sampled at
    approximate RGB primary wavelengths (the reference estimates rho with 16
    fixed samples, integrators.cpp:1125; first-bounce AOVs need no MC)."""
    isect = dispatch.make_intersectors(scene, dbvh)
    scene = jax.tree.map(jnp.asarray, scene)
    dbvh = jax.tree.map(jnp.asarray, dbvh)
    H, W = cam.height, cam.width
    R = H * W
    pixel_idx = jnp.arange(R, dtype=jnp.int32)
    u_half = jnp.full((R, 2), 0.5, jnp.float32)
    o, d = camera_mod.generate_rays(cam, pixel_idx, u_half, u_half)
    hit = isect.closest(o, d, jnp.full((R,), 1e30))
    found = hit.prim >= 0
    sp = _shading_point(scene, hit, o, d)
    lam_rgb = jnp.broadcast_to(
        jnp.asarray([602.8, 539.1, 448.9, 550.0], jnp.float32), (R, 4))
    ctx = bxdf.gather_material(scene, sp.mat, lam_rgb, None, sp.uv)
    albedo = ctx.refl[..., :3]
    msk = found[..., None]
    shp = lambda a, c: jnp.where(msk, a, 0.0).reshape(H, W, c)
    return {
        "p": shp(sp.p, 3),
        "ns": shp(sp.ns, 3),
        "ng": shp(sp.ng, 3),
        "uv": shp(sp.uv, 2),
        "depth": shp(jnp.where(found, hit.t, 0.0)[..., None], 1),
        "albedo": shp(albedo, 3),
        "mask": shp(found[..., None].astype(jnp.float32), 1),
    }


def make_wave_fn(
    scene: scene_mod.CompiledScene,
    dbvh: accel.DeviceBVH,
    cam: camera_mod.Camera,
    sampler_cfg: samplers.SamplerConfig,
    cfg: IntegratorConfig,
    isect: "dispatch.Intersectors | None" = None,
    sensor=None,
):
    """Build the jitted 1-spp wave function: film, sample_idx -> film.

    The scene/BVH arrays are closed over (donated film threads through), the
    static config (image size, depth, sampler kind) is baked into the trace.
    `isect` overrides the traversal backend (tests / profiling).
    """

    # build host-side tables first, then upload everything exactly once
    ls_tables = lightsamplers.build(scene, cfg.light_sampler)
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh,
                                           traversal=cfg.traversal,
                                           sort=not cfg.resort)
    animated = scene.tri_p_end is not None
    if (cfg.kind in ("volpath", "simplevolpath") and cfg.compact
            and cfg.early_exit and not animated):
        from . import volpath as volpath_mod

        return volpath_mod.make_phased_wave(scene, dbvh, cam, sampler_cfg,
                                            cfg, isect=isect, sensor=sensor)
    scene_d, dbvh_d, ls_d = jax.tree.map(jnp.asarray, (scene, dbvh, ls_tables))

    # every large array crosses the jit boundary as an ARGUMENT: closing over
    # device arrays embeds them as jaxpr constants, and at crown scale
    # (hundreds of MB of tables + tri_shade) that makes compilation explode
    def wave_impl(f: film_mod.Film, sample_idx, scene, dbvh, ls_tables,
                  tables, tables_end):
        if animated:
            # object motion blur: ONE stratified shutter time per wave
            # (AnimatedPrimitive time sampling, cpu/primitive.h; shutter
            # times stratified over spp waves, jittered deterministically).
            # Geometry stays static WITHIN the wave, so the traversal
            # kernels are untouched; tables/vertex records lerp here.
            u = rng.hash_float(
                jnp.asarray([0], jnp.int32),
                jnp.broadcast_to(jnp.asarray(sample_idx, jnp.int32), (1,)),
                jnp.uint32(0x51))[0]
            t = (jnp.asarray(sample_idx, jnp.float32) + u) / sampler_cfg.spp
            lerp = lambda a, b: a + t * (b - a)
            scene = scene.replace(
                tri_p=lerp(scene.tri_p, scene.tri_p_end),
                tri_n=lerp(scene.tri_n, scene.tri_n_end),
                tri_shade=lerp(scene.tri_shade, scene.tri_shade_end))
            tables = dispatch.Intersectors.lerp_tables(tables, tables_end, t)
        bi = isect.bind(tables)
        R = cam.width * cam.height
        pixel_idx = jnp.arange(R, dtype=jnp.int32)
        if cfg.kind == "ao":
            L, lam, lam_pdf, fw = trace_ao(
                scene, dbvh, cam, sampler_cfg, cfg, pixel_idx, sample_idx, bi
            )
        elif cfg.kind in ("volpath", "simplevolpath"):
            from . import volpath as volpath_mod

            L, lam, lam_pdf, fw = volpath_mod.trace_wave_vol(
                scene, dbvh, cam, sampler_cfg, cfg, pixel_idx, sample_idx,
                ls_tables, bi,
            )
        else:
            L, lam, lam_pdf, fw = trace_wave(
                scene, dbvh, cam, sampler_cfg, cfg, pixel_idx, sample_idx,
                ls_tables, bi,
            )
        curves = (jnp.asarray(sensor.curves)
                  if isinstance(sensor, film_mod.MeasuredSensor) else None)
        return film_mod.add_samples(f, pixel_idx, L, lam, lam_pdf,
                                    filter_weight=fw, sequential=True,
                                    sensor_curves=curves)

    jw = jax.jit(wave_impl, donate_argnums=(0,))

    def wave(f: film_mod.Film, sample_idx):
        return jw(f, sample_idx, scene_d, dbvh_d, ls_d, isect.tables,
                  isect.tables_end)

    # wave.lower(film, sample_idx) -> jax Lowered (memory analysis, HLO)
    wave.lower = lambda f, sample_idx: jw.lower(
        f, sample_idx, scene_d, dbvh_d, ls_d, isect.tables, isect.tables_end)
    return wave


def render(
    scene: scene_mod.CompiledScene,
    dbvh: accel.DeviceBVH,
    cam: camera_mod.Camera,
    spp: int = 16,
    sampler: str = "sobol",
    seed: int = 0,
    cfg: IntegratorConfig = IntegratorConfig(),
    wave_callback=None,
    sensor=None,
):
    """Progressive render: one 1-spp wave per jit call (the reference's
    progressive wave loop, cpu/integrators.cpp:162). Returns (H,W,3) linear sRGB.

    wave_callback(sample_index, film) runs after each wave — the hook for the
    tev display stream and --write-partial-images (integrators.cpp:190-215).
    """
    sampler_cfg = samplers.make_sampler(sampler, seed=seed, spp=spp,
                                        width=cam.width)
    film = film_mod.make_film(cam.height, cam.width)
    wave = make_wave_fn(scene, dbvh, cam, sampler_cfg, cfg, sensor=sensor)
    for s in range(spp):
        film = wave(film, jnp.int32(s))
        if wave_callback is not None:
            wave_callback(s, film)
    return film_mod.develop(film, sensor=sensor)
