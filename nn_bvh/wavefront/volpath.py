"""Volumetric wavefront path tracing (VolPath).

Re-design of the reference's VolPathIntegrator (cpu/integrators.cpp:953)
and the wavefront SampleMediumInteraction/SampleMediumScattering stages
(wavefront/media.cpp:22): null-scattering path integral with rescaled path
probabilities (beta, r_u, r_l — all spectral (R,4)) and ratio-tracking
shadow-ray transmittance (VolPathIntegrator::SampleLd, integrators.cpp:1273).

Mapping to batched control flow:
- the reference's per-ray SampleT_maj callback loop (media.h) becomes ONE
  lax.while_loop over the whole dense ray batch with per-lane event masking;
  lanes that finished idle (vector machines pay the max active trip count,
  which is small because the loop count is ~ majorant optical depth);
- `continue` on medium boundaries (SkipIntersection, integrators.cpp:1117)
  becomes an interface-passthrough lane branch that consumes a scan step —
  raise max_depth by the expected number of boundary crossings;
- shadow rays re-spawn across boundaries (SampleLd's while loop) as a
  statically unrolled segment loop (cfg.max_shadow_segments).

The rescaled-probability algebra is transcribed term by term from the
reference (the subtle part — SURVEY.md §7.3):
  null event:    beta *= T_maj sigma_n / pdf, r_u *= T_maj sigma_n / pdf,
                 r_l *= T_maj sigma_maj / pdf,  pdf = T_maj[0] sigma_n[0]
  real scatter:  beta *= T_maj sigma_s / pdf', r_u *= same,
                 pdf' = T_maj[0] sigma_s[0]
  emission:      L += beta T_maj/pdf * sigma_a Le / avg(r_u sigma_maj T_maj/pdf)
  escape/hit Le: L += beta Le / avg(r_u + r_l * p_light)
  NEE:           L += beta f_hat T_ray Li / avg(r_l' + r_u')   (balance MIS)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm, sampling, spectrum, samplers, rng
from ..geometry import scene as scene_mod
from ..scatter import bxdf, lights, lightsamplers, media
from .. import accel
from ..accel import dispatch, raysort
from . import camera as camera_mod
from . import integrator as integrator_mod
from .integrator import (
    DIM_PIXEL, DIM_WAVELENGTH, DIM_LENS, DIM_PATH_BASE, DIMS_PER_DEPTH,
    IntegratorConfig, _shading_point,
)

Array = jax.Array


def _avg(x: Array) -> Array:
    return jnp.mean(x, axis=-1)


def _any_pos(x: Array) -> Array:
    return jnp.any(x > 0, axis=-1)


def trace_wave_vol(
    scene: scene_mod.CompiledScene,
    dbvh: accel.DeviceBVH,
    cam: camera_mod.Camera,
    sampler_cfg: samplers.SamplerConfig,
    cfg: IntegratorConfig,
    pixel_idx: Array,
    sample_idx: Array,
    ls_tables: lightsamplers.LightSamplerTables | None = None,
    isect: "dispatch.Intersectors | None" = None,
    _export: bool = False,
):
    """VolPath: one volumetric path per pixel_idx entry -> (L, lam, pdf, w).

    _export=True returns the size-generic (bounce, init_state) machinery
    instead of tracing a wave — the compacted phase-ladder driver
    (make_phased_wave) re-jits them at shrinking lane counts."""
    if ls_tables is None:
        ls_tables = lightsamplers.build(scene, cfg.light_sampler)
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh,
                                           traversal=cfg.traversal,
                                           sort=not cfg.resort)
    scene = jax.tree.map(jnp.asarray, scene)
    dbvh = jax.tree.map(jnp.asarray, dbvh)
    _closest = isect.closest
    sg = jax.lax.stop_gradient
    isect_closest = lambda *a: jax.tree.map(sg, _closest(*map(sg, a)))
    # in-loop lane-state re-sort (see bounce): ray coherence for traversal,
    # and the dead-lane suffix the phase ladder (make_phased_wave) slices
    do_resort = cfg.resort
    sort_blo = jnp.asarray(scene.bounds[0], jnp.float32)
    sort_bext = jnp.maximum(
        jnp.asarray(scene.bounds[1], jnp.float32) - sort_blo, 1e-9)

    S = spectrum.N_SPECTRUM_SAMPLES
    has_media = scene.n_media > 0
    from ..geometry import texture as texture_mod

    def _rand(pixel_idx, sidx, *salts):
        """Counter-based uniform per lane (the reference seeds a per-segment
        RNG from the sampler, integrators.cpp:975; ours is keyed on the
        pixel/sample/loop counters directly). pixel_idx/sidx ride as
        arguments: the bounce loop re-sorts AND re-tiles the lane state."""
        return rng.hash_float(pixel_idx, sidx, jnp.uint32(sampler_cfg.seed),
                              *[jnp.asarray(s, jnp.uint32) for s in salts])

    def init_state(pixel_idx, sample_idx):
        """Camera rays + wavelengths + all per-lane carries (size-generic)."""
        R = pixel_idx.shape[0]
        sidx = jnp.broadcast_to(jnp.asarray(sample_idx, jnp.int32), (R,))
        upx, upy = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_PIXEL)
        u_pix, film_w = integrator_mod._filter_jitter(
            cfg, jnp.stack([upx, upy], -1))
        ulx, uly = samplers.get_2d(sampler_cfg, pixel_idx, sidx, DIM_LENS)
        o, d = camera_mod.generate_rays(cam, pixel_idx, u_pix,
                                        jnp.stack([ulx, uly], -1))
        ul = samplers.get_1d(sampler_cfg, pixel_idx, sidx, DIM_WAVELENGTH)
        lam, lam_pdf = spectrum.sample_wavelengths_visible(ul)

        # device-varying carry inits (integrator.trace_wave: shard_map vma)
        zv = upx * 0.0
        L = jnp.zeros((R, S), jnp.float32) + zv[:, None]
        beta = jnp.ones((R, S), jnp.float32) + zv[:, None]
        r_u = jnp.ones((R, S), jnp.float32) + zv[:, None]
        r_l = jnp.ones((R, S), jnp.float32) + zv[:, None]
        active = zv == 0.0
        specular_prev = zv == 0.0
        prev_p = o
        eta_scale = 1.0 + zv
        cone_w = zv
        cone_s = texture_mod.camera_spread(
            cam.fov if cam.kind == camera_mod.PERSPECTIVE else 60.0,
            cam.height) + zv
        cur_med = jnp.full((R,), scene.camera_medium, jnp.int32) \
            + zv.astype(jnp.int32)
        perm0 = jnp.arange(R, dtype=jnp.int32) + zv.astype(jnp.int32)
        # per-pixel stats counters (integrator collect_stats analog:
        # [bounces, shadow_rays, hits, rr_terms])
        st0 = (jnp.zeros((R, 4), jnp.float32) + zv[:, None]
               if cfg.collect_stats else None)
        return (o, d, L, beta, r_u, r_l, active, specular_prev, prev_p,
                cur_med, eta_scale, cone_w, cone_s, pixel_idx, lam, perm0,
                st0, sidx, film_w, lam_pdf)

    n_lights = scene.n_lights
    mat_all = bxdf.material_records(scene)
    med_all = media.medium_records(scene) if has_media else None
    if n_lights > 0:
        light_all = lights.light_records(scene)
        inf_sel_pmf = jnp.sum(jnp.where(
            scene.light_type == scene_mod.LIGHT_UNIFORM_INFINITE,
            ls_tables.pmf, 0.0))
        env_sel_pmf = jnp.sum(jnp.where(
            scene.light_type == scene_mod.LIGHT_IMAGE_INFINITE,
            ls_tables.pmf, 0.0))

    # ------------------------------------------------------------------
    # medium event loop along one wavefront segment (SampleT_maj, media.h,
    # with the VolPath callback of integrators.cpp:981-1068 inlined)
    # ------------------------------------------------------------------
    def medium_events(depth, o, d, t_hit, cur_med, beta, r_u, r_l, L, run0,
                      allow_scatter, pixel_idx, sidx, lam):
        R = o.shape[0]
        rand = lambda *salts: _rand(pixel_idx, sidx, *salts)
        ctx = media.gather_medium(scene, cur_med, lam, med_all)
        t0, t1 = media.segment_bounds(ctx, o, d, jnp.where(jnp.isfinite(t_hit), t_hit, 1e30))
        # spectral majorant at unit majorant-density; per-segment majorant =
        # sigma_unit * dda.maj_dens (homogeneous lanes: maj_dens folds in
        # max_density via gather_medium's sigma_maj so reuse that)
        is_grid = ctx.med_type == scene_mod.MED_GRID
        sigma_unit = jnp.where(is_grid[..., None],
                               ctx.sigma_a + ctx.sigma_s, ctx.sigma_maj)
        run0 = run0 & ctx.valid & (t1 > t0) & (ctx.sigma_maj[..., 0] > 1e-18)
        dda0 = media.dda_init(scene, ctx, o, d, t0, t1)

        zeros_b = jnp.zeros((R,), bool)
        init = dict(
            t=t0, step=jnp.int32(0), running=run0,
            scattered=zeros_b, terminated=zeros_b,
            p_scat=o, beta=beta, r_u=r_u, r_l=r_l, L=L,
            T_final=jnp.ones((R, S), jnp.float32),
            T_acc=jnp.ones((R, S), jnp.float32),
            dda=dda0,
        )

        def cond(s):
            return jnp.any(s["running"]) & (s["step"] < cfg.max_null_steps)

        def body(s):
            run = s["running"]
            dda = s["dda"]
            sigma_maj = sigma_unit * dda.maj_dens[..., None]
            maj0 = sigma_maj[..., 0]
            seg_end = jnp.minimum(dda.seg_end, t1)
            u = rand(depth, s["step"], 101)
            dt = jnp.where(maj0 > 1e-18, -jnp.log1p(-u) / maj0, 2e30)
            t_new = s["t"] + dt
            # three outcomes: event inside this majorant segment, cross into
            # the next supervoxel (grid media), or exit the medium span
            crossed = run & (t_new >= seg_end) & (seg_end < t1)
            exited = run & (t_new >= seg_end) & ~crossed
            t_stop = jnp.minimum(t_new, seg_end)
            seg_dt = t_stop - s["t"]
            T_step = jnp.exp(-sigma_maj * seg_dt[..., None])
            # transmittance accumulated SINCE THE LAST EVENT (media.h
            # SampleT_maj resets T_maj to 1 after each callback); piecewise
            # majorants multiply across supervoxel crossings
            T_ev = s["T_acc"] * T_step
            p = o + t_new[..., None] * d
            dens = media.density(scene, ctx, p)
            sig_a = ctx.sigma_a * dens[..., None]
            sig_s = ctx.sigma_s * dens[..., None]
            ev = run & ~exited & ~crossed

            # emission at the event point (integrators.cpp:990-1001)
            pdf_e = maj0 * T_ev[..., 0]
            betap = s["beta"] * T_ev / jnp.maximum(pdf_e, 1e-30)[..., None]
            r_e = s["r_u"] * sigma_maj * T_ev / jnp.maximum(pdf_e, 1e-30)[..., None]
            r_e_avg = _avg(r_e)
            le_pt = media.le_at(scene, ctx, p, lam)
            emit_ok = ev & _any_pos(le_pt) & (r_e_avg > 0)
            L_new = s["L"] + jnp.where(
                emit_ok[..., None],
                betap * sig_a * le_pt / jnp.maximum(r_e_avg, 1e-30)[..., None],
                0.0,
            )

            # event type (integrators.cpp:1004-1011)
            maj0_safe = jnp.maximum(maj0, 1e-30)
            p_absorb = sig_a[..., 0] / maj0_safe
            p_scatter = sig_s[..., 0] / maj0_safe
            um = rand(depth, s["step"], 202)
            absorb = ev & (um < p_absorb)
            scat = ev & ~absorb & (um < p_absorb + p_scatter)
            null = ev & ~absorb & ~scat
            if not allow_scatter:
                # the reference terminates scatter events past max depth
                # (integrators.cpp:1020)
                absorb = absorb | scat
                scat = zeros_b

            # real scatter (integrators.cpp:1026-1028)
            pdf_s = jnp.maximum(T_ev[..., 0] * sig_s[..., 0], 1e-30)
            f_s = T_ev * sig_s / pdf_s[..., None]
            # null scatter (integrators.cpp:1058-1065)
            sig_n = jnp.maximum(sigma_maj - sig_a - sig_s, 0.0)
            pdf_n = T_ev[..., 0] * sig_n[..., 0]
            f_n = jnp.where(
                (pdf_n > 0)[..., None],
                T_ev * sig_n / jnp.maximum(pdf_n, 1e-30)[..., None], 0.0)
            r_un = T_ev * sig_n / jnp.maximum(pdf_n, 1e-30)[..., None]
            r_ln = T_ev * sigma_maj / jnp.maximum(pdf_n, 1e-30)[..., None]

            beta_new = jnp.where(scat[..., None], s["beta"] * f_s,
                                 jnp.where(null[..., None], s["beta"] * f_n, s["beta"]))
            r_u_new = jnp.where(scat[..., None], s["r_u"] * f_s,
                                jnp.where(null[..., None], s["r_u"] * r_un, s["r_u"]))
            r_l_new = jnp.where(null[..., None], s["r_l"] * r_ln, s["r_l"])

            dead_null = null & ~(_any_pos(beta_new) & _any_pos(r_u_new))
            T_fin = jnp.where(exited[..., None], T_ev, s["T_final"])
            # carry: events reset the accumulated T; crossings accumulate it
            T_acc_new = jnp.where(ev[..., None], 1.0,
                                  jnp.where(crossed[..., None], T_ev,
                                            s["T_acc"]))
            dda_new = media.dda_advance(scene, ctx, dda, t1, crossed)
            return dict(
                t=jnp.where(run, t_stop, s["t"]),
                step=s["step"] + 1,
                running=run & ((null & ~dead_null) | crossed),
                scattered=s["scattered"] | scat,
                terminated=s["terminated"] | absorb | dead_null,
                p_scat=jnp.where(scat[..., None], p, s["p_scat"]),
                beta=beta_new, r_u=r_u_new, r_l=r_l_new, L=L_new,
                T_final=T_fin, T_acc=T_acc_new, dda=dda_new,
            )

        s = jax.lax.while_loop(cond, body, init)
        # lanes still running at the step cap: treat as absorbed (bounded loss)
        terminated = s["terminated"] | s["running"]
        # residual segment factor T_maj/T_maj[0] for unscattered survivors
        # (integrators.cpp:1075-1077)
        no_event = run0 & ~s["scattered"] & ~terminated
        tf = s["T_final"]
        tf0 = jnp.maximum(tf[..., 0:1], 1e-30)
        beta = jnp.where(no_event[..., None], s["beta"] * tf / tf0, s["beta"])
        r_u = jnp.where(no_event[..., None], s["r_u"] * tf / tf0, s["r_u"])
        r_l = jnp.where(no_event[..., None], s["r_l"] * tf / tf0, s["r_l"])
        return s["scattered"], terminated, s["p_scat"], beta, r_u, r_l, s["L"]

    # ------------------------------------------------------------------
    # ratio-tracking shadow transmittance (SampleLd loop, integrators.cpp:1331)
    # ------------------------------------------------------------------
    def shadow_transmit(depth, o0, wi, dist, med0, want, pixel_idx, sidx,
                        lam):
        R = o0.shape[0]
        rand = lambda *salts: _rand(pixel_idx, sidx, *salts)
        T_ray = jnp.ones((R, S), jnp.float32)
        r_lt = jnp.ones((R, S), jnp.float32)
        r_ut = jnp.ones((R, S), jnp.float32)
        seg_o = o0
        t_rem = jnp.where(jnp.isfinite(dist), dist * 0.999, 1e30)
        med = med0
        alive = want
        n_segments = cfg.max_shadow_segments if has_media else 1

        def seg_step(seg, carry):
            (T_ray, r_lt, r_ut, seg_o, t_rem, med, alive) = carry
            t_max = jnp.where(alive, t_rem, -1.0)
            hit = isect_closest(seg_o, wi, t_max)
            hit_found = alive & (hit.prim >= 0)
            rec = scene.tri_shade[jnp.maximum(hit.prim, 0)]
            mat = rec[..., 24].astype(jnp.int32)
            opaque = hit_found & (mat >= 0)
            T_ray = jnp.where(opaque[..., None], 0.0, T_ray)
            alive = alive & ~opaque
            t_end = jnp.where(hit_found & ~opaque, hit.t, t_rem)

            if has_media:
                ctx = media.gather_medium(scene, med, lam, med_all)
                t0, t1 = media.segment_bounds(ctx, seg_o, wi, t_end)
                is_grid_s = ctx.med_type == scene_mod.MED_GRID
                sigma_unit = jnp.where(is_grid_s[..., None],
                                       ctx.sigma_a + ctx.sigma_s,
                                       ctx.sigma_maj)
                run0 = alive & ctx.valid & (med >= 0) & (t1 > t0) \
                    & (ctx.sigma_maj[..., 0] > 1e-18)
                init = dict(t=t0, step=jnp.int32(0), running=run0,
                            T_ray=T_ray, r_l=r_lt, r_u=r_ut,
                            T_final=jnp.ones((R, S), jnp.float32),
                            T_acc=jnp.ones((R, S), jnp.float32),
                            dda=media.dda_init(scene, ctx, seg_o, wi, t0, t1))

                def cond(s):
                    return jnp.any(s["running"]) & (s["step"] < cfg.max_null_steps)

                def body(s, _seg=seg):
                    run = s["running"]
                    dda = s["dda"]
                    sigma_maj = sigma_unit * dda.maj_dens[..., None]
                    maj0 = sigma_maj[..., 0]
                    seg_end2 = jnp.minimum(dda.seg_end, t1)
                    u = rand(depth, s["step"], 303, _seg)
                    dt = jnp.where(maj0 > 1e-18, -jnp.log1p(-u) / maj0, 2e30)
                    t_new = s["t"] + dt
                    crossed = run & (t_new >= seg_end2) & (seg_end2 < t1)
                    exited = run & (t_new >= seg_end2) & ~crossed
                    t_stop = jnp.minimum(t_new, seg_end2)
                    seg_dt = t_stop - s["t"]
                    T_ev = s["T_acc"] * jnp.exp(-sigma_maj * seg_dt[..., None])
                    p = seg_o + t_new[..., None] * wi
                    dens = media.density(scene, ctx, p)
                    sig_a = ctx.sigma_a * dens[..., None]
                    sig_s = ctx.sigma_s * dens[..., None]
                    sig_n = jnp.maximum(sigma_maj - sig_a - sig_s, 0.0)
                    ev = run & ~exited & ~crossed
                    pdf = jnp.maximum(T_ev[..., 0] * maj0, 1e-30)
                    T_new = jnp.where(
                        ev[..., None],
                        s["T_ray"] * T_ev * sig_n / pdf[..., None], s["T_ray"])
                    rl_new = jnp.where(
                        ev[..., None],
                        s["r_l"] * T_ev * sigma_maj / pdf[..., None], s["r_l"])
                    ru_new = jnp.where(
                        ev[..., None],
                        s["r_u"] * T_ev * sig_n / pdf[..., None], s["r_u"])
                    # Russian roulette on low transmittance
                    # (integrators.cpp:1357-1364)
                    tr = T_new / jnp.maximum(_avg(rl_new + ru_new), 1e-30)[..., None]
                    low = ev & (jnp.max(tr, axis=-1) < 0.05)
                    u_rr = rand(depth, s["step"], 404, _seg)
                    killed = low & (u_rr < 0.75)
                    T_new = jnp.where(killed[..., None], 0.0,
                                      jnp.where((low & ~killed)[..., None],
                                                T_new / 0.25, T_new))
                    T_fin = jnp.where(exited[..., None], T_ev,
                                      s["T_final"])
                    T_acc_new = jnp.where(ev[..., None], 1.0,
                                          jnp.where(crossed[..., None], T_ev,
                                                    s["T_acc"]))
                    dda_new = media.dda_advance(scene, ctx, dda, t1, crossed)
                    return dict(
                        t=jnp.where(run, t_stop, s["t"]), step=s["step"] + 1,
                        running=run & ((ev & _any_pos(T_new)) | crossed),
                        T_ray=T_new, r_l=rl_new, r_u=ru_new, T_final=T_fin,
                        T_acc=T_acc_new, dda=dda_new,
                    )

                s = jax.lax.while_loop(cond, body, init)
                tf = s["T_final"]
                tf0 = jnp.maximum(tf[..., 0:1], 1e-30)
                ok = run0[..., None]
                T_ray = jnp.where(ok, s["T_ray"] * tf / tf0, T_ray)
                r_lt = jnp.where(ok, s["r_l"] * tf / tf0, r_lt)
                r_ut = jnp.where(ok, s["r_u"] * tf / tf0, r_ut)
                alive = alive & _any_pos(T_ray)

            # advance through the (non-opaque) boundary; crossing updates
            # the medium (SpawnRayTo re-spawn, integrators.cpp:1381)
            cross = hit_found & ~opaque
            if has_media:
                b0 = 1.0 - hit.b1 - hit.b2  # noqa: F841 (kept for clarity)
                v0, v1, v2 = rec[..., 0:3], rec[..., 3:6], rec[..., 6:9]
                ng = vm.normalize(vm.cross(v1 - v0, v2 - v0))
                med_in = rec[..., 26].astype(jnp.int32)
                med_out = rec[..., 27].astype(jnp.int32)
                med = jnp.where(
                    cross, jnp.where(vm.dot(wi, ng) < 0, med_in, med_out), med)
                p_hit = seg_o + hit.t[..., None] * wi
                seg_o = jnp.where(
                    cross[..., None],
                    vm.offset_ray_origin(p_hit, vm.face_forward(ng, wi), wi),
                    seg_o)
                t_rem = jnp.where(cross, t_rem - hit.t, t_rem)
            alive = alive & cross
            return (T_ray, r_lt, r_ut, seg_o, t_rem, med, alive)

        carry = (T_ray, r_lt, r_ut, seg_o, t_rem, med, alive)
        for seg in range(n_segments):
            if seg == 0:
                carry = seg_step(seg, carry)
            else:
                # later segments only matter for lanes that crossed a
                # transmissive boundary — usually none. lax.cond skips the
                # whole traversal+media walk when nobody is alive (the
                # reference's SampleLd while loop just doesn't iterate,
                # integrators.cpp:1331).
                carry = jax.lax.cond(
                    jnp.any(carry[6]),
                    lambda c, _s=seg: seg_step(_s, c),
                    lambda c: c, carry)
        return carry[0], carry[1], carry[2]

    # ------------------------------------------------------------------
    # NEE with transmittance (VolPathIntegrator::SampleLd)
    # ------------------------------------------------------------------
    def sample_ld(depth, p_ref, ns, wo_world, ctx_mat, is_med, g_med, cur_med,
                  want, beta, r_p, L, pixel_idx, sidx, lam):
        rand = lambda *salts: _rand(pixel_idx, sidx, *salts)
        if n_lights == 0:
            return L
        u_sel = rand(depth, 11)
        ulu = rand(depth, 12)
        ulv = rand(depth, 13)
        light_id, sel_pmf, _ = lightsamplers.sample_ctx(ls_tables, p_ref, u_sel)
        ls = lights.sample_li(scene, light_all, light_id, p_ref, lam,
                              jnp.stack([ulu, ulv], -1))
        wi_l = ls.wi
        # f_hat + scatter pdf: BSDF on surface lanes, HG phase on medium lanes
        wi_local = vm.to_local(ns, wi_l)
        wo_local = vm.to_local(ns, wo_world)
        f_b, pdf_b = bxdf.evaluate(ctx_mat, wo_local, wi_local)
        cos_l = vm.absdot(wi_l, ns)
        f_surf = f_b * cos_l[..., None]
        ph = media.phase_p(wo_world, wi_l, g_med)
        f_hat = jnp.where(is_med[..., None],
                          jnp.broadcast_to(ph[..., None], f_surf.shape), f_surf)
        scatter_pdf = jnp.where(is_med, ph, pdf_b)
        want = want & ls.valid & _any_pos(f_hat)

        ng_o = vm.face_forward(ns, wi_l)
        so = jnp.where(is_med[..., None], p_ref,
                       vm.offset_ray_origin(p_ref, ng_o, wi_l))
        T_ray, r_lt, r_ut = shadow_transmit(depth, so, wi_l, ls.dist, cur_med,
                                            want, pixel_idx, sidx, lam)
        p_l = sel_pmf * ls.pdf
        r_l_f = r_lt * r_p * p_l[..., None]
        r_u_f = r_ut * r_p * scatter_pdf[..., None]
        denom_delta = _avg(r_l_f)
        denom_full = _avg(r_l_f + r_u_f)
        denom = jnp.where(ls.is_delta, denom_delta, denom_full)
        ok = want & (denom > 0) & _any_pos(T_ray)
        # masked-lane product hygiene (see integrator.py NEE block / the r5
        # 64x64 gradient bisect): every possibly-inf factor is zeroed on
        # rejected lanes BEFORE the product so VJPs never see 0 * inf
        f_m = jnp.where(ok[..., None], f_hat, 0.0)
        li_m = jnp.where(ok[..., None], ls.li, 0.0)
        contrib = beta * f_m * T_ray * li_m / jnp.maximum(denom, 1e-30)[..., None]
        return L + contrib

    # ------------------------------------------------------------------
    # escaped / emissive-hit contributions with rescaled MIS
    # ------------------------------------------------------------------
    def add_emission(depth, o, d, t_hit_state, L, beta, r_u, r_l, active,
                     specular_prev, prev_p, sp, found, lam):
        R = o.shape[0]
        escaped = active & ~found
        if n_lights > 0:
            le_inf = lights.infinite_le(scene, d, lam)
            p_li = sampling.UNIFORM_SPHERE_PDF * inf_sel_pmf
            if lights.has_env_map(scene):
                p_li = p_li + env_sel_pmf * lights.env_pdf_dir(scene, d)
            p_li = jnp.broadcast_to(p_li, (R,))
            denom_spec = _avg(r_u)
            denom_mis = _avg(r_u + r_l * p_li[..., None])
            denom = jnp.where(specular_prev, denom_spec, denom_mis)
            L = L + jnp.where(
                (escaped & (denom > 0))[..., None],
                beta * le_inf / jnp.maximum(denom, 1e-30)[..., None], 0.0)

            # emissive surface hit (integrators.cpp:1100-1111)
            lrec = light_all[jnp.maximum(sp.light, 0)]
            has_light = found & (sp.light >= 0)
            le = lights.area_light_l_rec(lrec, has_light, sp.ng, -d, lam)
            p_shape = lights.area_pdf_li_from_verts(sp.v0, sp.v1, sp.v2, prev_p)
            p_shape = jnp.where(
                lrec[..., 0].astype(jnp.int32) == scene_mod.LIGHT_SPHERE_AREA,
                lights.sphere_pdf_li(lrec, prev_p, sp.p, sp.ng), p_shape)
            p_le = p_shape * lightsamplers.pmf_ctx(ls_tables, prev_p, sp.light)
            denom_mis2 = _avg(r_u + r_l * p_le[..., None])
            denom2 = jnp.where(specular_prev, _avg(r_u), denom_mis2)
            L = L + jnp.where(
                (has_light & (denom2 > 0))[..., None],
                beta * le / jnp.maximum(denom2, 1e-30)[..., None], 0.0)
        return L

    # ------------------------------------------------------------------
    # one volumetric wavefront bounce
    # ------------------------------------------------------------------
    def bounce(depth, state, allow_scatter=True):
        (o, d, L, beta, r_u, r_l, active, specular_prev, prev_p, cur_med,
         eta_scale, cone_w, cone_s, pixel_idx, lam, perm, st, sidx, film_w,
         lam_pdf) = state
        R = o.shape[0]

        if do_resort and allow_scatter:
            # re-sort the WHOLE lane state by (dead, octant, Morton) of the
            # rays about to be traced: one argsort serves every traversal in
            # this bounce (path closest + all shadow segments), where per-call
            # sort wrappers would pay it 5x. perm tracks lanes back to caller
            # order.
            key = raysort.ray_sort_key(
                jax.lax.stop_gradient(o), jax.lax.stop_gradient(d),
                sort_blo, sort_bext, jnp.where(active, 1.0, -1.0))
            order = jnp.argsort(key)
            (o, d, L, beta, r_u, r_l, active, specular_prev, prev_p,
             cur_med, eta_scale, cone_w, cone_s, pixel_idx, lam, perm, st,
             sidx, film_w, lam_pdf) = \
                jax.tree.map(lambda a: a[order],
                             (o, d, L, beta, r_u, r_l, active, specular_prev,
                              prev_p, cur_med, eta_scale, cone_w, cone_s,
                              pixel_idx, lam, perm, st, sidx, film_w,
                              lam_pdf))

        t_max = jnp.where(active, 1e30, -1.0)
        hit = isect_closest(o, d, t_max)
        found = active & (hit.prim >= 0)
        t_hit = jnp.where(found, hit.t, jnp.inf)
        if cfg.collect_stats:
            st = st.at[:, 0].add(active.astype(jnp.float32))
            st = st.at[:, 2].add(found.astype(jnp.float32))

        # --- medium segment sampling ---------------------------------
        if has_media:
            run_med = active & (cur_med >= 0)
            scattered, med_term, p_scat, beta, r_u, r_l, L = medium_events(
                depth, o, d, t_hit, cur_med, beta, r_u, r_l, L, run_med,
                allow_scatter, pixel_idx, sidx, lam)
            active = active & ~med_term
        else:
            scattered = jnp.zeros((R,), bool)
            p_scat = o

        sp = _shading_point(scene, hit, o, d)
        surf_found = found & ~scattered & active

        # --- Le from escapes and emissive hits -----------------------
        L = add_emission(depth, o, d, t_hit, L, beta, r_u, r_l,
                         active & ~scattered, specular_prev, prev_p, sp,
                         surf_found, lam)
        if not allow_scatter:
            return (o, d, L, beta, r_u, r_l, active, specular_prev, prev_p,
                    cur_med, eta_scale, cone_w, cone_s, pixel_idx, lam, perm,
                    st, sidx, film_w, lam_pdf)

        wo = -d
        cone_at_hit = cone_w + sp.t * cone_s
        foot = texture_mod.cone_foot_log2(
            cone_at_hit, vm.absdot(d, sp.ns), sp.uv_scale)
        ctx = bxdf.gather_material(scene, sp.mat, lam, mat_all, sp.uv,
                                   _rand(pixel_idx, sidx, depth, 31),
                                   foot_log2=foot)
        is_interface = surf_found & (sp.mat < 0)
        surf_lane = surf_found & (sp.mat >= 0)

        # --- NEE (shared surface/medium SampleLd) --------------------
        if cfg.sample_lights and n_lights > 0:
            g_med = (media.gather_medium(scene, cur_med, lam, med_all).g
                     if has_media else jnp.zeros((R,)))
            p_ref = jnp.where(scattered[..., None], p_scat, sp.p)
            ns_ld = jnp.where(scattered[..., None],
                              jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), sp.ns.shape),
                              sp.ns)
            L = sample_ld(depth, p_ref, ns_ld, wo, ctx, scattered, g_med,
                          cur_med, (surf_lane | scattered), beta, r_u, L,
                          pixel_idx, sidx, lam)
            if cfg.collect_stats:
                st = st.at[:, 1].add(
                    (surf_lane | scattered).astype(jnp.float32))

        # --- medium lanes: phase-function direction ------------------
        u_ph = jnp.stack([_rand(pixel_idx, sidx, depth, 21),
                          _rand(pixel_idx, sidx, depth, 22)], -1)
        g_all = (media.gather_medium(scene, cur_med, lam, med_all).g
                 if has_media else jnp.zeros((R,)))
        wi_ph, pdf_ph = media.phase_sample(wo, u_ph, g_all)
        # p == pdf for HG -> beta unchanged, r_l = r_u / pdf
        # (integrators.cpp:1044-1045)

        # --- surface lanes: BSDF sample -------------------------------
        base = DIM_PATH_BASE + depth * DIMS_PER_DEPTH
        uc = samplers.get_1d(sampler_cfg, pixel_idx, sidx, base + 0)
        ubu, ubv = samplers.get_2d(sampler_cfg, pixel_idx, sidx, base + 1)
        wo_local = vm.to_local(sp.ns, wo)
        bs = bxdf.sample(ctx, wo_local, uc, jnp.stack([ubu, ubv], -1))
        wi_surf = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_surf, sp.ns)

        # --- merge lane branches --------------------------------------
        # next direction
        d_new = jnp.where(scattered[..., None], wi_ph,
                          jnp.where(is_interface[..., None], d, wi_surf))
        # throughput update (surface only; medium scatter & interface keep beta)
        f_over = bs.f * (cos_b / jnp.maximum(bs.pdf, 1e-20))[..., None]
        beta = jnp.where(surf_lane[..., None] & (bs.valid[..., None]),
                         beta * f_over, beta)
        # rescaled light probability for the *next* vertex MIS
        pdf_fwd = jnp.where(scattered, pdf_ph, bs.pdf)
        r_l_new = r_u / jnp.maximum(pdf_fwd, 1e-20)[..., None]
        took_bounce = scattered | surf_lane
        r_l = jnp.where(took_bounce[..., None], r_l_new, r_l)

        # survival
        live_surf = surf_lane & bs.valid & _any_pos(beta)
        live = scattered | live_surf | is_interface
        active = active & live

        # origins
        p_surf = sp.p
        ng_o = vm.face_forward(sp.ng, d_new)
        o_surf = vm.offset_ray_origin(p_surf, ng_o, d_new)
        o_new = jnp.where(scattered[..., None], p_scat, o_surf)
        o = jnp.where(active[..., None], o_new, o)
        d = jnp.where(active[..., None], d_new, d)

        # medium crossings: interface passthrough or real transmission
        if has_media:
            crossing = is_interface | (surf_lane & bs.transmission)
            rec_med_in = scene.tri_shade[jnp.maximum(hit.prim, 0), 26].astype(jnp.int32)
            rec_med_out = scene.tri_shade[jnp.maximum(hit.prim, 0), 27].astype(jnp.int32)
            new_med = jnp.where(vm.dot(d_new, sp.ng) < 0, rec_med_in, rec_med_out)
            cur_med = jnp.where(crossing, new_med, cur_med)

        specular_prev = jnp.where(scattered, False,
                                  jnp.where(surf_lane, bs.specular, specular_prev))
        cone_w = jnp.where(surf_lane | scattered, cone_at_hit, cone_w)
        cone_s = jnp.where((surf_lane & ~bs.specular) | scattered,
                           jnp.maximum(cone_s, 0.25), cone_s)
        prev_p = jnp.where(took_bounce[..., None],
                           jnp.where(scattered[..., None], p_scat, p_surf), prev_p)
        eta_scale = jnp.where(surf_lane & bs.transmission,
                              eta_scale * bs.eta * bs.eta, eta_scale)

        # Russian roulette on beta*etaScale/avg(r_u) (integrators.cpp:1259)
        u_rr = samplers.get_1d(sampler_cfg, pixel_idx, sidx, base + 6)
        rr = jnp.max(beta, axis=-1) * eta_scale / jnp.maximum(_avg(r_u), 1e-30)
        q = jnp.where(depth >= cfg.rr_depth, jnp.maximum(0.0, 1.0 - rr), 0.0)
        die = active & (u_rr < q)
        if cfg.collect_stats:
            st = st.at[:, 3].add(die.astype(jnp.float32))
        active = active & ~die
        beta = jnp.where(active[..., None],
                         beta / jnp.maximum(1.0 - q, 1e-6)[..., None], beta)

        return (o, d, L, beta, r_u, r_l, active, specular_prev, prev_p,
                cur_med, eta_scale, cone_w, cone_s, pixel_idx, lam, perm, st,
                sidx, film_w, lam_pdf)

    if _export:
        return bounce, init_state

    state = init_state(pixel_idx, sample_idx)
    lam, lam_pdf, film_w = state[14], state[19], state[18]
    if cfg.max_depth > 0:
        if cfg.early_exit:
            # all-dead early exit (active is state[6]); the analog of the
            # reference's wavefront ray queue draining empty. Crown renders
            # with maxdepth 100 but RR kills ~all paths by ~15 bounces.
            def wcond(carry):
                depth, s = carry
                return (depth < cfg.max_depth) & jnp.any(s[6])

            def wbody(carry):
                depth, s = carry
                return depth + 1, bounce(depth, s)

            _, state = jax.lax.while_loop(
                wcond, wbody, (jnp.int32(0), state))
        else:
            def scan_body(s, depth):
                return bounce(depth, s), None

            state, _ = jax.lax.scan(
                jax.checkpoint(scan_body), state, jnp.arange(cfg.max_depth)
            )
    # trailing emission-only segment (scatter events past max depth terminate)
    state = bounce(jnp.int32(cfg.max_depth), state, allow_scatter=False)
    Lp, perm_f, st_f = state[2], state[15], state[16]
    # scatter radiance back to caller lane order (perm[i] = original lane)
    L = jnp.zeros_like(Lp).at[perm_f].set(Lp)
    if cfg.collect_stats:
        st_f = jnp.zeros_like(st_f).at[perm_f].set(st_f)
        return L, lam, lam_pdf, film_w, st_f
    return L, lam, lam_pdf, film_w


# ---------------------------------------------------------------------------
# Compacted phase-ladder wave driver
# ---------------------------------------------------------------------------

def _align(n: int, g: int = 4096) -> int:
    # ladder floor and step: rounding lane counts to multiples of 4096
    # bounds how many phase shapes (and so compiles) a render can need
    return max(g, -(-n // g) * g)


def make_phased_wave(scene, dbvh, cam, sampler_cfg, cfg, isect=None,
                     sensor=None, phase_len: int = 8,
                     ladder_shrink: int = 2, verbose: bool = False):
    """Wavefront COMPACTION for deep-path scenes (crown: maxdepth 100).

    The dense-lane wave pays O(R) shading/sampling vector work at EVERY
    bounce even when RR/absorption has killed almost every lane — on crown,
    bounces 20..100 are ~70% of wave time at <5% occupancy. The reference
    never pays this: its WorkQueue sizes shrink as rays die
    (wavefront/workqueue.h:42 — ForAllQueued loops over Size(), not
    capacity). This driver is the analog: the bounce loop runs in
    PHASES of `phase_len` bounces; after each phase the lane state
    (dead-partitioned by the in-loop resort) is sliced to the smallest
    ladder size holding every live lane, and the jitted phase function is
    re-invoked at that smaller static shape (one compile per ladder size,
    cached across waves). Dead lanes sliced away carry final radiance;
    their film contribution is accumulated immediately.

    Returns wave(film, sample_idx) -> film.
    """
    from . import film as film_mod
    from functools import partial

    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh,
                                           traversal=cfg.traversal,
                                           sort=not cfg.resort)
    ls_tables = lightsamplers.build(scene, cfg.light_sampler)
    scene_d, dbvh_d, ls_d = jax.tree.map(jnp.asarray,
                                         (scene, dbvh, ls_tables))
    R = cam.width * cam.height
    sizes = [_align(R)]
    while sizes[-1] > 4096:
        nxt = _align(sizes[-1] // ladder_shrink)
        if nxt >= sizes[-1]:
            break
        sizes.append(nxt)
    curves = (jnp.asarray(sensor.curves)
              if isinstance(sensor, film_mod.MeasuredSensor) else None)

    def machinery(scn, dbv, lst, tables):
        return trace_wave_vol(scn, dbv, cam, sampler_cfg, cfg, None, None,
                              lst, isect.bind(tables), _export=True)

    @jax.jit
    def init_fn(scn, dbv, lst, tables, sample_idx):
        _, init_state = machinery(scn, dbv, lst, tables)
        # padding lanes (R..sizes[0]) alias pixel 0, dead, zero film weight
        pix = jnp.arange(sizes[0], dtype=jnp.int32)
        live = pix < R
        state = init_state(jnp.where(live, pix, 0), sample_idx)
        if sizes[0] > R:
            state = (state[:6] + (state[6] & live,) + state[7:18]
                     + (jnp.where(live, state[18], 0.0),) + state[19:])
        return state

    @jax.jit
    def phase_fn(scn, dbv, lst, tables, state, depth0, dmax):
        bounce, _ = machinery(scn, dbv, lst, tables)

        def wcond(carry):
            depth, s = carry
            return ((depth < dmax)
                    & (depth < cfg.max_depth) & jnp.any(s[6]))

        def wbody(carry):
            depth, s = carry
            return depth + 1, bounce(depth, s)

        depth, state = jax.lax.while_loop(wcond, wbody, (depth0, state))
        # dead-partition so every live lane sits in a prefix (stable sort
        # keeps the in-loop resort's clustering among the live lanes)
        order = jnp.argsort((~state[6]).astype(jnp.int32), stable=True)
        state = jax.tree.map(lambda a: a[order], state)
        return depth, state, jnp.sum(state[6].astype(jnp.int32))

    @jax.jit
    def film_add(film, pix, L, lam, lam_pdf, film_w):
        # sequential=False: chunks arrive permuted/sliced, and padding lanes
        # alias pixel 0 with zero weight — needs the real scatter-add
        return film_mod.add_samples(film, pix, L, lam, lam_pdf,
                                    filter_weight=film_w, sequential=False,
                                    sensor_curves=curves)

    from functools import partial as _partial

    @_partial(jax.jit, static_argnames=("n",))
    def shrink_fn(film, state, n):
        """Slice live prefix to n lanes; scatter the dead suffix's radiance
        into the film in the same jit."""
        tail = jax.tree.map(lambda a: a[n:], state)
        film = film_add(film, tail[13], tail[2], tail[14], tail[19],
                        tail[18])
        return film, jax.tree.map(lambda a: a[:n], state)

    @jax.jit
    def final_fn(film, scn, dbv, lst, tables, state):
        bounce, _ = machinery(scn, dbv, lst, tables)
        state = bounce(jnp.int32(cfg.max_depth), state, allow_scatter=False)
        return film_add(film, state[13], state[2], state[14], state[19],
                        state[18])

    def wave(film, sample_idx):
        import time as _time

        t0 = _time.perf_counter()
        state = init_fn(scene_d, dbvh_d, ls_d, isect.tables,
                        jnp.asarray(sample_idx, jnp.int32))
        depth = jnp.int32(0)
        d_host = 0
        k = 0
        n_phase = 0
        while True:
            # short phases early: occupancy collapses within the first few
            # bounces (RR from rr_depth + escapes), so check/shrink often,
            # then settle into long phases for the deep tail
            plen = ([1, 1, 2, 4][n_phase] if n_phase < 4 else phase_len)
            n_phase += 1
            depth, state, n_live = phase_fn(scene_d, dbvh_d, ls_d,
                                            isect.tables, state, depth,
                                            jnp.int32(d_host + plen))
            d_host = int(depth)
            live = int(n_live)
            if verbose:
                print(f"  phase -> depth {d_host:3d} size {sizes[k]:6d} "
                      f"live {live:6d}  t={_time.perf_counter() - t0:6.2f}s",
                      flush=True)
            if live == 0 or d_host >= cfg.max_depth:
                break
            want = _align(int(live * 1.25))
            while k + 1 < len(sizes) and sizes[k + 1] >= want:
                k += 1
                film, state = shrink_fn(film, state, sizes[k])
        return final_fn(film, scene_d, dbvh_d, ls_d, isect.tables, state)

    return wave
