"""Stochastic progressive photon mapping (SPPMIntegrator, cpu/integrators.h:436,
impl cpu/integrators.cpp:2811).

Re-design of the reference's SPPM:
- Camera pass: one dense wave of per-pixel paths followed through *delta*
  (perfectly specular) interactions only; the first non-delta vertex becomes
  the pixel's visible point (pbrt creates VPs at diffuse vertices and glossy
  vertices at the depth limit; here every non-delta vertex is a VP — noted
  deviation, consistent estimator either way). Emitted radiance along the
  specular chain and one light sample at the VP accumulate into a direct
  term, exactly splitting direct/indirect the way the reference does.
- Photon pass: dense light subpaths via SampleLe (lightpath.sample_le);
  vertices after the first bounce deposit photon records (position, incoming
  direction, throughput).
- Grid: the reference hashes *visible points* into a uniform grid and
  atomically splats each photon into it (integrators.cpp grid +
  AtomicFloat Phi). Atomic scatter is the wrong shape for dense lanes, so the
  roles flip: photons are hashed and sorted by cell key (jnp.sort — the
  radix sort IS the queue), and every visible point *gathers* from its 27
  neighbor cells with a static per-cell photon cap (K_CAP; overflow photons
  beyond the cap in one cell are dropped — the returned stats report how
  many so the cap is never a silent truncation).
- Spectral handling: one shared SampledWavelengths per iteration for BOTH
  passes, so vp_beta * f * photon_beta is a product at a single wavelength
  set (hero-wavelength SPPM). The reference instead converts Phi to RGB per
  photon (SPPMPixel Phi[3]); sharing lambda is the spectrally-consistent
  batch-friendly variant (no per-photon colorspace transform in the kernel).
- Per-pixel statistics (r^2, N, tau) follow Knaus-Zwicker/HK updates exactly
  as the reference: N' = N + alpha*M, r'^2 = r^2 * N'/(N+M),
  tau' = (tau + ToXYZ(beta*Phi)) * r'^2/r^2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import vecmath as vm, sampling, spectrum, rng
from ..core.colorspace import xyz_to_linear_srgb
from ..geometry import scene as scene_mod
from ..scatter import bxdf, lights, lightsamplers
from .. import accel
from ..accel import dispatch
from . import camera as camera_mod
from .integrator import IntegratorConfig, _shading_point
from .lightpath import sample_le

Array = jax.Array

# hash-grid constants (collisions only waste cap budget; distance test filters)
_HA, _HB, _HC = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
HASH_BITS = 18


def _cell_hash(ix: Array, iy: Array, iz: Array) -> Array:
    h = (ix.astype(jnp.uint32) * jnp.uint32(_HA)
         ^ iy.astype(jnp.uint32) * jnp.uint32(_HB)
         ^ iz.astype(jnp.uint32) * jnp.uint32(_HC))
    return (h & jnp.uint32((1 << HASH_BITS) - 1)).astype(jnp.int32)


class SPPMState(NamedTuple):
    r2: Array       # (R,) current squared search radius per pixel
    n: Array        # (R,) accumulated photon statistic N
    tau: Array      # (R,3) XYZ tau accumulator (scaled by radius shrinks)
    ld: Array       # (R,3) XYZ direct-lighting sum over iterations
    dropped: Array  # () i32: photons skipped by the per-cell cap (reported)


def make_state(n_pixels: int, initial_radius: float) -> SPPMState:
    return SPPMState(
        r2=jnp.full((n_pixels,), float(initial_radius) ** 2, jnp.float32),
        n=jnp.zeros((n_pixels,), jnp.float32),
        tau=jnp.zeros((n_pixels, 3), jnp.float32),
        ld=jnp.zeros((n_pixels, 3), jnp.float32),
        dropped=jnp.zeros((), jnp.int32),
    )


def _is_delta_only(ctx: bxdf.MaterialCtx) -> Array:
    """Lanes whose BSDF has no non-delta lobe (camera path passes through)."""
    smooth = bxdf.effectively_smooth(ctx.ax, ctx.ay)
    t = ctx.mat_type
    return smooth & ((t == scene_mod.MAT_CONDUCTOR)
                     | (t == scene_mod.MAT_DIELECTRIC)
                     | (t == scene_mod.MAT_THIN_DIELECTRIC))


def sppm_iteration(
    scene: scene_mod.CompiledScene,
    dbvh: accel.DeviceBVH,
    cam: camera_mod.Camera,
    cfg: IntegratorConfig,
    state: SPPMState,
    iteration: Array,
    n_photons: int,
    ls_tables: lightsamplers.LightSamplerTables,
    seed: int = 0,
    alpha: float = 2.0 / 3.0,
    k_cap: int = 16,
    max_photon_depth: int | None = None,
    isect: "dispatch.Intersectors | None" = None,
):
    """One SPPM iteration (camera pass + photon pass + density estimate)."""
    if isect is None:
        isect = dispatch.make_intersectors(scene, dbvh, traversal=cfg.traversal)
    scene = jax.tree.map(jnp.asarray, scene)
    dbvh = jax.tree.map(jnp.asarray, dbvh)
    _closest, _any = isect.closest, isect.any_hit
    sg = jax.lax.stop_gradient
    isect_closest = lambda *a: jax.tree.map(sg, _closest(*map(sg, a)))
    isect_any = lambda *a: sg(_any(*map(sg, a)))

    R = cam.width * cam.height
    P = n_photons
    # photon path length matches the reference's depth semantics (photon loop
    # runs depth < maxDepth): same transport as Path at equal max_depth
    D_ph = max_photon_depth or cfg.max_depth
    S = spectrum.N_SPECTRUM_SAMPLES
    it = jnp.asarray(iteration, jnp.uint32)
    mat_all = bxdf.material_records(scene)
    light_all = lights.light_records(scene)

    # shared per-iteration wavelengths (hero-wavelength SPPM; see module doc)
    u_lam = rng.hash_float(jnp.zeros((1,), jnp.int32), it.astype(jnp.int32),
                           jnp.uint32(seed), jnp.uint32(0x51))
    lam, lam_pdf = spectrum.sample_wavelengths_visible(u_lam)
    lam = jnp.broadcast_to(lam, (R, S))
    lam_pdf = jnp.broadcast_to(lam_pdf, (R, S))
    lam_p = jnp.broadcast_to(lam[:1], (P, S))

    def rand_cam(*salts):
        return rng.hash_float(jnp.arange(R, dtype=jnp.int32),
                              jnp.broadcast_to(it, (R,)).astype(jnp.int32),
                              jnp.uint32(seed),
                              *[jnp.asarray(s, jnp.uint32) for s in salts])

    def rand_ph(*salts):
        return rng.hash_float(jnp.arange(P, dtype=jnp.int32),
                              jnp.broadcast_to(it, (P,)).astype(jnp.int32),
                              jnp.uint32(seed ^ 0xABCD),
                              *[jnp.asarray(s, jnp.uint32) for s in salts])

    # ---------------- camera pass: find visible points --------------------
    pixel_idx = jnp.arange(R, dtype=jnp.int32)
    u_pix = jnp.stack([rand_cam(1), rand_cam(2)], -1)
    u_lens = jnp.stack([rand_cam(3), rand_cam(4)], -1)
    o, d = camera_mod.generate_rays(cam, pixel_idx, u_pix, u_lens)

    beta = jnp.ones((R, S), jnp.float32)
    active = jnp.ones((R,), bool)
    ld_new = jnp.zeros((R, S), jnp.float32)
    vp_found = jnp.zeros((R,), bool)
    vp_p = jnp.zeros((R, 3), jnp.float32)
    vp_ns = jnp.zeros((R, 3), jnp.float32)
    vp_ng = jnp.zeros((R, 3), jnp.float32)
    vp_wo = jnp.zeros((R, 3), jnp.float32)
    vp_beta = jnp.zeros((R, S), jnp.float32)
    vp_ctx = None  # lazily shaped from the first gather (bxdf.zeros_ctx_like)

    for depth in range(cfg.max_depth):
        t_max = jnp.where(active & ~vp_found, 1e30, -1.0)
        hit = isect_closest(o, d, t_max)
        found = active & ~vp_found & (hit.prim >= 0)
        escaped = active & ~vp_found & (hit.prim < 0)
        sp = _shading_point(scene, hit, o, d)
        wo = -d
        # emission along the specular chain (weight 1: nothing else samples it)
        if scene.n_lights > 0:
            le_inf = lights.infinite_le(scene, d, lam)
            ld_new = ld_new + jnp.where(escaped[..., None], beta * le_inf, 0.0)
            lrec = light_all[jnp.maximum(sp.light, 0)]
            has_l = found & (sp.light >= 0)
            le = lights.area_light_l_rec(lrec, has_l, sp.ng, wo, lam)
            ld_new = ld_new + jnp.where(found[..., None], beta * le, 0.0)
        ctx = bxdf.gather_material(scene, sp.mat, lam, mat_all, sp.uv,
                                   rand_cam(5, depth))
        if vp_ctx is None:
            vp_ctx = bxdf.zeros_ctx_like(ctx)
        surf = found & (sp.mat >= 0)
        delta = _is_delta_only(ctx)
        make_vp = surf & ~delta
        new = make_vp & ~vp_found
        vp_p = jnp.where(new[..., None], sp.p, vp_p)
        vp_ns = jnp.where(new[..., None], sp.ns, vp_ns)
        vp_ng = jnp.where(new[..., None], sp.ng, vp_ng)
        vp_wo = jnp.where(new[..., None], wo, vp_wo)
        vp_beta = jnp.where(new[..., None], beta, vp_beta)
        vp_ctx = bxdf.select_ctx(new, ctx, vp_ctx)
        vp_found = vp_found | new

        # continue through delta lobes only
        cont = surf & delta & ~vp_found
        uc = rand_cam(6, depth)
        u2 = jnp.stack([rand_cam(7, depth), rand_cam(8, depth)], -1)
        bs = bxdf.sample(ctx, vm.to_local(sp.ns, wo), uc, u2)
        wi_w = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_w, sp.ns)
        beta = jnp.where(
            (cont & bs.valid)[..., None],
            beta * bs.f * (cos_b / jnp.maximum(bs.pdf, 1e-20))[..., None], beta)
        active = cont & bs.valid & jnp.any(beta > 0, axis=-1)
        ng_o = vm.face_forward(sp.ng, wi_w)
        o = jnp.where(active[..., None], vm.offset_ray_origin(sp.p, ng_o, wi_w), o)
        d = jnp.where(active[..., None], wi_w, d)

    # direct lighting at the visible point (one light sample, no MIS —
    # the photon pass only carries indirect light so there is no overlap)
    if scene.n_lights > 0 and cfg.sample_lights:
        u_sel = rand_cam(9)
        u_l = jnp.stack([rand_cam(10), rand_cam(11)], -1)
        light_id, sel_pmf, _ = lightsamplers.sample_ctx(ls_tables, vp_p, u_sel)
        ls = lights.sample_li(scene, light_all, light_id, vp_p, lam, u_l)
        wo_loc = vm.to_local(vp_ns, vp_wo)
        f_l, _ = bxdf.evaluate(vp_ctx, wo_loc, vm.to_local(vp_ns, ls.wi))
        cos_l = vm.absdot(ls.wi, vp_ns)
        want = vp_found & ls.valid & (cos_l > 0) & jnp.any(f_l > 0, axis=-1)
        so = vm.offset_ray_origin(vp_p, vm.face_forward(vp_ng, ls.wi), ls.wi)
        occ = isect_any(so, ls.wi, jnp.where(want, ls.dist * 0.999, -1.0))
        pdf_l = jnp.maximum(ls.pdf * sel_pmf, 1e-20)
        contrib = vp_beta * f_l * (cos_l / pdf_l)[..., None] * ls.li
        ld_new = ld_new + jnp.where((want & ~occ)[..., None], contrib, 0.0)

    # ---------------- photon pass ------------------------------------------
    light_id, sel_pmf, _ = lightsamplers.sample(ls_tables, rand_ph(20))
    u_pos = jnp.stack([rand_ph(21), rand_ph(22)], -1)
    u_dir = jnp.stack([rand_ph(23), rand_ph(24)], -1)
    pp, png, pd, pbeta0, _ = sample_le(scene, light_all, light_id, lam_p,
                                       u_pos, u_dir)
    pbeta = pbeta0 / jnp.maximum(sel_pmf, 1e-12)[..., None]
    pactive = (light_id >= 0) & jnp.any(pbeta > 0, axis=-1)
    po = vm.offset_ray_origin(pp, png, pd)
    pdir = pd

    dep_valid, dep_p, dep_wi, dep_beta = [], [], [], []
    for depth in range(D_ph):
        t_max = jnp.where(pactive, 1e30, -1.0)
        hit = isect_closest(po, pdir, t_max)
        found = pactive & (hit.prim >= 0)
        sp = _shading_point(scene, hit, po, pdir)
        surf = found & (sp.mat >= 0)
        if depth >= 1:
            # deposits start after the first bounce: the camera pass already
            # samples direct lighting at the VP (integrators.cpp SPPM split)
            dep_valid.append(surf)
            dep_p.append(sp.p)
            dep_wi.append(-pdir)
            dep_beta.append(pbeta)
        ctx = bxdf.gather_material(scene, sp.mat, lam_p, mat_all, sp.uv,
                                   rand_ph(25, depth))
        uc = rand_ph(26, depth)
        u2 = jnp.stack([rand_ph(27, depth), rand_ph(28, depth)], -1)
        wo = -pdir
        # photons carry importance: no 1/eta^2 on dielectric transmission
        # (reference traces photons with TransportMode::Importance)
        bs = bxdf.sample(ctx, vm.to_local(sp.ns, wo), uc, u2,
                         mode="importance")
        wi_w = vm.from_local(sp.ns, bs.wi)
        cos_b = vm.absdot(wi_w, sp.ns)
        bnew = pbeta * bs.f * (cos_b / jnp.maximum(bs.pdf, 1e-20))[..., None]
        pactive = surf & bs.valid & jnp.any(bnew > 0, axis=-1)
        # Russian roulette on the throughput ratio (integrators.cpp photon RR)
        q = jnp.clip(1.0 - jnp.max(bnew, -1) / jnp.maximum(
            jnp.max(pbeta, -1), 1e-12), 0.0, 0.95)
        u_rr = rand_ph(29, depth)
        die = pactive & (u_rr < q) & (depth >= 1)
        pactive = pactive & ~die
        keep = jnp.where(depth >= 1, 1.0 - q, 1.0)
        pbeta = jnp.where(pactive[..., None],
                          bnew / jnp.maximum(keep, 1e-6)[..., None], pbeta)
        ng_o = vm.face_forward(sp.ng, wi_w)
        po = jnp.where(pactive[..., None],
                       vm.offset_ray_origin(sp.p, ng_o, wi_w), po)
        pdir = jnp.where(pactive[..., None], wi_w, pdir)

    if dep_valid:
        ph_valid = jnp.concatenate(dep_valid)
        ph_p = jnp.concatenate(dep_p)
        ph_wi = jnp.concatenate(dep_wi)
        ph_beta = jnp.concatenate(dep_beta)
    else:  # D_ph < 2: no indirect photons
        ph_valid = jnp.zeros((P,), bool)
        ph_p = jnp.zeros((P, 3), jnp.float32)
        ph_wi = jnp.zeros((P, 3), jnp.float32)
        ph_beta = jnp.zeros((P, S), jnp.float32)

    # ---------------- grid: sort photons by cell hash ----------------------
    lo = jnp.asarray(scene.bounds[0], jnp.float32)
    r_max = jnp.sqrt(jnp.max(jnp.where(vp_found, state.r2, 0.0)))
    cell = jnp.maximum(r_max, 1e-6)
    n_keys = 1 << HASH_BITS

    ci = jnp.floor((ph_p - lo) / cell).astype(jnp.int32)
    keys = jnp.where(ph_valid,
                     _cell_hash(ci[:, 0], ci[:, 1], ci[:, 2]), n_keys)
    order = jnp.argsort(keys)
    skeys = keys[order]
    sp_p = ph_p[order]
    sp_wi = ph_wi[order]
    sp_beta = ph_beta[order]

    vci = jnp.floor((vp_p - lo) / cell).astype(jnp.int32)
    offs = jnp.asarray([(dx, dy, dz) for dx in (-1, 0, 1)
                        for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
                       jnp.int32)  # (27, 3)
    ncells = vci[:, None, :] + offs[None, :, :]             # (R, 27, 3)
    nh = _cell_hash(ncells[..., 0], ncells[..., 1], ncells[..., 2])
    # dedup hash-colliding neighbor cells: two distinct cells with the same
    # 18-bit key would gather the same sorted photon range twice and
    # double-count flux the distance test cannot catch
    dup = jnp.any((nh[:, :, None] == nh[:, None, :])
                  & np.tril(np.ones((27, 27), bool), -1)[None], axis=-1)
    starts = jnp.searchsorted(skeys, nh.reshape(-1), side="left").reshape(R, 27)
    ends = jnp.searchsorted(skeys, nh.reshape(-1), side="right").reshape(R, 27)
    ends = jnp.where(dup, starts, ends)  # duplicate cell -> empty range
    n_drop = jnp.sum(jnp.maximum(ends - starts - k_cap, 0))

    wo_loc = vm.to_local(vp_ns, vp_wo)

    def gather_body(i, carry):
        phi, m = carry
        c = i // k_cap
        k = i % k_cap
        s0 = starts[:, c]
        j = jnp.clip(s0 + k, 0, skeys.shape[0] - 1)
        in_cell = (s0 + k) < ends[:, c]
        pj = sp_p[j]
        d2 = vm.length_squared(pj - vp_p)
        ok = vp_found & in_cell & (d2 <= state.r2)
        wi_loc = vm.to_local(vp_ns, sp_wi[j])
        f, _ = bxdf.evaluate(vp_ctx, wo_loc, wi_loc)
        phi = phi + jnp.where(ok[..., None], f * sp_beta[j], 0.0)
        m = m + ok.astype(jnp.float32)
        return phi, m

    phi0 = jnp.zeros((R, S), jnp.float32)
    m0 = jnp.zeros((R,), jnp.float32)
    phi, m = jax.lax.fori_loop(0, 27 * k_cap, gather_body, (phi0, m0))

    # ---------------- per-pixel statistics update ---------------------------
    has = vp_found & (m > 0)
    n_new = state.n + alpha * m
    r2_new = state.r2 * n_new / jnp.maximum(state.n + m, 1e-6)
    tau_add = spectrum.spectrum_to_xyz(vp_beta * phi, lam, lam_pdf)
    tau_add = jnp.where(jnp.isfinite(tau_add), tau_add, 0.0)
    ratio = jnp.where(has, r2_new / jnp.maximum(state.r2, 1e-20), 1.0)
    tau = jnp.where(has[..., None], (state.tau + tau_add) * ratio[..., None],
                    state.tau)
    ld_xyz = spectrum.spectrum_to_xyz(ld_new, lam, lam_pdf)
    ld_xyz = jnp.where(jnp.isfinite(ld_xyz), ld_xyz, 0.0)
    return SPPMState(
        r2=jnp.where(has, r2_new, state.r2),
        n=jnp.where(has, n_new, state.n),
        tau=tau,
        ld=state.ld + ld_xyz,
        dropped=state.dropped + n_drop.astype(jnp.int32),
    )


def develop(state: SPPMState, n_iterations: int, n_photons: int,
            height: int, width: int) -> Array:
    """L = Ld/n_it + tau / (n_it * Np * pi * r^2) -> (H, W, 3) linear sRGB."""
    n_it = float(n_iterations)
    indirect = state.tau / (n_it * n_photons * np.pi
                            * jnp.maximum(state.r2, 1e-20))[..., None]
    xyz = state.ld / n_it + indirect
    return xyz_to_linear_srgb(xyz).reshape(height, width, 3)


def render_sppm(
    scene, dbvh, cam, n_iterations: int = 16, photons_per_iter: int | None = None,
    initial_radius: float | None = None, seed: int = 0,
    cfg: IntegratorConfig = IntegratorConfig(),
    alpha: float = 2.0 / 3.0, k_cap: int = 16,
) -> Array:
    """SPPMIntegrator::Render analog: progressive iterations, each one jit."""
    R = cam.width * cam.height
    P = photons_per_iter or R
    if initial_radius is None:
        ext = np.asarray(scene.bounds[1]) - np.asarray(scene.bounds[0])
        initial_radius = 0.015 * float(np.linalg.norm(ext))
    ls_tables = lightsamplers.build(scene, cfg.light_sampler)
    isect = dispatch.make_intersectors(scene, dbvh, traversal=cfg.traversal)
    scene_d, dbvh_d, ls_d = jax.tree.map(jnp.asarray, (scene, dbvh, ls_tables))

    # big arrays as jit ARGS, not closures (see dispatch.py jit-boundary rule)
    @jax.jit
    def step(st, i, scene, dbvh, ls_tables, tables):
        return sppm_iteration(scene, dbvh, cam, cfg, st, i, P, ls_tables,
                              seed=seed, alpha=alpha, k_cap=k_cap,
                              isect=isect.bind(tables))

    st = make_state(R, initial_radius)
    for i in range(n_iterations):
        st = step(st, jnp.int32(i), scene_d, dbvh_d, ls_d, isect.tables)
    return develop(st, n_iterations, P, cam.height, cam.width)
