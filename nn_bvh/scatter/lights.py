"""Light sampling over tagged SoA light tables.

Counterpart of the reference's Light family (`base/light.h:40`, impls
`lights.h/cpp`): Point, Distant, UniformInfinite, DiffuseArea(triangle) — with
per-lane tag dispatch. Area lights sample the spherical triangle (solid-angle
sampling, shapes.h:1099) with an area-sampling fallback for small subtended
angles, matching Triangle::Sample's strategy switch.

Gather discipline: all per-light attributes are fused into one
(L, 12) record table built *inside* jit from the scene columns (differentiable
w.r.t. light_scale/coeffs) — one gather per lane instead of five:
  [0 type | 1:4 pos | 4:7 coeffs | 7 scale | 8:12 params(tri, twosided, ..)]
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core import vecmath as vm, sampling, spectrum, rgb2spec
from ..geometry import scene as scene_mod, triangle

Array = jax.Array


class LightLiSample(NamedTuple):
    wi: Array        # (..., 3) world
    dist: Array      # (...,) distance to the light point (inf for infinite)
    li: Array        # (..., 4) spectral radiance (already divided by r^2 for point)
    pdf: Array       # (...,) solid-angle pdf (1 for delta lights)
    is_delta: Array  # (...,) bool
    valid: Array     # (...,) bool


def light_records(scene: scene_mod.CompiledScene) -> Array:
    """(L, 12) fused light table, built in-jit (gradients flow to
    light_coeffs / light_scale)."""
    return jnp.concatenate(
        [
            scene.light_type[:, None].astype(jnp.float32),
            scene.light_pos,
            scene.light_coeffs,
            scene.light_scale[:, None],
            scene.light_params,
        ],
        axis=-1,
    )


def record_spectrum(rec: Array, lam: Array) -> Array:
    """Emission spectrum from a gathered record: RGBIlluminantSpectrum
    semantics (spectrum.h:587)."""
    return (
        rgb2spec.eval_sigmoid_poly(rec[..., 4:7], lam)
        * spectrum.illuminant_d_normalized(lam)
        * rec[..., 7:8]
    )


def area_light_l_rec(light_rec: Array, has_light: Array, ng: Array, w_out: Array,
                     lam: Array) -> Array:
    """Emitted radiance toward w_out from a hit on an emissive triangle whose
    light record was already gathered (DiffuseAreaLight::L, lights.h:631)."""
    two_sided = light_rec[..., 9] > 0
    front = vm.dot(ng, w_out) > 0
    emit = has_light & (front | two_sided)
    return jnp.where(emit[..., None], record_spectrum(light_rec, lam), 0.0)


def sample_li(
    scene: scene_mod.CompiledScene,
    light_all: Array,
    light_id: Array,
    p: Array,
    lam: Array,
    u2: Array,
) -> LightLiSample:
    """SampleLi for a per-lane chosen light id. p: (...,3); u2: (...,2)."""
    rec = light_all[jnp.maximum(light_id, 0)]          # 1 gather
    ltype = rec[..., 0].astype(jnp.int32)
    lpos = rec[..., 1:4]
    emit = record_spectrum(rec, lam)

    # ---- point (lights.h PointLight) ------------------------------------
    to_l = lpos - p
    d2 = jnp.maximum(vm.length_squared(to_l), 1e-12)
    wi_point = to_l * jax.lax.rsqrt(d2)[..., None]
    li_point = emit / d2[..., None]
    dist_point = jnp.sqrt(d2)

    # ---- distant: pos stores direction TO light -------------------------
    wi_dist = jnp.broadcast_to(lpos, p.shape)

    # ---- uniform infinite ------------------------------------------------
    wi_inf = sampling.sample_uniform_sphere(u2)
    pdf_inf = jnp.full(p.shape[:-1], sampling.UNIFORM_SPHERE_PDF, jnp.float32)

    # ---- image infinite (env map importance sampling) --------------------
    if has_env_map(scene):
        wi_img, pdf_img = env_sample_dir(scene, u2)
        li_img = env_le(scene, wi_img, lam)
    else:
        wi_img, pdf_img, li_img = wi_inf, pdf_inf, emit

    # ---- spot (lights.h SpotLight: smoothstep falloff) --------------------
    sdir = rec[..., 8:11]
    cos_total = rec[..., 11]
    cos_start = rec[..., 12]
    cos_t_spot = vm.dot(sdir, -wi_point)
    t_ss = jnp.clip((cos_t_spot - cos_total)
                    / jnp.maximum(cos_start - cos_total, 1e-6), 0.0, 1.0)
    falloff = t_ss * t_ss * (3.0 - 2.0 * t_ss)  # SmoothStep (math.h)
    li_spot = li_point * falloff[..., None]

    # ---- projection (lights.h ProjectionLight) ----------------------------
    has_tex = scene.tex_atlas is not None and scene.tex_atlas.size > 4
    if has_tex:
        from ..geometry import texture as texture_mod
        pdir = rec[..., 8:11]
        tanx = jnp.maximum(rec[..., 11], 1e-6)
        tany = jnp.maximum(rec[..., 12], 1e-6)
        tex_id = rec[..., 13].astype(jnp.int32)
        up = rec[..., 14:17]
        xax = vm.normalize(vm.cross(up, pdir))
        w_l = -wi_point  # direction light -> p
        wz = vm.dot(w_l, pdir)
        wx = vm.dot(w_l, xax)
        wy = vm.dot(w_l, up)
        inside = (wz > 1e-6) & (jnp.abs(wx / jnp.maximum(wz, 1e-6)) <= tanx) \
            & (jnp.abs(wy / jnp.maximum(wz, 1e-6)) <= tany)
        uv_p = jnp.stack(
            [0.5 * (wx / jnp.maximum(wz, 1e-6) / tanx + 1.0),
             0.5 * (wy / jnp.maximum(wz, 1e-6) / tany + 1.0)], -1)
        texel = texture_mod.lookup(scene.tex_atlas, scene.tex_desc,
                                   tex_id, jnp.clip(uv_p, 0.0, 0.9999))
        tex_spec = rgb2spec.eval_sigmoid_poly(texel[..., 0:3], lam) * texel[..., 3:4]
        li_proj = li_point * tex_spec * inside[..., None]

        # ---- goniometric (lights.h GoniometricLight) ----------------------
        guv = vm.equal_area_sphere_to_square(-wi_point)
        gtexel = texture_mod.lookup(scene.tex_atlas, scene.tex_desc,
                                    tex_id, jnp.clip(guv, 0.0, 0.9999))
        gspec = rgb2spec.eval_sigmoid_poly(gtexel[..., 0:3], lam) * gtexel[..., 3:4]
        li_gonio = li_point * gspec
    else:
        li_proj = li_point
        li_gonio = li_point

    # ---- portal env (lights.h PortalImageInfiniteLight) -------------------
    q0, q1 = rec[..., 8:11], rec[..., 11:14]
    q2, q3 = rec[..., 14:17], rec[..., 17:20]
    if getattr(scene, "portal_sat", None) is not None:
        # SAT image warp (lights.cpp:1226 SampleLi): sample the rectified
        # env image restricted to the portal's axis-aligned window from p
        from . import portal as portal_mod

        fx = scene.portal_frame[0]
        fy = scene.portal_frame[1]
        fz = scene.portal_frame[2]
        to_local = lambda v: jnp.stack(
            [jnp.sum(v * fx, -1), jnp.sum(v * fy, -1),
             jnp.sum(v * fz, -1)], -1)
        uv0, _, v0ok = portal_mod.image_from_dir_local(
            to_local(vm.normalize(q0 - p)))
        uv1, _, v1ok = portal_mod.image_from_dir_local(
            to_local(vm.normalize(q2 - p)))
        x0 = jnp.minimum(uv0[..., 0], uv1[..., 0])
        x1 = jnp.maximum(uv0[..., 0], uv1[..., 0])
        y0 = jnp.minimum(uv0[..., 1], uv1[..., 1])
        y1 = jnp.maximum(uv0[..., 1], uv1[..., 1])
        xs, ys, pdf_uv, ok_w = portal_mod.sample_windowed(
            scene.portal_sat, u2, x0, y0, x1, y1)
        wloc, duv_dw = portal_mod.dir_from_image_local(
            jnp.stack([xs, ys], -1))
        wi_portal = (wloc[..., 0:1] * fx + wloc[..., 1:2] * fy
                     + wloc[..., 2:3] * fz)
        pdf_portal = jnp.where(
            v0ok & v1ok & ok_w,
            pdf_uv / jnp.maximum(duv_dw, 1e-9), 0.0)
        # radiance from the rectified image (ImageLookup, lights.cpp:1217)
        pres = scene.portal_img_coeffs.shape[0]
        pxi = jnp.clip((xs * pres).astype(jnp.int32), 0, pres - 1)
        pyi = jnp.clip((ys * pres).astype(jnp.int32), 0, pres - 1)
        ptex = scene.portal_img_coeffs[pyi, pxi]
        li_portal = (rgb2spec.eval_sigmoid_poly(ptex[..., 0:3], lam)
                     * ptex[..., 3:4]
                     * spectrum.illuminant_d_normalized(lam)
                     * env_scale_total(scene))
    else:
        # legacy uniform-area fallback (no env tables)
        qp = vm.lerp(u2[..., 0:1],
                     vm.lerp(u2[..., 1:2], q0, q3),
                     vm.lerp(u2[..., 1:2], q1, q2))
        to_q = qp - p
        d2q = jnp.maximum(vm.length_squared(to_q), 1e-12)
        wi_portal = to_q * jax.lax.rsqrt(d2q)[..., None]
        pn = vm.normalize(vm.cross(q1 - q0, q3 - q0))
        cos_q = vm.absdot(pn, wi_portal)
        area_q = vm.length(vm.cross(q1 - q0, q3 - q0))
        pdf_portal = d2q / jnp.maximum(cos_q * area_q, 1e-12)
        if has_env_map(scene):
            li_portal = env_le(scene, wi_portal, lam)
        else:
            li_portal = emit

    # ---- area triangle (verts via one tri_shade gather) ------------------
    tri_idx = rec[..., 8].astype(jnp.int32)
    # gather FULL rows then slice: tri_shade[idx, 0:9] (gather with a
    # sliced minor dim) lowers to a slower general XLA gather
    tv = scene.tri_shade[jnp.maximum(tri_idx, 0)][..., 0:9]  # 1 gather
    v0, v1, v2 = tv[..., 0:3], tv[..., 3:6], tv[..., 6:9]
    bary, pdf_sa, degen = sampling.sample_spherical_triangle(v0, v1, v2, p, u2)
    lp = bary[..., 0:1] * v0 + bary[..., 1:2] * v1 + bary[..., 2:3] * v2
    to_lp = lp - p
    d2a = jnp.maximum(vm.length_squared(to_lp), 1e-12)
    dist_a = jnp.sqrt(d2a)
    wi_area = to_lp / dist_a[..., None]
    ng = triangle.geometric_normal(v0, v1, v2)
    cos_l = vm.dot(ng, -wi_area)
    two_sided = rec[..., 9] > 0
    front_ok = two_sided | (cos_l > 0)
    area_t = triangle.area(v0, v1, v2)
    pdf_area_fallback = d2a / jnp.maximum(jnp.abs(cos_l) * area_t, 1e-12)
    pdf_a = jnp.where(degen, pdf_area_fallback, pdf_sa)
    li_area = jnp.where(front_ok[..., None], emit, 0.0)

    # ---- analytic sphere area light (Sphere::Sample cone, shapes.h:280) ---
    # The light's own geometry is a tessellated (inscribed) mesh: all its
    # surface points lie at radius in [r_ins, r]. Shadow tmax is therefore
    # set so the mesh is GEOMETRICALLY unreachable: from outside, the near
    # analytic intersection with the radius-r sphere (mesh radius <= r, so
    # no mesh point precedes it); from inside, the chord exit of the
    # inscribed sphere (mesh radius >= r_ins). No bias knob, no sag.
    radius = rec[..., 8]
    r_ins = rec[..., 10]  # inscribed tessellation radius (params[2])
    dc = lpos - p
    dc2 = jnp.maximum(vm.length_squared(dc), 1e-12)
    dc_len = jnp.sqrt(dc2)
    sin2_max = jnp.clip(radius * radius / dc2, 0.0, 1.0)
    cos_max = vm.safe_sqrt(1.0 - sin2_max)
    outside = dc2 > radius * radius * 1.0001
    # cone sample around dc (reference SampleUniformCone + Frame)
    cos_t = (1.0 - u2[..., 0]) + u2[..., 0] * cos_max
    sin_t = vm.safe_sqrt(1.0 - cos_t * cos_t)
    phi_s = 2.0 * jnp.pi * u2[..., 1]
    w_axis = dc / dc_len[..., None]
    tx, ty = vm.coordinate_system(w_axis)
    wi_sph = (sin_t * jnp.cos(phi_s))[..., None] * tx \
        + (sin_t * jnp.sin(phi_s))[..., None] * ty + cos_t[..., None] * w_axis
    # distance to the near analytic intersection along wi
    ds = dc_len * cos_t - vm.safe_sqrt(
        radius * radius - dc2 * (1.0 - cos_t * cos_t))
    pdf_sph_out = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), 1e-9)
    # inside the sphere: uniform area sample, pdf converted to solid angle
    dir_in = sampling.sample_uniform_sphere(u2)
    sp_in = lpos + radius[..., None] * dir_in
    to_in = sp_in - p
    d2_in = jnp.maximum(vm.length_squared(to_in), 1e-12)
    dist_in = jnp.sqrt(d2_in)
    wi_in = to_in / dist_in[..., None]
    cos_in = vm.absdot(dir_in, wi_in)
    area_sph = 4.0 * jnp.pi * radius * radius
    pdf_sph_in = d2_in / jnp.maximum(cos_in * area_sph, 1e-12)
    wi_sphere = jnp.where(outside[..., None], wi_sph, wi_in)
    pdf_sphere = jnp.where(outside, pdf_sph_out, pdf_sph_in)
    # inside: chord exit of the inscribed sphere along wi_in (p may sit in
    # the thin shell [r_ins, r]; grazing chords that miss the inscribed
    # sphere are dropped — O(sin^3(pi/n)) energy, far below test tolerance)
    b_in = vm.dot(dc, wi_in)
    disc_in = b_in * b_in + r_ins * r_ins - dc2
    t_exit_in = b_in + vm.safe_sqrt(disc_in)
    dist_sphere = jnp.where(outside, ds * (1.0 - 1e-3),
                            jnp.where(disc_in > 0, t_exit_in, 0.0))
    # from inside, a one-sided (twosided=0) sphere shows its BACK faces,
    # which emit nothing (DiffuseAreaLight::L back-face rule) — match the
    # BSDF-hit estimate in area_light_l_rec
    sph_emits = outside | (rec[..., 9] > 0)
    li_sphere = jnp.where(sph_emits[..., None], emit, 0.0)

    is_point = ltype == scene_mod.LIGHT_POINT
    is_dist = ltype == scene_mod.LIGHT_DISTANT
    is_inf = ltype == scene_mod.LIGHT_UNIFORM_INFINITE
    is_area = ltype == scene_mod.LIGHT_AREA_TRI
    is_img = ltype == scene_mod.LIGHT_IMAGE_INFINITE
    is_spot = ltype == scene_mod.LIGHT_SPOT
    is_proj = ltype == scene_mod.LIGHT_PROJECTION
    is_gonio = ltype == scene_mod.LIGHT_GONIOMETRIC
    is_portal = ltype == scene_mod.LIGHT_PORTAL_ENV
    is_sphere = ltype == scene_mod.LIGHT_SPHERE_AREA

    conds = [is_point, is_dist, is_inf, is_area, is_img,
             is_spot, is_proj, is_gonio, is_portal, is_sphere]
    wi = jnp.select([c[..., None] for c in conds],
                    [wi_point, wi_dist, wi_inf, wi_area, wi_img,
                     wi_point, wi_point, wi_point, wi_portal, wi_sphere],
                    wi_point)
    li = jnp.select([c[..., None] for c in conds],
                    [li_point, emit, emit, li_area, li_img,
                     li_spot, li_proj, li_gonio, li_portal, li_sphere],
                    jnp.zeros_like(li_point))
    inf_f = jnp.full(p.shape[:-1], jnp.inf, jnp.float32)
    dist = jnp.select(conds, [dist_point, inf_f, inf_f, dist_a, inf_f,
                              dist_point, dist_point, dist_point, inf_f,
                              dist_sphere], inf_f)
    one = jnp.ones(p.shape[:-1], jnp.float32)
    pdf = jnp.select(conds, [one, one, pdf_inf, pdf_a, pdf_img,
                             one, one, one, pdf_portal, pdf_sphere], one)
    is_delta = is_point | is_dist | is_spot | is_proj | is_gonio
    valid = (light_id >= 0) & (pdf > 0) & jnp.any(li > 0, axis=-1)
    valid = valid & jnp.where(is_area, front_ok, True)
    valid = valid & jnp.where(is_sphere, dist > 0, True)
    return LightLiSample(wi=wi, dist=dist, li=li, pdf=pdf, is_delta=is_delta, valid=valid)


def sphere_pdf_li(lrec: Array, ref_p: Array,
                  hit_p: Array | None = None,
                  hit_ng: Array | None = None) -> Array:
    """Solid-angle pdf that sphere-light sampling would give for a direction
    from ref_p hitting the sphere (Sphere::PDF, shapes.h:372) — the MIS
    counterpart at emissive hits. Outside: uniform-cone pdf (the direction
    hit the sphere, so it is inside the cone by construction). Inside:
    uniform-area pdf converted to solid angle at the ACTUAL hit
    (d^2 / (|cos| A)), needing the hit point/normal."""
    center = lrec[..., 1:4]
    radius = lrec[..., 8]
    dc2 = jnp.maximum(vm.length_squared(center - ref_p), 1e-12)
    sin2_max = jnp.clip(radius * radius / dc2, 0.0, 1.0)
    cos_max = vm.safe_sqrt(1.0 - sin2_max)
    outside = dc2 > radius * radius * 1.0001
    pdf_out = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), 1e-9)
    area_sph = 4.0 * jnp.pi * radius * radius
    if hit_p is not None:
        to_h = hit_p - ref_p
        d2h = jnp.maximum(vm.length_squared(to_h), 1e-12)
        wi_h = to_h * jax.lax.rsqrt(d2h)[..., None]
        cos_h = vm.absdot(hit_ng, wi_h)
        pdf_in = d2h / jnp.maximum(cos_h * area_sph, 1e-12)
    else:
        pdf_in = 4.0 / jnp.maximum(area_sph, 1e-9)
    return jnp.where(outside, pdf_out, pdf_in)


def portal_pdf_dir(scene: scene_mod.CompiledScene, light_all: Array,
                   ref_p: Array, d: Array) -> Array:
    """Solid-angle pdf that portal sampling gives direction d from ref_p,
    summed over portal lights (PortalImageInfiniteLight::PDF_Li). With the
    SAT warp tables: window-normalized image density / duv_dw; without
    (legacy): the uniform-area quad pdf."""
    L = scene.n_lights
    out = jnp.zeros(d.shape[:-1], jnp.float32)
    lt = scene.light_type
    if getattr(scene, "portal_sat", None) is not None:
        from . import portal as portal_mod

        fx = scene.portal_frame[0]
        fy = scene.portal_frame[1]
        fz = scene.portal_frame[2]
        to_local = lambda v: jnp.stack(
            [jnp.sum(v * fx, -1), jnp.sum(v * fy, -1),
             jnp.sum(v * fz, -1)], -1)
        uvd, duv_dw, dok = portal_mod.image_from_dir_local(to_local(d))
        for i in range(L):
            rec = light_all[i]
            is_portal = lt[i] == scene_mod.LIGHT_PORTAL_ENV
            q0 = rec[8:11]
            q2 = rec[14:17]
            uv0, _, v0ok = portal_mod.image_from_dir_local(
                to_local(vm.normalize(q0 - ref_p)))
            uv1, _, v1ok = portal_mod.image_from_dir_local(
                to_local(vm.normalize(q2 - ref_p)))
            x0 = jnp.minimum(uv0[..., 0], uv1[..., 0])
            x1 = jnp.maximum(uv0[..., 0], uv1[..., 0])
            y0 = jnp.minimum(uv0[..., 1], uv1[..., 1])
            y1 = jnp.maximum(uv0[..., 1], uv1[..., 1])
            pdf_uv = portal_mod.pdf_windowed(
                scene.portal_sat, uvd[..., 0], uvd[..., 1], x0, y0, x1, y1)
            pdf_i = pdf_uv / jnp.maximum(duv_dw, 1e-9)
            out = out + jnp.where(is_portal & dok & v0ok & v1ok, pdf_i, 0.0)
        return out
    for i in range(L):
        # static python loop over lights: portal lights are rare (usually 1)
        rec = light_all[i]
        q0, q1 = rec[8:11], rec[11:14]
        q2, q3 = rec[14:17], rec[17:20]
        pn = vm.normalize(vm.cross(q1 - q0, q3 - q0))
        denom = vm.dot(d, pn)
        t = vm.dot(q0 - ref_p, pn) / jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
        hitp = ref_p + t[..., None] * d
        # inside test in the parallelogram's (e1, e3) coordinates
        e1, e3 = q1 - q0, q3 - q0
        rel = hitp - q0
        a11 = vm.dot(e1, e1)
        a13 = vm.dot(e1, e3)
        a33 = vm.dot(e3, e3)
        det = jnp.maximum(a11 * a33 - a13 * a13, 1e-12)
        b1 = (vm.dot(rel, e1) * a33 - vm.dot(rel, e3) * a13) / det
        b3 = (vm.dot(rel, e3) * a11 - vm.dot(rel, e1) * a13) / det
        inside = (t > 0) & (b1 >= 0) & (b1 <= 1) & (b3 >= 0) & (b3 <= 1)
        d2q = vm.length_squared(hitp - ref_p)
        area_q = vm.length(vm.cross(e1, e3))
        pdf_i = d2q / jnp.maximum(jnp.abs(denom) * area_q, 1e-12)
        is_portal = lt[i] == scene_mod.LIGHT_PORTAL_ENV
        out = out + jnp.where(is_portal & inside, pdf_i, 0.0)
    return out


def has_portal(scene: scene_mod.CompiledScene) -> bool:
    """Static: any portal light? Must be decided at trace time (it gates a
    per-light Python loop). Under jit the scene arrives as tracers, so the
    STATIC feat_portal flag (pytree aux_data set at build time) is the
    authority; the array fallback covers pre-flag scenes outside jit."""
    if getattr(scene, "feat_portal", False):
        return True
    try:
        return bool(np.any(np.asarray(scene.light_type)
                           == scene_mod.LIGHT_PORTAL_ENV))
    except jax.errors.TracerArrayConversionError:
        return False


def area_pdf_li_from_verts(v0: Array, v1: Array, v2: Array, ref_p: Array) -> Array:
    """Solid-angle pdf that triangle solid-angle sampling would give for a
    direction hitting this triangle from ref_p (Triangle::PDF, shapes.h) —
    used for MIS at emissive hits; verts come from the already-gathered
    tri_shade record of the hit."""
    omega = triangle.solid_angle(v0, v1, v2, ref_p)
    return jnp.where(omega > 1e-5, 1.0 / jnp.maximum(omega, 1e-12), 0.0)


def has_env_map(scene: scene_mod.CompiledScene) -> bool:
    """Static: does the scene carry an ImageInfiniteLight env map?"""
    return scene.env_luminance is not None and scene.env_luminance.size > 1


def _env_uv_texel(scene: scene_mod.CompiledScene, uv: Array):
    he, we = scene.env_luminance.shape
    x = jnp.clip((uv[..., 0] * we).astype(jnp.int32), 0, we - 1)
    y = jnp.clip((uv[..., 1] * he).astype(jnp.int32), 0, he - 1)
    return scene.env_coeffs[y, x], y, x


def env_scale_total(scene: scene_mod.CompiledScene) -> Array:
    is_env = (scene.light_type == scene_mod.LIGHT_IMAGE_INFINITE) | (
        scene.light_type == scene_mod.LIGHT_PORTAL_ENV)
    return jnp.sum(jnp.where(is_env, scene.light_scale, 0.0))


def env_le(scene: scene_mod.CompiledScene, d: Array, lam: Array) -> Array:
    """ImageInfiniteLight::Le — equal-area octahedral lookup (lights.h)."""
    uv = vm.equal_area_sphere_to_square(d)
    texel, _, _ = _env_uv_texel(scene, uv)
    return (
        rgb2spec.eval_sigmoid_poly(texel[..., 0:3], lam)
        * texel[..., 3:4]
        * spectrum.illuminant_d_normalized(lam)
        * env_scale_total(scene)
    )


def env_pdf_dir(scene: scene_mod.CompiledScene, d: Array) -> Array:
    """Solid-angle pdf of env-map importance sampling for direction d
    (ImageInfiniteLight::PDF_Li: the equal-area map is measure-preserving,
    so pdf_dir = pdf_uv / 4pi)."""
    uv = vm.equal_area_sphere_to_square(d)
    _, y, x = _env_uv_texel(scene, uv)
    return scene.env_luminance[y, x] * sampling.INV_4PI


def env_sample_dir(scene: scene_mod.CompiledScene, u2: Array):
    """Importance-sample the env map: u2 (...,2) -> (dir, pdf_dir)."""
    he, we = scene.env_luminance.shape
    y = jnp.clip(jnp.searchsorted(scene.env_marg_cdf, u2[..., 1], side="right") - 1,
                 0, he - 1)
    c0 = scene.env_marg_cdf[y]
    c1 = scene.env_marg_cdf[y + 1]
    dv = jnp.where(c1 > c0, (u2[..., 1] - c0) / jnp.maximum(c1 - c0, 1e-20), 0.0)
    v = (y.astype(jnp.float32) + dv) / he

    cond = scene.env_cond_cdf[y]  # (..., we+1)
    ux = u2[..., 0]
    flat = cond.reshape(-1, we + 1)
    x = jax.vmap(jnp.searchsorted, in_axes=(0, 0))(flat, ux.reshape(-1)).reshape(
        ux.shape
    ) - 1
    x = jnp.clip(x, 0, we - 1)
    d0 = jnp.take_along_axis(cond, x[..., None], axis=-1)[..., 0]
    d1 = jnp.take_along_axis(cond, x[..., None] + 1, axis=-1)[..., 0]
    du = jnp.where(d1 > d0, (ux - d0) / jnp.maximum(d1 - d0, 1e-20), 0.0)
    u = (x.astype(jnp.float32) + du) / we

    uv = jnp.stack([u, v], axis=-1)
    dirs = vm.equal_area_square_to_sphere(uv)
    pdf = scene.env_luminance[y, x] * sampling.INV_4PI
    return dirs, pdf


def infinite_le(scene: scene_mod.CompiledScene, d: Array, lam: Array) -> Array:
    """Total radiance from infinite lights for escaped rays (Light::Le)."""
    if scene.n_lights == 0:
        return jnp.zeros(d.shape[:-1] + (spectrum.N_SPECTRUM_SAMPLES,), jnp.float32)
    is_inf = scene.light_type == scene_mod.LIGHT_UNIFORM_INFINITE
    L = scene.light_coeffs.shape[0]
    cs = scene.light_coeffs.reshape((L,) + (1,) * (lam.ndim - 1) + (3,))
    spec_all = rgb2spec.eval_sigmoid_poly(cs, lam[None])  # (L, ..., S)
    w = jnp.where(is_inf, scene.light_scale, 0.0)
    out = jnp.tensordot(w, spec_all, axes=(0, 0),
                        precision=jax.lax.Precision.HIGHEST) * spectrum.illuminant_d_normalized(lam)
    if has_env_map(scene):
        out = out + env_le(scene, d, lam)
    return out
