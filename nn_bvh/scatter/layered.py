"""Stochastic layered BSDF (CoatedDiffuse / CoatedConductor).

Batched re-design of the reference's `LayeredBxDF` random walk
(`bxdfs.h:432`: TopOrBottomBxDF / LayeredBxDF, `CoatedDiffuseBxDF:903`,
`CoatedConductorBxDF:912`): a dielectric interface layered over a diffuse or
conductor base, evaluated by simulating light transport between the two
interfaces. The reference walks each query with a scalar loop + RNG; here the
walk is vectorized over lanes with a FIXED unrolled depth (no data-dependent
control flow under jit) and a stateless counter-based hash RNG seeded from
the query directions — the same decorrelation device the reference uses
(`RNG rng(Hash(seed, wo), Hash(wi))`).

Scope: the `albedo == 0` configuration (no participating medium between the
interfaces) — the pbrt default for coateddiffuse/coatedconductor and what
every vendored scene uses. Layer thickness fixed at the reference default
0.01 (materials.cpp: GetFloatTexture("thickness", .01)).

All directions are in the local shading frame (z up). Both coated materials
are twoSided=true in the reference, so queries with wo.z < 0 flip the frame.

Estimators (mirroring bxdfs.h):
- `coated_f`:      stochastic estimate of f(wo, wi) — entrance reflection +
                   n_samples random walks with virtual-light NEE through the
                   exit interface.
- `coated_pdf`:    stochastic PDF estimate (TRT term with MIS), lerped 0.9
                   against the uniform-sphere pdf exactly as the reference.
- `coated_sample`: random-walk Sample_f. The returned pdf is PROPORTIONAL
                   (pdfIsProportional in the reference); callers rescale f by
                   coated_pdf / pdf_walk — see bxdf.sample.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import sampling
from ..core import vecmath as vm

Array = jax.Array

THICKNESS = 0.01     # layer thickness (reference default)
_SMOOTH_EPS = 1e-3   # EffectivelySmooth threshold (microfacet delta limit)
INV_4PI = 1.0 / (4.0 * jnp.pi)


# ---------------------------------------------------------------------------
# stateless counter-based RNG (per-lane, seeded from the query)
# ---------------------------------------------------------------------------

def _mix(h: Array) -> Array:
    """murmur3-style 32-bit finalizer."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _hash_vec(v: Array, salt: int) -> Array:
    """(..., 3) f32 -> (...,) u32 lane hash."""
    b = jax.lax.bitcast_convert_type(v, jnp.uint32)
    h = jnp.uint32(salt)
    for i in range(3):
        h = _mix(h ^ (b[..., i] * jnp.uint32(0x9E3779B9)))
    return h


def _u01(h1: Array, h2: Array, j: int) -> Array:
    """j-th uniform draw for lane keys (h1, h2); counter-based, stateless."""
    h = _mix(h1 ^ _mix(h2 + jnp.uint32((j * 0x632BE59B + 0x1B873593)
                              & 0xFFFFFFFF)))
    # 24-bit mantissa -> [0, 1); clamp below one like OneMinusEpsilon
    return jnp.minimum((h >> 8).astype(jnp.float32) * (2.0 ** -24),
                       jnp.float32(1.0 - 2.0 ** -24))


class _Rng:
    """Static-counter draw helper (each .next() is a new fused hash)."""

    def __init__(self, h1, h2):
        self.h1, self.h2 = h1, h2
        self.j = 0

    def next(self):
        u = _u01(self.h1, self.h2, self.j)
        self.j += 1
        return u

    def next2(self):
        return jnp.stack([self.next(), self.next()], axis=-1)


# ---------------------------------------------------------------------------
# interface BxDFs (explicit-parameter forms of the bxdf.py lobes)
# ---------------------------------------------------------------------------

def _tr(dz: Array | float, w: Array) -> Array:
    """Transmittance through the homogeneous gap (LayeredBxDF::Tr)."""
    az = jnp.maximum(jnp.abs(w[..., 2]), 1e-7)
    return jnp.exp(-jnp.abs(jnp.asarray(dz, jnp.float32)) / az)


def _diel_sample(wo: Array, eta: Array, alpha: Array, rng: _Rng,
                 flags: str, mode: str, uc: Array | None = None,
                 u2: Array | None = None):
    """DielectricBxDF::Sample_f with per-lane smooth/rough selection.

    flags: 'all' | 'refl' | 'trans' (BxDFReflTransFlags). Returns
    (wi, f (...,), pdf, valid, is_trans, is_spec). For restricted flags the
    pdf matches the reference's renormalized pr/pt choice. uc/u2 override
    the internal RNG (the entrance sample uses the caller's stratified
    sampler dims, as the reference's Sample_f does)."""
    from . import bxdf as bx

    if uc is None:
        uc = rng.next()
    if u2 is None:
        u2 = rng.next2()
    smooth = alpha < _SMOOTH_EPS

    # --- smooth (specular) branch ---
    wi_mirror = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    frd = bx.fr_dielectric(vm.cos_theta(wo), eta)
    n_local = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), wo.shape)
    ok_t, etap_s, wt = vm.refract(wo, n_local, eta)
    if flags == "refl":
        choose_r_s = jnp.ones(wo.shape[:-1], bool)
        pdf_s = jnp.ones_like(frd)
        f_s = frd / jnp.maximum(vm.abs_cos_theta(wi_mirror), 1e-9)
    elif flags == "trans":
        choose_r_s = jnp.zeros(wo.shape[:-1], bool)
        pdf_s = jnp.ones_like(frd)
        f_s = (1.0 - frd) / jnp.maximum(vm.abs_cos_theta(wt), 1e-9)
        if mode == "radiance":
            f_s = f_s / jnp.maximum(etap_s * etap_s, 1e-9)
    else:
        choose_r_s = uc < frd
        pdf_s = jnp.where(choose_r_s, frd, 1.0 - frd)
        f_r = frd / jnp.maximum(vm.abs_cos_theta(wi_mirror), 1e-9)
        f_t = (1.0 - frd) / jnp.maximum(vm.abs_cos_theta(wt), 1e-9)
        if mode == "radiance":
            f_t = f_t / jnp.maximum(etap_s * etap_s, 1e-9)
        f_s = jnp.where(choose_r_s, f_r, f_t)
    wi_s = jnp.where(choose_r_s[..., None], wi_mirror, wt)
    valid_s = jnp.where(choose_r_s, frd > 0, ok_t & (frd < 1))

    # --- rough branch (visible-NDF wm; bxdfs.h DielectricBxDF rough) ---
    wo_up = jnp.where(wo[..., 2:3] < 0, -wo, wo)
    wm = bx.tr_sample_wm(wo_up, u2, alpha, alpha)
    fr_m = bx.fr_dielectric(vm.dot(wo, wm), eta)
    if flags == "refl":
        choose_r = jnp.ones(wo.shape[:-1], bool)
    elif flags == "trans":
        choose_r = jnp.zeros(wo.shape[:-1], bool)
    else:
        choose_r = uc < fr_m
    wi_r = vm.reflect(wo, wm)
    ok_rt, etap_r, wi_t = vm.refract(wo, wm, eta)
    wi_rough = jnp.where(choose_r[..., None], wi_r, wi_t)
    dummy_ctx = bx.MaterialCtx(
        mat_type=jnp.zeros(wo.shape[:-1], jnp.int32),
        refl=jnp.zeros(wo.shape[:-1] + (4,)), ax=alpha, ay=alpha,
        eta=eta, k=jnp.zeros_like(eta))
    f_full, pdf_full = bx._rough_dielectric_eval(
        dummy_ctx, wo, wi_rough, jnp.zeros(wo.shape[:-1], bool), mode=mode)
    # restricted flags renormalize the reflect/transmit choice probability
    if flags == "refl":
        pdf_r_ = pdf_full / jnp.maximum(fr_m, 1e-9)
        valid_r = vm.same_hemisphere(wo, wi_rough) & (fr_m > 0)
    elif flags == "trans":
        pdf_r_ = pdf_full / jnp.maximum(1.0 - fr_m, 1e-9)
        valid_r = ok_rt & ~vm.same_hemisphere(wo, wi_rough) & (fr_m < 1)
    else:
        pdf_r_ = pdf_full
        valid_r = jnp.where(choose_r, vm.same_hemisphere(wo, wi_rough),
                            ok_rt & ~vm.same_hemisphere(wo, wi_rough))

    wi = jnp.where(smooth[..., None], wi_s, wi_rough)
    f = jnp.where(smooth, f_s, f_full)
    pdf = jnp.where(smooth, pdf_s, pdf_r_)
    valid = jnp.where(smooth, valid_s, valid_r) & (jnp.abs(wi[..., 2]) > 1e-7)
    is_trans = ~vm.same_hemisphere(wo, wi)
    return wi, f, pdf, valid, is_trans, smooth


def _diel_f_pdf(wo: Array, wi: Array, eta: Array, alpha: Array, mode: str,
                flags: str = "all"):
    """DielectricBxDF::f / ::PDF — zero on smooth (delta) lanes. flags
    restricts which component's pdf is reported (renormalized)."""
    from . import bxdf as bx

    smooth = alpha < _SMOOTH_EPS
    dummy_ctx = bx.MaterialCtx(
        mat_type=jnp.zeros(wo.shape[:-1], jnp.int32),
        refl=jnp.zeros(wo.shape[:-1] + (4,)), ax=alpha, ay=alpha,
        eta=eta, k=jnp.zeros_like(eta))
    f, pdf = bx._rough_dielectric_eval(dummy_ctx, wo, wi, smooth, mode=mode)
    if flags != "all":
        is_refl = vm.same_hemisphere(wo, wi)
        # generalized half-vector Fresnel for the choice renormalization
        cos_o = vm.cos_theta(wo)
        etap = jnp.where(is_refl, 1.0,
                         jnp.where(cos_o > 0, eta, 1.0 / jnp.maximum(eta, 1e-9)))
        wm = wi * etap[..., None] + wo
        wm = vm.normalize(jnp.where(
            (vm.length_squared(wm) < 1e-16)[..., None], wo, wm))
        wm = jnp.where(wm[..., 2:3] < 0, -wm, wm)
        fr = bx.fr_dielectric(vm.dot(wo, wm), eta)
        if flags == "refl":
            pdf = jnp.where(is_refl, pdf / jnp.maximum(fr, 1e-9), 0.0)
            f = jnp.where(is_refl, f, 0.0)
        else:  # trans
            pdf = jnp.where(is_refl, 0.0, pdf / jnp.maximum(1.0 - fr, 1e-9))
            f = jnp.where(is_refl, 0.0, f)
    return f, pdf


def _base_f_pdf(ctx, cc: Array, wo: Array, wi: Array):
    """Bottom-interface f/pdf: DiffuseBxDF for coateddiffuse, ConductorBxDF
    for coatedconductor (per-lane select on cc). Direct lobe math — going
    through bxdf.evaluate here would price EVERY material lobe once per walk
    step (a ~7x whole-wave regression, measured on killeroo)."""
    from . import bxdf as bx

    refl_side = vm.same_hemisphere(wo, wi)
    abs_ci = vm.abs_cos_theta(wi)
    # diffuse
    f_d = jnp.where(refl_side[..., None], ctx.refl * (1.0 / jnp.pi), 0.0)
    pdf_d = jnp.where(refl_side, sampling.cosine_hemisphere_pdf(abs_ci), 0.0)
    # rough conductor (smooth lanes are delta: f = pdf = 0 here)
    smooth = bx.effectively_smooth(ctx.ax, ctx.ay)
    wm = wi + wo
    wm_len2 = vm.length_squared(wm)
    wm_n = vm.normalize(jnp.where((wm_len2 < 1e-12)[..., None], wo, wm))
    wm_n = jnp.where(wm_n[..., 2:3] < 0, -wm_n, wm_n)
    valid_m = (wm_len2 > 1e-12) & refl_side & ~smooth
    if ctx.eta_s is not None:
        fr_s = bx.fr_complex(vm.absdot(wo, wm_n)[..., None],
                             ctx.eta_s, ctx.k_s)
    else:
        fr_s = bx.fr_complex(vm.absdot(wo, wm_n), ctx.eta,
                             ctx.k)[..., None]
    d_ggx = bx.tr_d(wm_n, ctx.ax, ctx.ay)
    g_ggx = bx.tr_g(wo, wi, ctx.ax, ctx.ay)
    denom = jnp.maximum(4.0 * vm.abs_cos_theta(wo) * abs_ci, 1e-9)
    f_c = jnp.where(valid_m[..., None],
                    ctx.refl * fr_s * (d_ggx * g_ggx / denom)[..., None],
                    0.0)
    pdf_c = jnp.where(
        valid_m,
        bx.tr_pdf(wo, wm_n, ctx.ax, ctx.ay)
        / jnp.maximum(4.0 * vm.absdot(wo, wm_n), 1e-9), 0.0)
    return (jnp.where(cc[..., None], f_c, f_d),
            jnp.where(cc, pdf_c, pdf_d))


def _base_sample(ctx, cc: Array, wo: Array, rng: _Rng):
    """Bottom-interface Sample_f (reflection-only by construction).
    Returns (wi, f (...,4), pdf, valid, is_spec)."""
    from . import bxdf as bx

    uc = rng.next()  # parity with the reference's draw order
    u2 = rng.next2()
    # diffuse: cosine hemisphere on wo's side
    wi_d = sampling.sample_cosine_hemisphere(u2)
    wi_d = jnp.where(wo[..., 2:3] < 0, wi_d * jnp.array([1.0, 1.0, -1.0]), wi_d)
    pdf_d = sampling.cosine_hemisphere_pdf(vm.abs_cos_theta(wi_d))
    f_d = ctx.refl * (1.0 / jnp.pi)
    # conductor: smooth mirror or visible-NDF reflect
    smooth_c = bx.effectively_smooth(ctx.ax, ctx.ay)
    wi_mirror = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    if ctx.eta_s is not None:
        fr_s = bx.fr_complex(vm.abs_cos_theta(wo)[..., None], ctx.eta_s, ctx.k_s)
    else:
        fr_s = bx.fr_complex(vm.abs_cos_theta(wo), ctx.eta, ctx.k)[..., None]
    f_mirror = ctx.refl * fr_s / jnp.maximum(
        vm.abs_cos_theta(wi_mirror), 1e-9)[..., None]
    wo_up = jnp.where(wo[..., 2:3] < 0, -wo, wo)
    wm = bx.tr_sample_wm(wo_up, u2, ctx.ax, ctx.ay)
    wm = jnp.where(wo[..., 2:3] < 0, -wm, wm)
    wi_r = vm.reflect(wo, wm)
    f_r, pdf_r = _base_f_pdf(ctx, cc, wo, wi_r)
    wi_c = jnp.where(smooth_c[..., None], wi_mirror, wi_r)
    f_c = jnp.where(smooth_c[..., None], f_mirror, f_r)
    pdf_c = jnp.where(smooth_c, 1.0, pdf_r)
    valid_c = jnp.where(smooth_c, jnp.ones_like(smooth_c),
                        vm.same_hemisphere(wo, wi_r))

    wi = jnp.where(cc[..., None], wi_c, wi_d)
    f = jnp.where(cc[..., None], f_c, f_d)
    pdf = jnp.where(cc, pdf_c, pdf_d)
    valid = jnp.where(cc, valid_c, pdf_d > 0)
    is_spec = cc & smooth_c
    return wi, f, pdf, valid & (jnp.abs(wi[..., 2]) > 1e-7), is_spec


def _coat_params(ctx, cc: Array):
    """(coat_eta, coat_alpha): coat IOR is ctx.eta for coateddiffuse; the
    reference's interface.eta default 1.5 for coatedconductor (whose ctx.eta
    holds the conductor's complex IOR)."""
    coat_eta = jnp.where(cc, 1.5, ctx.eta)
    c = ctx.coat_ax if ctx.coat_ax is not None else jnp.zeros_like(ctx.eta)
    return coat_eta, c


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------

def coated_f(ctx, wo: Array, wi: Array, cc: Array,
             mode: str = "radiance", max_depth: int = 10,
             n_samples: int = 1, seed: int = 0):
    """Stochastic estimate of the layered f(wo, wi) (LayeredBxDF::f).

    cc: per-lane bool — True for coatedconductor base, False coateddiffuse.
    Only the reflection configuration is nonzero (both bases are opaque).
    Returns (..., 4) spectral f."""
    flip = wo[..., 2] < 0
    sgn = jnp.where(flip[..., None], -1.0, 1.0)
    wo = wo * sgn
    wi = wi * sgn
    refl_case = wi[..., 2] > 0

    coat_eta, coat_ax = _coat_params(ctx, cc)
    h1 = _hash_vec(wo, 0x51AB0F00 + seed)
    h2 = _hash_vec(wi, 0x2C1B3C6D)

    # entrance (= exit) interface reflection: top dielectric eval
    f_top, _ = _diel_f_pdf(wo, wi, coat_eta, coat_ax, mode)
    f = (n_samples * f_top)[..., None] * jnp.ones((1,) * (wo.ndim - 1) + (4,))

    for s in range(n_samples):
        rng = _Rng(h1, _mix(h2 + jnp.uint32((s * 0x68BC21EB) & 0xFFFFFFFF)))
        # transmit wo into the layer
        wos_wi, wos_f, wos_pdf, wos_ok, _, _ = _diel_sample(
            wo, coat_eta, coat_ax, rng, "trans", mode)
        # virtual light: transmit wi into the layer (adjoint transport)
        imode = "importance" if mode == "radiance" else "radiance"
        wis_wi, wis_f, wis_pdf, wis_ok, _, top_spec = _diel_sample(
            wi, coat_eta, coat_ax, rng, "trans", imode)
        ok = wos_ok & wis_ok & (wos_f > 0) & (wis_f > 0)

        beta = (wos_f * vm.abs_cos_theta(wos_wi)
                / jnp.maximum(wos_pdf, 1e-12))[..., None]
        beta = jnp.where(ok[..., None], beta, 0.0)
        w = wos_wi
        wis_fac = (wis_f * vm.abs_cos_theta(wis_wi)
                   / jnp.maximum(wis_pdf, 1e-12))
        contrib = jnp.zeros_like(f)

        for depth in range(max_depth):
            at_bottom = depth % 2 == 0  # z toggles thickness -> 0 -> ...
            beta = beta * _tr(THICKNESS, w)[..., None]
            if at_bottom:
                # NEE through the exit interface along the presampled wis
                f_b, pdf_b = _base_f_pdf(ctx, cc, -w, -wis_wi)
                wt = jnp.where(
                    top_spec, 1.0,
                    sampling.power_heuristic(1.0, wis_pdf, 1.0, pdf_b))
                contrib = contrib + beta * f_b * (
                    wt * _tr(THICKNESS, wis_wi) * wis_fac)[..., None]
                # bounce off the base
                bs_wi, bs_f, bs_pdf, bs_ok, base_spec = _base_sample(
                    ctx, cc, -w, rng)
                beta = beta * bs_f * (vm.abs_cos_theta(bs_wi)
                                      / jnp.maximum(bs_pdf, 1e-12))[..., None]
                beta = jnp.where(bs_ok[..., None], beta, 0.0)
                w = bs_wi
                # NEE exit along the BSDF-sampled direction (rough coat only)
                fx, _ = _diel_f_pdf(-w, wi, coat_eta, coat_ax, mode)
                _, x_pdf = _diel_f_pdf(-w, wi, coat_eta, coat_ax, mode,
                                       flags="trans")
                wt2 = jnp.where(
                    base_spec, 1.0,
                    sampling.power_heuristic(1.0, bs_pdf, 1.0, x_pdf))
                contrib = contrib + beta * (
                    jnp.where(top_spec, 0.0,
                              _tr(THICKNESS, w) * fx * wt2))[..., None]
            else:
                # reflect back down off the top (exit) interface
                bs_wi, bs_f, bs_pdf, bs_ok, _, _ = _diel_sample(
                    -w, coat_eta, coat_ax, rng, "refl", mode)
                beta = beta * (bs_f * vm.abs_cos_theta(bs_wi)
                               / jnp.maximum(bs_pdf, 1e-12))[..., None]
                beta = jnp.where(bs_ok[..., None], beta, 0.0)
                w = bs_wi
        f = f + contrib

    f = f / n_samples
    return jnp.where(refl_case[..., None], f, 0.0)


def coated_pdf(ctx, wo: Array, wi: Array, cc: Array,
               mode: str = "radiance", n_samples: int = 1, seed: int = 0):
    """Stochastic PDF estimate (LayeredBxDF::PDF): entrance reflection pdf +
    MIS-weighted TRT estimate, lerped 0.9 toward uniform-sphere."""
    flip = wo[..., 2] < 0
    sgn = jnp.where(flip[..., None], -1.0, 1.0)
    wo = wo * sgn
    wi = wi * sgn
    refl_case = wi[..., 2] > 0

    coat_eta, coat_ax = _coat_params(ctx, cc)
    h1 = _hash_vec(wi, 0x7F4A7C15 + seed)
    h2 = _hash_vec(wo, 0x94D049BB)

    _, pdf_top = _diel_f_pdf(wo, wi, coat_eta, coat_ax, mode, flags="refl")
    top_smooth = coat_ax < _SMOOTH_EPS
    pdf_sum = n_samples * jnp.where(top_smooth, 0.0, pdf_top)

    for s in range(n_samples):
        rng = _Rng(h1, _mix(h2 + jnp.uint32((s * 0x68BC21EB) & 0xFFFFFFFF)))
        wos_wi, wos_f, wos_pdf, wos_ok, _, _ = _diel_sample(
            wo, coat_eta, coat_ax, rng, "trans", mode)
        imode = "importance" if mode == "radiance" else "radiance"
        wis_wi, wis_f, wis_pdf, wis_ok, _, _ = _diel_sample(
            wi, coat_eta, coat_ax, rng, "trans", imode)
        ok = wos_ok & wis_ok & (wos_f > 0) & (wis_f > 0)

        # specular top: the walk's density collapses to the base reflection
        _, r_pdf_spec = _base_f_pdf(ctx, cc, -wos_wi, -wis_wi)

        # non-specular top: MIS combination (bxdfs.h TRT pdf estimate)
        rs_wi, rs_f, rs_pdf, rs_ok, rs_spec = _base_sample(ctx, cc, -wos_wi, rng)
        _, rPDF = _base_f_pdf(ctx, cc, -wos_wi, -wis_wi)
        wt_r = sampling.power_heuristic(1.0, wis_pdf, 1.0, rPDF)
        _, tPDF = _diel_f_pdf(-rs_wi, wi, coat_eta, coat_ax, mode)
        wt_t = sampling.power_heuristic(1.0, rs_pdf, 1.0, tPDF)
        # both MIS terms are gated on a valid base sample (bxdfs.h wraps the
        # whole estimate in `if (rs && rs->f && rs->pdf > 0)`)
        mis_est = jnp.where(rs_ok, wt_r * rPDF + wt_t * tPDF, 0.0)
        # base specular (smooth-conductor bottom): pdfSum += top.PDF(-rs.wi, wi)
        mis_est = jnp.where(rs_spec, jnp.where(rs_ok, tPDF, 0.0), mis_est)

        pdf_sum = pdf_sum + jnp.where(
            ok, jnp.where(top_smooth, r_pdf_spec, mis_est), 0.0)

    pdf = 0.1 * INV_4PI + 0.9 * pdf_sum / n_samples
    return jnp.where(refl_case, pdf, INV_4PI * 0.1)


def coated_sample(ctx, wo: Array, uc: Array, u2: Array, cc: Array,
                  mode: str = "radiance", max_depth: int = 10, seed: int = 0):
    """Random-walk Sample_f (LayeredBxDF::Sample_f, albedo=0 path).

    Returns (wi, f (...,4), pdf_proportional, valid, is_specular). The pdf is
    only PROPORTIONAL to the true density — bxdf.sample rescales f with
    coated_pdf and reports that estimate as the MIS pdf, exactly like the
    reference's BSDF::Sample_f pdfIsProportional handling."""
    flip = wo[..., 2] < 0
    sgn = jnp.where(flip[..., None], -1.0, 1.0)
    wo_f = wo * sgn

    coat_eta, coat_ax = _coat_params(ctx, cc)
    h1 = _hash_vec(wo_f, 0x2545F491 + seed)
    h2 = _mix(jax.lax.bitcast_convert_type(uc, jnp.uint32)
              ^ _hash_vec(jnp.concatenate([u2, uc[..., None]], -1), 0x63D83595))
    rng = _Rng(h1, h2)

    # entrance: full dielectric sample with the CALLER's stratified dims
    # (reflection exits immediately)
    e_wi, e_f, e_pdf, e_ok, e_trans, e_spec = _diel_sample(
        wo_f, coat_eta, coat_ax, rng, "all", mode, uc=uc, u2=u2)
    exit_refl = ~e_trans

    # walk state: the cosine is folded only for directions INSIDE the layers
    # (the reference folds AbsCosTheta after every interior scattering but
    # not on the exiting direction — the integrator applies the final |cos|)
    f_w = (e_f * jnp.where(e_trans, vm.abs_cos_theta(e_wi), 1.0)
           )[..., None] * jnp.ones((1,) * (wo.ndim - 1) + (4,))
    pdf_w = e_pdf
    w = e_wi
    ok = e_ok
    spec_path = e_spec
    out_wi = e_wi
    out_done = exit_refl
    # fixed unroll: interface visits alternate bottom (reflect) / top
    # (full sample; transmission exits the layer)
    for depth in range(max_depth):
        at_bottom = depth % 2 == 0
        f_w = jnp.where(out_done[..., None], f_w,
                        f_w * _tr(THICKNESS, w)[..., None])
        if at_bottom:
            bs_wi, bs_f, bs_pdf, bs_ok, bs_spec = _base_sample(ctx, cc, -w, rng)
            upd = ~out_done
            ok = ok & jnp.where(upd, bs_ok, True)
            f_w = jnp.where(upd[..., None],
                            f_w * bs_f * vm.abs_cos_theta(bs_wi)[..., None],
                            f_w)
            pdf_w = jnp.where(upd, pdf_w * bs_pdf, pdf_w)
            spec_path = spec_path & jnp.where(upd, bs_spec, True)
            w = jnp.where(upd[..., None], bs_wi, w)
        else:
            bs_wi, bs_f, bs_pdf, bs_ok, bs_trans, bs_spec = _diel_sample(
                -w, coat_eta, coat_ax, rng, "all", mode)
            upd = ~out_done
            ok = ok & jnp.where(upd, bs_ok, True)
            pdf_w = jnp.where(upd, pdf_w * bs_pdf, pdf_w)
            spec_path = spec_path & jnp.where(upd, bs_spec, True)
            exiting = upd & bs_trans
            # transmission f has no cosine factor on exit (the integrator
            # applies |cos wi| outside); interior bounces keep it
            f_w = jnp.where(upd[..., None], f_w * bs_f[..., None], f_w)
            f_w = jnp.where((upd & ~bs_trans)[..., None],
                            f_w * vm.abs_cos_theta(bs_wi)[..., None], f_w)
            out_wi = jnp.where(exiting[..., None], bs_wi, out_wi)
            out_done = out_done | bs_trans
            w = jnp.where(upd[..., None], bs_wi, w)

    valid = ok & out_done & (pdf_w > 0)
    wi_out = jnp.where(out_done[..., None], out_wi, w) * sgn
    return wi_out, f_w, pdf_w, valid, spec_path
