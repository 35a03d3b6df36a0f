"""Participating media: point-wise properties, HG phase function, majorants.

Batched counterpart of the reference's Medium family (`base/medium.h:76`,
impls `media.h/cpp`): HomogeneousMedium and GridMedium (RGBGrid/Cloud/NanoVDB
are converted to density grids at scene-build time). Like the reference's
RayMajorantIterator (`media.h:135` DDAMajorantIterator), grid media walk a
low-res majorant grid: `dda_init`/`dda_advance` below run the DDA per lane
with branch-free `jnp.where` stepping, so each lane uses a locally tight
majorant while control flow stays uniform across the vector. Homogeneous
media use a single conservative majorant (no grid to walk).

All property evaluation is pure VPU math over (R,)-batched lanes with a single
fused medium-record gather (same discipline as bxdf.gather_material).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import vecmath as vm, sampling, rgb2spec
from ..geometry import scene as scene_mod

Array = jax.Array


class MediumCtx(NamedTuple):
    """Per-lane medium record, spectrally expanded at the sampled wavelengths.

    sigma_a/sigma_s here are the *base* coefficients; multiply by the local
    density (density() below) for point properties. sigma_maj is the majorant:
    (sigma_a + sigma_s) * max_density >= sigma_t everywhere & per wavelength.
    """

    med_type: Array    # (...,) i32
    sigma_a: Array     # (..., 4) base absorption spectrum
    sigma_s: Array     # (..., 4) base scattering spectrum
    le: Array          # (..., 4) emitted radiance spectrum (0 if none)
    g: Array           # (...,) HG asymmetry
    grid_id: Array     # (...,) i32
    blo: Array         # (..., 3) grid world bounds
    bhi: Array         # (..., 3)
    sigma_maj: Array   # (..., 4) spectral majorant
    valid: Array       # (...,) med id >= 0
    temp_grid_id: Array = None  # (...,) i32 blackbody temperature grid
    #   (-1 = RGB Le; None when the scene has no temperature media)


def medium_records(scene: scene_mod.CompiledScene) -> Array:
    """(K, 20) fused medium table, built in-jit (differentiable w.r.t. the
    scale/coefficient columns): [0 type | 1:4 sa_coeffs | 4:7 ss_coeffs |
    7:10 le_coeffs | 10:14 scales (sa, ss, le, g) | 14 grid_id |
    15 max_density | 16:19 blo | 19:22 bhi | 22 temp_grid_id] -> width 23."""
    tg = (scene.med_temp_grid_id
          if getattr(scene, "med_temp_grid_id", None) is not None
          and scene.med_temp_grid_id.shape[0] == scene.med_type.shape[0]
          else jnp.full(scene.med_type.shape, -1, jnp.int32))
    return jnp.concatenate(
        [
            scene.med_type[:, None].astype(jnp.float32),
            scene.med_sa_coeffs,
            scene.med_ss_coeffs,
            scene.med_le_coeffs,
            scene.med_scales,
            scene.med_grid_id[:, None].astype(jnp.float32),
            scene.med_max_density[:, None],
            scene.med_bounds.reshape(-1, 6),
            tg[:, None].astype(jnp.float32),
        ],
        axis=-1,
    )


def gather_medium(scene: scene_mod.CompiledScene, med_id: Array, lam: Array,
                  med_all: Array | None = None) -> MediumCtx:
    """Fetch + spectrally expand per-lane medium params (ONE gather)."""
    if med_all is None:
        med_all = medium_records(scene)
    rec = med_all[jnp.maximum(med_id, 0)]
    sa = rgb2spec.eval_sigmoid_poly(rec[..., 1:4], lam) * rec[..., 10:11]
    ss = rgb2spec.eval_sigmoid_poly(rec[..., 4:7], lam) * rec[..., 11:12]
    le = rgb2spec.eval_sigmoid_poly(rec[..., 7:10], lam) * rec[..., 12:13]
    max_d = rec[..., 15:16]
    has_temp = (getattr(scene, "med_temp_grids", None) is not None
                and scene.med_temp_grids.size > 1)
    return MediumCtx(
        med_type=rec[..., 0].astype(jnp.int32),
        sigma_a=sa, sigma_s=ss, le=le,
        g=rec[..., 13],
        grid_id=rec[..., 14].astype(jnp.int32),
        blo=rec[..., 16:19], bhi=rec[..., 19:22],
        sigma_maj=jnp.maximum((sa + ss) * max_d, 1e-20),
        valid=med_id >= 0,
        temp_grid_id=(rec[..., 22].astype(jnp.int32) if has_temp else None),
    )


def _trilerp_grid(grids: Array, gi: Array, ctx: MediumCtx, p: Array):
    """Trilinear lookup of a (G, D, H, W) grid stack at world point p
    inside ctx's bounds. Returns (value, in_bounds)."""
    g_, d_, h_, w_ = grids.shape
    ext = jnp.maximum(ctx.bhi - ctx.blo, 1e-20)
    # grid-space continuous coords (pbrt voxel convention: sample at centers)
    gp = (p - ctx.blo) / ext
    inb = jnp.all((gp >= 0.0) & (gp <= 1.0), axis=-1)
    px = gp[..., 0] * w_ - 0.5
    py = gp[..., 1] * h_ - 0.5
    pz = gp[..., 2] * d_ - 0.5
    x0 = jnp.floor(px).astype(jnp.int32)
    y0 = jnp.floor(py).astype(jnp.int32)
    z0 = jnp.floor(pz).astype(jnp.int32)
    fx, fy, fz = px - x0, py - y0, pz - z0
    gi = jnp.clip(gi, 0, g_ - 1)

    def at(zi, yi, xi):
        return grids[
            gi,
            jnp.clip(zi, 0, d_ - 1),
            jnp.clip(yi, 0, h_ - 1),
            jnp.clip(xi, 0, w_ - 1),
        ]

    d00 = vm.lerp(fx, at(z0, y0, x0), at(z0, y0, x0 + 1))
    d10 = vm.lerp(fx, at(z0, y0 + 1, x0), at(z0, y0 + 1, x0 + 1))
    d01 = vm.lerp(fx, at(z0 + 1, y0, x0), at(z0 + 1, y0, x0 + 1))
    d11 = vm.lerp(fx, at(z0 + 1, y0 + 1, x0), at(z0 + 1, y0 + 1, x0 + 1))
    return vm.lerp(fz, vm.lerp(fy, d00, d10), vm.lerp(fy, d01, d11)), inb


def density(scene: scene_mod.CompiledScene, ctx: MediumCtx, p: Array) -> Array:
    """Local density at world point p: 1 for homogeneous, trilinear grid
    lookup for grid media (GridMedium::Density, media.h; 0 outside bounds)."""
    if scene.n_media == 0:
        return jnp.ones(p.shape[:-1], jnp.float32)
    dens, inb = _trilerp_grid(scene.med_grids, ctx.grid_id, ctx, p)
    is_grid = ctx.med_type == scene_mod.MED_GRID
    return jnp.where(is_grid, jnp.where(inb, dens, 0.0), 1.0)


def le_at(scene: scene_mod.CompiledScene, ctx: MediumCtx, p: Array,
          lam: Array) -> Array:
    """Emitted radiance spectrum at point p: the medium's RGB Le, or —
    when it carries a temperature grid — normalized BLACKBODY radiance at
    the local Kelvin temperature times the Le scale (GridMedium temperature
    emission, media.h:355; BlackbodySpectrum spectrum.h:497)."""
    if ctx.temp_grid_id is None:
        return ctx.le
    from ..core import spectrum as sp

    T, inb = _trilerp_grid(scene.med_temp_grids, ctx.temp_grid_id, ctx, p)
    # ctx.le carries le_scale * uplift(RGB Le); for temperature media the
    # RGB Le is (0,0,0) at build so the scale rides separately in the
    # records — recover it from the table would cost a gather; instead the
    # blackbody path stores Le=(1,1,1) so ctx.le IS the flat scale.
    bb = sp.blackbody_normalized(lam, jnp.maximum(T[..., None], 1.0))
    use_bb = (ctx.temp_grid_id >= 0) & inb & (T > 60.0)
    return jnp.where(use_bb[..., None], ctx.le * bb, ctx.le)


def segment_bounds(ctx: MediumCtx, o: Array, d: Array, t_hit: Array):
    """Clip the medium-sampling segment [0, t_hit] to the density-grid AABB
    for grid media (homogeneous media fill their enclosing geometry, so the
    segment is the full ray span). Returns (t0, t1) with t1 <= t_hit."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    ta = (ctx.blo - o) * inv_d
    tb = (ctx.bhi - o) * inv_d
    tmin = jnp.max(jnp.minimum(ta, tb), axis=-1)
    tmax = jnp.min(jnp.maximum(ta, tb), axis=-1)
    is_grid = ctx.med_type == scene_mod.MED_GRID
    t0 = jnp.where(is_grid, jnp.clip(tmin, 0.0, t_hit), 0.0)
    t1 = jnp.where(is_grid, jnp.clip(tmax, 0.0, t_hit), t_hit)
    t1 = jnp.maximum(t1, t0)
    return t0, t1


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function (media.h HGPhaseFunction)
# ---------------------------------------------------------------------------

INV_4PI = sampling.INV_4PI


def hg_p(cos_theta: Array, g: Array) -> Array:
    """HG phase function value p(cos theta) (HenyeyGreenstein, media.h)."""
    g = jnp.clip(g, -0.99, 0.99)
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / jnp.maximum(denom * vm.safe_sqrt(denom), 1e-12)


def phase_p(wo: Array, wi: Array, g: Array) -> Array:
    """p(wo, wi) — note pbrt's convention: the HG cosine is measured between
    the two directions with wo pointing away (HGPhaseFunction::p uses
    Dot(wo, wi))."""
    return hg_p(vm.dot(wo, wi), g)


def phase_sample(wo: Array, u2: Array, g: Array):
    """Sample_p: returns (wi, pdf) with pdf == p (perfect importance
    sampling; PhaseFunctionSample media.h)."""
    g = jnp.clip(g, -0.99, 0.99)
    iso = jnp.abs(g) < 1e-3
    u0 = u2[..., 0]
    cos_iso = 1.0 - 2.0 * u0
    sq = (1.0 - g * g) / jnp.maximum(1.0 + g - 2.0 * g * u0, 1e-9)
    two_g = jnp.where(jnp.abs(g) < 1e-9, 1e-9, 2.0 * g)
    cos_hg = -(1.0 + g * g - sq * sq) / two_g
    cos_t = jnp.where(iso, cos_iso, jnp.clip(cos_hg, -1.0, 1.0))
    sin_t = vm.safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * jnp.pi * u2[..., 1]
    # frame around wo (pbrt samples about wo with Dot(wo, wi)=cos)
    t1, t2 = vm.coordinate_system(wo)
    wi = (
        sin_t[..., None] * jnp.cos(phi)[..., None] * t1
        + sin_t[..., None] * jnp.sin(phi)[..., None] * t2
        + cos_t[..., None] * wo
    )
    pdf = hg_p(cos_t, g)
    return wi, pdf


# ---------------------------------------------------------------------------
# per-lane DDA over the low-res majorant grid (DDAMajorantIterator,
# media.h:135) — all state is SoA arrays carried through the null-scattering
# while_loop, so every lane advances its own majorant segment with masked
# selects instead of divergent control flow.
# ---------------------------------------------------------------------------

class DDAState(NamedTuple):
    voxel: Array       # (..., 3) i32 current supervoxel
    next_cross: Array  # (..., 3) t of next crossing per axis
    step: Array        # (..., 3) i32 +-1
    delta: Array       # (..., 3) t per voxel step
    seg_end: Array     # (...,) end of the current majorant segment
    maj_dens: Array    # (...,) local majorant density (supervoxel max)


def _maj_lookup(scene: scene_mod.CompiledScene, ctx: MediumCtx,
                voxel: Array) -> Array:
    """Majorant density of a supervoxel; homogeneous media return their
    global max_density (their 'grid' is the 1-cell ones grid)."""
    maj = scene.med_maj_grids  # (G, M, M, M)
    g_, mz, my, mx = maj.shape
    gi = jnp.clip(ctx.grid_id, 0, g_ - 1)
    v = maj[gi,
            jnp.clip(voxel[..., 2], 0, mz - 1),
            jnp.clip(voxel[..., 1], 0, my - 1),
            jnp.clip(voxel[..., 0], 0, mx - 1)]
    is_grid = ctx.med_type == scene_mod.MED_GRID
    return jnp.where(is_grid, v, 1.0)


def dda_init(scene: scene_mod.CompiledScene, ctx: MediumCtx,
             o: Array, d: Array, t0: Array, t1: Array) -> DDAState:
    """Set up the majorant DDA at ray parameter t0 (media.h:136-170).
    Homogeneous lanes get a single segment [t0, t1] with maj_dens = 1
    (their max_density is folded into sigma_maj by the caller)."""
    res = scene.med_maj_grids.shape[1]
    ext = jnp.maximum(ctx.bhi - ctx.blo, 1e-20)
    # normalized grid space
    og = (o - ctx.blo) / ext
    dg = d / ext
    p_ent = og + t0[..., None] * dg
    voxel = jnp.clip((p_ent * res).astype(jnp.int32), 0, res - 1)
    d_safe = jnp.where(jnp.abs(dg) < 1e-12, 1e-12, dg)
    pos_dir = d_safe >= 0
    step = jnp.where(pos_dir, 1, -1)
    next_vox_pos = jnp.where(pos_dir, (voxel + 1).astype(jnp.float32),
                             voxel.astype(jnp.float32)) / res
    next_cross = t0[..., None] + (next_vox_pos - p_ent) / d_safe
    delta = 1.0 / (jnp.abs(d_safe) * res)
    is_grid = (ctx.med_type == scene_mod.MED_GRID)[..., None]
    big = jnp.full_like(next_cross, 1e30)
    next_cross = jnp.where(is_grid, next_cross, big)
    seg_end = jnp.where(is_grid[..., 0],
                        jnp.minimum(jnp.min(next_cross, -1), t1), t1)
    st = DDAState(voxel=voxel, next_cross=next_cross,
                  step=step.astype(jnp.int32), delta=delta,
                  seg_end=seg_end, maj_dens=jnp.ones(t0.shape, jnp.float32))
    return st._replace(maj_dens=_maj_lookup(scene, ctx, voxel))


def dda_advance(scene: scene_mod.CompiledScene, ctx: MediumCtx,
                st: DDAState, t1: Array, active: Array) -> DDAState:
    """Advance active lanes to the next supervoxel (DDAMajorantIterator::
    Next stepping, media.h:173-196), masked for inactive lanes."""
    axis = jnp.argmin(st.next_cross, axis=-1)
    onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
    voxel = st.voxel + jnp.where(active[..., None], onehot * st.step, 0)
    next_cross = st.next_cross + jnp.where(
        active[..., None], onehot.astype(jnp.float32) * st.delta, 0.0)
    seg_end = jnp.where(active,
                        jnp.minimum(jnp.min(next_cross, -1), t1), st.seg_end)
    maj = _maj_lookup(scene, ctx, voxel)
    return DDAState(voxel=voxel, next_cross=next_cross, step=st.step,
                    delta=st.delta, seg_end=seg_end,
                    maj_dens=jnp.where(active, maj, st.maj_dens))
