"""Metropolis light transport (MLTIntegrator, cpu/integrators.h:384).

Primary-sample-space Metropolis (Kelemen et al.) over the wavefront path
tracer: the reference's MLT mutates BDPT strategy sample vectors
(integrators.cpp:2545, MLTSampler samplers.h:735); this re-design runs
many Markov chains as dense lanes, each chain's state a primary-sample
u-vector that drives trace_wave through the TABLE sampler kind (the pixel
position, wavelengths, and every bounce decision all live in u, so large
steps re-sample everything and small steps make correlated local moves).
Deviation noted in-docstring: the target is the unidirectional MIS path
tracer, not BDPT — same stationary distribution machinery, simpler proposal.

All chains advance in lock-step under one jitted lax.scan; film splats are
scatter-adds into an XYZ buffer with the standard Veach expected-value
weights a/y' and (1-a)/y, scaled by b (bootstrap mean luminance) at develop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import samplers, spectrum, rng
from ..scatter import lightsamplers
from . import film as film_mod
from .integrator import (IntegratorConfig, DIM_PATH_BASE, DIMS_PER_DEPTH,
                         trace_wave)

Array = jax.Array


def _n_dims(cfg: IntegratorConfig) -> int:
    return DIM_PATH_BASE + cfg.max_depth * DIMS_PER_DEPTH


def render_mlt(scene, dbvh, cam, spp: int = 16, seed: int = 0,
               cfg: IntegratorConfig = IntegratorConfig(),
               n_chains: int = 4096, n_bootstrap_batches: int = 4,
               p_large: float = 0.3, sigma_min: float = 1.0 / 1024.0,
               sigma_max: float = 1.0 / 64.0):
    """MLT render: total mutations ~= spp * n_pixels (mutationsPerPixel
    analog). Returns (H, W, 3) linear sRGB."""
    W, H = cam.width, cam.height
    R = W * H
    # keep chains long enough to mix: at least 8 mutation steps per chain
    C = min(n_chains, max(256, (spp * R) // 8))
    D = _n_dims(cfg)
    K = max(8, (spp * R) // C)  # mutation steps (mutationsPerPixel analog)
    # bootstrap must pin b (the image brightness) well: >= 32k samples
    n_bootstrap_batches = max(n_bootstrap_batches, 32768 // C + 1)
    ls_tables = lightsamplers.build(scene, cfg.light_sampler)
    from ..accel import dispatch
    isect = dispatch.make_intersectors(scene, dbvh, traversal=cfg.traversal)
    scene, dbvh, ls_tables = jax.tree.map(jnp.asarray, (scene, dbvh, ls_tables))
    # big arrays as jit ARGS, not closures (see dispatch.py jit-boundary rule)
    big = (scene, dbvh, ls_tables, isect.tables)
    lane = jnp.arange(C, dtype=jnp.int32)
    dims = jnp.arange(D, dtype=jnp.int32)

    def fresh(step: Array, salt: int) -> Array:
        return rng.hash_float(lane[:, None], dims[None, :],
                              jnp.asarray(step, jnp.uint32),
                              jnp.uint32(seed), jnp.uint32(salt))

    def chain_rand(step: Array, salt: int) -> Array:
        return rng.hash_float(lane, jnp.asarray(step, jnp.uint32),
                              jnp.uint32(seed), jnp.uint32(salt))

    def trace_u(u: Array, big):
        """u (C,D) -> (pixel, xyz contribution (C,3), luminance y)."""
        scene, dbvh, ls_tables, tables = big
        px = u[:, 0] * W
        py = u[:, 1] * H
        ix = jnp.clip(px.astype(jnp.int32), 0, W - 1)
        iy = jnp.clip(py.astype(jnp.int32), 0, H - 1)
        pix = iy * W + ix
        table = u.at[:, 0].set(px - ix).at[:, 1].set(py - iy)
        scfg = samplers.SamplerConfig(samplers.TABLE, seed, spp, W, table)
        L, lam, lam_pdf, _ = trace_wave(scene, dbvh, cam, scfg, cfg,
                                        pix, lane, ls_tables,
                                        isect.bind(tables))
        xyz = spectrum.spectrum_to_xyz(L, lam, lam_pdf)
        xyz = jnp.where(jnp.isfinite(xyz), xyz, 0.0)
        return pix, xyz, jnp.maximum(xyz[:, 1], 0.0)

    # --- bootstrap: b = E[y]; starts resampled proportional to y ----------
    b_sum = 0.0
    best_u, best_y, best_pix, best_xyz = None, None, None, None
    for i in range(n_bootstrap_batches):
        u0 = fresh(jnp.int32(1000 + i), 11)
        pix0, xyz0, y0 = jax.jit(trace_u)(u0, big)
        b_sum = b_sum + float(jnp.mean(y0))
        if best_u is None:
            best_u, best_y, best_pix, best_xyz = u0, y0, pix0, xyz0
        else:
            # keep the lane-wise higher-luminance start (cheap resampling)
            take = y0 > best_y
            best_u = jnp.where(take[:, None], u0, best_u)
            best_y = jnp.where(take, y0, best_y)
            best_pix = jnp.where(take, pix0, best_pix)
            best_xyz = jnp.where(take[:, None], xyz0, best_xyz)
    b = b_sum / n_bootstrap_batches
    # weighted resampling across lanes proportional to y (one categorical
    # draw per chain) so dead (y=0) starts are eliminated
    cdf = jnp.cumsum(best_y)
    tot = jnp.maximum(cdf[-1], 1e-12)
    pick = jnp.searchsorted(cdf / tot, chain_rand(jnp.int32(0), 13))
    pick = jnp.clip(pick, 0, C - 1)
    u = best_u[pick]
    y = jnp.maximum(best_y[pick], 1e-12)
    pix = best_pix[pick]
    xyz = best_xyz[pick]

    log_ratio = -jnp.log(sigma_max / sigma_min)

    def step(big, carry, k):
        u, y, pix, xyz, splat = carry
        # proposal: Kelemen small-step exponential perturbation | large step
        u_l = fresh(k, 17)
        eps = sigma_max * jnp.exp(log_ratio * fresh(k, 19))
        sgn = jnp.where(fresh(k, 23) < 0.5, 1.0, -1.0)
        u_s = u + sgn * eps
        u_s = u_s - jnp.floor(u_s)  # wrap to [0,1)
        large = chain_rand(k, 29) < p_large
        u_p = jnp.where(large[:, None], u_l, u_s)
        pix_p, xyz_p, y_p = trace_u(u_p, big)
        a = jnp.clip(y_p / y, 0.0, 1.0)
        # expected-value splats (Veach 10.4.1 / pbrt MLT film splats)
        splat = splat.at[pix_p].add(
            (a / jnp.maximum(y_p, 1e-12))[:, None] * xyz_p)
        splat = splat.at[pix].add(((1.0 - a) / y)[:, None] * xyz)
        acc = chain_rand(k, 31) < a
        u = jnp.where(acc[:, None], u_p, u)
        y = jnp.maximum(jnp.where(acc, y_p, y), 1e-12)
        pix = jnp.where(acc, pix_p, pix)
        xyz = jnp.where(acc[:, None], xyz_p, xyz)
        return (u, y, pix, xyz, splat), None

    splat0 = jnp.zeros((R, 3), jnp.float32)

    @jax.jit
    def run(u, y, pix, xyz, big):
        (u, y, pix, xyz, splat), _ = jax.lax.scan(
            lambda c, k: step(big, c, k), (u, y, pix, xyz, splat0),
            jnp.arange(1, K + 1))
        return splat

    splat = run(u, y, pix, xyz, big)
    # I_p = b * R * E_pi[C_p(u)/y(u)] over the K*C mutation samples
    film = film_mod.make_film(H, W)._replace(splat_xyz=splat)
    return film_mod.develop(film, splat_scale=b * R / (K * C))
