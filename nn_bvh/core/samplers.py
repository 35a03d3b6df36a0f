"""Stateless per-ray samplers.

Counterpart of the reference's Sampler tagged-pointer family
(`base/sampler.h:36`, impls `samplers.h:33-735`). The reference samplers are
*stateful* objects (StartPixelSample / Get1D / Get2D); here every sample
dimension must be a pure function of (pixel, sample_index, dimension), so each
sampler here is

    u = get_1d(cfg, pixel_index, sample_index, dim)
    (u, v) = get_2d(cfg, pixel_index, sample_index, dim)

fully vectorized over ray batches. The wavefront integrator pre-generates all
dimensions for a bounce into SoA arrays exactly like the reference's
GenerateRaySamples stage (`wavefront/samples.cpp:19`).

Implemented: INDEPENDENT (hash-based, = IndependentSampler),
STRATIFIED (jittered in sample-count grid), SOBOL (Owen-scrambled padded Sobol',
= PaddedSobolSampler with FastOwen randomization), HALTON (scrambled radical
inverse padding), ZSOBOL (= ZSobolSampler, samplers.h: blue-noise Ahmed-Wonka
morton-order base-4 index shuffling over Owen-scrambled Sobol').
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import rng, lowdiscrepancy as ld

Array = jax.Array

INDEPENDENT = 0
STRATIFIED = 1
SOBOL = 2
HALTON = 3
ZSOBOL = 4
TABLE = 5  # u-vector driven (MLT primary-sample-space chains)
SOBOL_GLOBAL = 6  # full Sobol' matrices, one global sequence (SobolSampler)
PMJ02 = 7         # generated pmj02 point sets (PMJ02BNSampler)


class SamplerConfig(NamedTuple):
    kind: int  # static python int — selects code path at trace time
    seed: int
    spp: int  # samples per pixel (for stratified / sobol log2 rounding)
    width: int = 0  # image width (ZSobol needs 2D pixel coords from the flat index)
    table: Array | None = None  # (lanes, D) u-values for kind=TABLE; the
    # MLT driver passes sample_index = lane index so get_* can row-index it
    sobol_v: Array | None = None  # (D, 32) u32 direction numbers (SOBOL_GLOBAL)
    pmj: Array | None = None      # (N, 2) pmj02 point set (PMJ02)


def make_sampler(kind: str = "sobol", seed: int = 0, spp: int = 16,
                 width: int = 0) -> SamplerConfig:
    kinds = {
        "independent": INDEPENDENT,
        "stratified": STRATIFIED,
        "sobol": SOBOL,
        "paddedsobol": SOBOL,
        "zsobol": ZSOBOL,
        "pmj02bn": PMJ02,      # generated pmj02 sets (ld.generate_pmj02)
        "fullsobol": SOBOL_GLOBAL,
        "halton": HALTON,
    }
    k = kinds[kind]
    sobol_v = pmj = None
    if k == SOBOL_GLOBAL:
        sobol_v = jnp.asarray(_sobol_matrices_cached())
    elif k == PMJ02:
        n = 1 << max(2, int(spp - 1).bit_length())
        pmj = jnp.asarray(_pmj02_cached(max(n, 4), seed=0))
    return SamplerConfig(k, seed, spp, width, sobol_v=sobol_v, pmj=pmj)


import functools as _ft


@_ft.lru_cache(maxsize=2)
def _sobol_matrices_cached(n_dims: int = 64):
    return ld.generate_sobol_matrices(n_dims)


@_ft.lru_cache(maxsize=4)
def _pmj02_cached(n: int, seed: int = 0):
    return ld.generate_pmj02(n, seed)


def _pixel_xy(cfg: SamplerConfig, pixel: Array):
    if cfg.width > 0:
        w = jnp.uint32(cfg.width)
        p = jnp.asarray(pixel, jnp.uint32)
        return p % w, p // w
    return jnp.asarray(pixel, jnp.uint32), jnp.zeros_like(pixel, jnp.uint32)


def _log2_ceil(n: int) -> int:
    return max(1, int(n - 1).bit_length())


def get_1d(cfg: SamplerConfig, pixel: Array, sample: Array, dim) -> Array:
    """One sample dimension in [0,1). pixel/sample are int32 arrays, dim int."""
    if cfg.kind == TABLE:
        d = jnp.clip(jnp.asarray(dim, jnp.int32), 0, cfg.table.shape[1] - 1)
        return cfg.table[sample, d]
    dim = jnp.asarray(dim, jnp.uint32)
    if cfg.kind == INDEPENDENT:
        return rng.hash_float(pixel, sample, dim, jnp.uint32(cfg.seed))
    if cfg.kind == STRATIFIED:
        u = rng.hash_float(pixel, sample, dim, jnp.uint32(cfg.seed))
        return (sample.astype(jnp.float32) + u) / cfg.spp
    if cfg.kind == SOBOL:
        log_n = _log2_ceil(cfg.spp)
        pad_seed = rng.hash_combine(pixel, dim, jnp.uint32(cfg.seed))
        idx = ld.owen_shuffle_index(sample, log_n, pad_seed)
        x, _ = ld.owen_scrambled_sobol_2d(idx, pad_seed ^ jnp.uint32(0x55555555), pad_seed)
        return x
    if cfg.kind == HALTON:
        pad_seed = rng.hash_combine(pixel, dim, jnp.uint32(cfg.seed))
        log_n = _log2_ceil(cfg.spp)
        idx = ld.owen_shuffle_index(sample, log_n, pad_seed)
        return ld.radical_inverse(0, idx + (pad_seed >> 16))
    if cfg.kind == ZSOBOL:
        px, py = _pixel_xy(cfg, pixel)
        idx = ld.zsobol_shuffled_index(px, py, sample, _log2_ceil(cfg.spp),
                                       dim, jnp.uint32(cfg.seed))
        x, _ = ld.owen_scrambled_sobol_2d(
            idx, rng.hash_combine(dim, jnp.uint32(cfg.seed)),
            rng.hash_combine(dim, jnp.uint32(cfg.seed ^ 0x9E377)))
        return x
    if cfg.kind == SOBOL_GLOBAL:
        # one global Sobol' sequence: dimension d of sample `sample`, with
        # per-pixel Owen scrambling (SobolSampler + FastOwen randomizer)
        d = int(dim) % cfg.sobol_v.shape[0]
        v = ld.sobol_sample_dim(cfg.sobol_v[d], jnp.asarray(sample, jnp.uint32))
        scr = ld.reverse_bits32(ld.fast_owen_scramble(
            ld.reverse_bits32(v),
            rng.hash_combine(pixel, jnp.uint32(d), jnp.uint32(cfg.seed))))
        return scr.astype(jnp.float32) * (1.0 / 4294967296.0)
    if cfg.kind == PMJ02:
        # per-pixel/dim Owen-scrambled pmj02 set (PMJ02BNSampler: the
        # scramble preserves the (0,2)-net stratification per pixel)
        n = cfg.pmj.shape[0]
        idx = jnp.asarray(sample, jnp.uint32) % jnp.uint32(n)
        u = cfg.pmj[idx, jnp.asarray(dim, jnp.int32) % 2]
        bits = (u * 4294967296.0).astype(jnp.uint32)
        scr = ld.reverse_bits32(ld.fast_owen_scramble(
            ld.reverse_bits32(bits),
            rng.hash_combine(pixel, dim, jnp.uint32(cfg.seed))))
        return scr.astype(jnp.float32) * (1.0 / 4294967296.0)
    raise ValueError(f"unknown sampler kind {cfg.kind}")


def get_2d(cfg: SamplerConfig, pixel: Array, sample: Array, dim) -> tuple[Array, Array]:
    """A 2D sample in [0,1)^2; consumes dims (dim, dim+1)."""
    if cfg.kind == TABLE:
        d = jnp.clip(jnp.asarray(dim, jnp.int32), 0, cfg.table.shape[1] - 2)
        return cfg.table[sample, d], cfg.table[sample, d + 1]
    dim = jnp.asarray(dim, jnp.uint32)
    if cfg.kind == INDEPENDENT:
        return (
            rng.hash_float(pixel, sample, dim, jnp.uint32(cfg.seed)),
            rng.hash_float(pixel, sample, dim + jnp.uint32(1), jnp.uint32(cfg.seed)),
        )
    if cfg.kind == STRATIFIED:
        # jittered NxN grid over the sample index (N = ceil(sqrt(spp)))
        import math

        n = int(math.ceil(math.sqrt(cfg.spp)))
        # decorrelate strata order per pixel/dim
        perm = rng.hash_combine(pixel, dim, jnp.uint32(cfg.seed))
        s = (sample.astype(jnp.uint32) + perm) % jnp.uint32(n * n)
        sx = (s % n).astype(jnp.float32)
        sy = (s // n).astype(jnp.float32)
        jx = rng.hash_float(pixel, sample, dim, jnp.uint32(cfg.seed))
        jy = rng.hash_float(pixel, sample, dim + jnp.uint32(1), jnp.uint32(cfg.seed))
        return (sx + jx) / n, (sy + jy) / n
    if cfg.kind == SOBOL:
        log_n = _log2_ceil(cfg.spp)
        pad_seed = rng.hash_combine(pixel, dim, jnp.uint32(cfg.seed))
        idx = ld.owen_shuffle_index(sample, log_n, pad_seed)
        return ld.owen_scrambled_sobol_2d(
            idx, pad_seed ^ jnp.uint32(0x55555555), rng.mix_bits(pad_seed)
        )
    if cfg.kind == HALTON:
        pad_seed = rng.hash_combine(pixel, dim, jnp.uint32(cfg.seed))
        log_n = _log2_ceil(cfg.spp)
        idx = ld.owen_shuffle_index(sample, log_n, pad_seed)
        off = pad_seed >> 16
        return ld.radical_inverse(0, idx + off), ld.radical_inverse(1, idx + off)
    if cfg.kind == ZSOBOL:
        px, py = _pixel_xy(cfg, pixel)
        idx = ld.zsobol_shuffled_index(px, py, sample, _log2_ceil(cfg.spp),
                                       dim, jnp.uint32(cfg.seed))
        return ld.owen_scrambled_sobol_2d(
            idx, rng.hash_combine(dim, jnp.uint32(cfg.seed)),
            rng.hash_combine(dim, jnp.uint32(cfg.seed ^ 0x9E377)))
    if cfg.kind == SOBOL_GLOBAL:
        d = int(dim) % cfg.sobol_v.shape[0]
        s_u = jnp.asarray(sample, jnp.uint32)
        vx = ld.sobol_sample_dim(cfg.sobol_v[d], s_u)
        vy = ld.sobol_sample_dim(cfg.sobol_v[(d + 1) % cfg.sobol_v.shape[0]],
                                 s_u)
        sx = ld.reverse_bits32(ld.fast_owen_scramble(
            ld.reverse_bits32(vx),
            rng.hash_combine(pixel, jnp.uint32(d), jnp.uint32(cfg.seed))))
        sy = ld.reverse_bits32(ld.fast_owen_scramble(
            ld.reverse_bits32(vy),
            rng.hash_combine(pixel, jnp.uint32(d + 1),
                             jnp.uint32(cfg.seed))))
        k = jnp.float32(1.0 / 4294967296.0)
        return sx.astype(jnp.float32) * k, sy.astype(jnp.float32) * k
    if cfg.kind == PMJ02:
        # the 2D pmj02 point per (pixel, sample, dim-pair), Owen-scrambled
        # per axis (preserves the (0,2)-net)
        n = cfg.pmj.shape[0]
        idx = jnp.asarray(sample, jnp.uint32) % jnp.uint32(n)
        ux = (cfg.pmj[idx, 0] * 4294967296.0).astype(jnp.uint32)
        uy = (cfg.pmj[idx, 1] * 4294967296.0).astype(jnp.uint32)
        sx = ld.reverse_bits32(ld.fast_owen_scramble(
            ld.reverse_bits32(ux),
            rng.hash_combine(pixel, dim, jnp.uint32(cfg.seed))))
        sy = ld.reverse_bits32(ld.fast_owen_scramble(
            ld.reverse_bits32(uy),
            rng.hash_combine(pixel, dim, jnp.uint32(cfg.seed ^ 0x71F3))))
        k = jnp.float32(1.0 / 4294967296.0)
        return sx.astype(jnp.float32) * k, sy.astype(jnp.float32) * k
    raise ValueError(f"unknown sampler kind {cfg.kind}")
