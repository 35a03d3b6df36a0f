"""Perlin gradient noise + fractal sums (host-side numpy).

Counterpart of the reference's `util/noise.cpp` (Noise/FBm/Turbulence used by
the FBm/Windy/Wrinkled/Marble textures, textures.h). Procedural textures are
*baked* into the fixed-resolution spectral texture stack at scene-build time —
the batch-first choice: one gather at render time instead of per-hit transcen-
dental noise evaluation (the reference evaluates noise per shading point).
"""

from __future__ import annotations

import numpy as np


def _grad_hash(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray,
               seed: int) -> np.ndarray:
    """Hashed unit gradients on the integer lattice (the reference uses a
    permutation table, noise.cpp NoisePerm; a mix hash is equivalent)."""
    h = (ix.astype(np.uint32) * np.uint32(0x9E3779B1)
         ^ iy.astype(np.uint32) * np.uint32(0x85EBCA77)
         ^ iz.astype(np.uint32) * np.uint32(0xC2B2AE3D)
         ^ np.uint32((seed * 0x27D4EB2F) & 0xFFFFFFFF))
    h ^= h >> 15
    h = h * np.uint32(0x2C1B3C6D)
    h ^= h >> 12
    # 12 canonical Perlin gradient directions
    g = np.asarray(
        [[1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
         [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
         [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1]], np.float32)
    return g[(h % 12).astype(np.int64)]


def perlin(p: np.ndarray, seed: int = 0) -> np.ndarray:
    """Gradient noise at points p (..., 3) -> (...,) in about [-1, 1]."""
    p = np.asarray(p, np.float32)
    pi = np.floor(p).astype(np.int64)
    pf = p - pi
    out = np.zeros(p.shape[:-1], np.float32)
    w = pf * pf * pf * (pf * (pf * 6 - 15) + 10)  # quintic fade
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corner = np.stack([pi[..., 0] + dx, pi[..., 1] + dy,
                                   pi[..., 2] + dz], -1)
                g = _grad_hash(corner[..., 0], corner[..., 1], corner[..., 2],
                               seed)
                d = pf - np.asarray([dx, dy, dz], np.float32)
                dot = (g * d).sum(-1)
                wx = w[..., 0] if dx else 1 - w[..., 0]
                wy = w[..., 1] if dy else 1 - w[..., 1]
                wz = w[..., 2] if dz else 1 - w[..., 2]
                out += dot * wx * wy * wz
    return out


def fbm(p: np.ndarray, octaves: int = 6, omega: float = 0.5,
        seed: int = 0) -> np.ndarray:
    """Fractional Brownian motion (util/noise FBm)."""
    out = np.zeros(np.asarray(p).shape[:-1], np.float32)
    lam, o = 1.0, 1.0
    for i in range(octaves):
        out += o * perlin(np.asarray(p) * lam, seed + i)
        lam *= 1.99
        o *= omega
    return out


def turbulence(p: np.ndarray, octaves: int = 6, omega: float = 0.5,
               seed: int = 0) -> np.ndarray:
    """Sum of |noise| octaves (util/noise Turbulence)."""
    out = np.zeros(np.asarray(p).shape[:-1], np.float32)
    lam, o = 1.0, 1.0
    for i in range(octaves):
        out += o * np.abs(perlin(np.asarray(p) * lam, seed + i))
        lam *= 1.99
        o *= omega
    return out


# ---------------------------------------------------------------------------
# baked procedural texture images (textures.h FBmTexture / WrinkledTexture /
# WindyTexture / MarbleTexture / DotsTexture over the uv plane)
# ---------------------------------------------------------------------------

def bake(kind: str, res: int = 256, scale: float = 8.0, octaves: int = 6,
         omega: float = 0.5, seed: int = 0,
         rgb1=(0.12, 0.1, 0.08), rgb2=(0.9, 0.88, 0.82)) -> np.ndarray:
    """-> (res, res, 3) RGB image of the named procedural texture evaluated
    over the uv unit square (z = 0.5 slice of the 3D field)."""
    u = (np.arange(res) + 0.5) / res
    uu, vv = np.meshgrid(u, u, indexing="xy")
    p = np.stack([uu * scale, vv * scale, np.full_like(uu, 0.5)], -1)
    c1 = np.asarray(rgb1, np.float32)
    c2 = np.asarray(rgb2, np.float32)
    if kind == "fbm":
        t = 0.5 + 0.5 * fbm(p, octaves, omega, seed)
    elif kind == "wrinkled":
        t = np.clip(turbulence(p, octaves, omega, seed), 0, 1)
    elif kind == "windy":
        strength = np.abs(fbm(p * 0.1, 3, omega, seed))
        t = np.clip(strength * np.abs(fbm(p, octaves, omega, seed + 7)), 0, 1)
    elif kind == "marble":
        variation = 0.2
        marble = p[..., 1] * scale * 0.2 + variation * fbm(p, octaves, omega, seed)
        t = 0.5 + 0.5 * np.sin(marble * np.pi)
    elif kind == "dots":
        cell = np.floor(p[..., :2])
        h = (cell[..., 0].astype(np.uint32) * np.uint32(0x9E3779B1)
             ^ cell[..., 1].astype(np.uint32) * np.uint32(0x85EBCA77)
             ^ np.uint32(seed))
        h ^= h >> 13
        h = h * np.uint32(0x5BD1E995)
        cx = cell[..., 0] + 0.35 + 0.3 * ((h & 0xFF) / 255.0)
        cy = cell[..., 1] + 0.35 + 0.3 * (((h >> 8) & 0xFF) / 255.0)
        r = 0.35 * (((h >> 16) & 0xFF) / 255.0) + 0.1
        d2 = (p[..., 0] - cx) ** 2 + (p[..., 1] - cy) ** 2
        t = (d2 < r * r).astype(np.float32)
    else:
        raise ValueError(kind)
    t = np.clip(t, 0.0, 1.0)[..., None]
    return (c1 * (1 - t) + c2 * t).astype(np.float32)


def dnoise(p: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vector-valued noise (DNoise, util/noise.cpp): three decorrelated
    Perlin channels via seed offsets — used for cloud wisp perturbation."""
    return np.stack([perlin(p, seed=seed + 11),
                     perlin(p, seed=seed + 23),
                     perlin(p, seed=seed + 37)], axis=-1)


def cloud_density(p: np.ndarray, density: float = 1.0,
                  wispiness: float = 1.0, frequency: float = 5.0) -> np.ndarray:
    """CloudMedium::Density (media.h:493): noise-perturbed multi-octave
    Perlin with an altitude falloff, in the medium's [0,1]^3 space.
    p: (..., 3) points; returns (...,) densities in [0,1]."""
    p = np.asarray(p, np.float32)
    pp = frequency * p
    if wispiness > 0:
        vomega, vlambda = 0.05 * wispiness, 10.0
        for _ in range(2):
            pp = pp + vomega * dnoise(vlambda * pp)
            vomega *= 0.5
            vlambda *= 1.99
    d = np.zeros(p.shape[:-1], np.float32)
    omega, lam = 0.5, 1.0
    for _ in range(5):
        d += omega * perlin(lam * pp)
        omega *= 0.5
        lam *= 1.99
    d = np.clip((1.0 - p[..., 1]) * 4.5 * density * d, 0.0, 1.0)
    d = d + 2.0 * np.maximum(0.0, 0.5 - p[..., 1])
    return np.clip(d, 0.0, 1.0)


def cloud_density_grid(density: float = 1.0, wispiness: float = 1.0,
                       frequency: float = 5.0, res: int = 64) -> np.ndarray:
    """Bake CloudMedium's procedural density onto a (res,res,res) grid
    (z,y,x order, matching the grid-medium density layout). The reference
    evaluates the noise per sample point on the fly; this pipeline
    converts procedural media to grids at scene compile (geometry/scene.py
    media note) and traverses them with the same DDA majorants."""
    t = (np.arange(res, dtype=np.float32) + 0.5) / res
    z, y, x = np.meshgrid(t, t, t, indexing="ij")
    pts = np.stack([x, y, z], axis=-1)
    return cloud_density(pts, density, wispiness, frequency)
