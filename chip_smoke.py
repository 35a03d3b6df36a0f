#!/usr/bin/env python
"""Smoke run of the renderer and the treeNet trainer on one NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded phases only

One process, one import of JAX; the CLIs run in-process. Every line names the
card (name and power limit from nvidia-smi). A phase that fails raises and
the script exits non-zero; nothing is caught. Without a GPU it exits non-zero
before any phase.

Phases (one card):
 1. device: JAX must report a GPU.
 2. kernel vs reference: the CUDA BVH4 kernel against the XLA walk on the
    bench scene (bench.build_bench_scene, ~65k triangles): 160k live camera
    rays and 160k live incoherent rays (plus 20% dead lanes each),
    closest-hit and any-hit, then a seeded moving scene at a blended
    shutter time. Prints mismatch counts, max |dt| and traversal times.
 3. render: bench scene 400x400, path with MIS, depth 4, Sobol 16 spp,
    through make_wave_fn with traversal "cuda" and "xla" in turns
    (cuda, xla, xla, cuda); seconds per wave, memory, CUDA/XLA image
    agreement and same-seed determinism.
 4. analytic furnace (tests/test_render.py): mean within 0.025 of 1.
 5. volpath compaction (tests/test_phased_wave.py scene at 64x64): the
    phased driver against the plain volpath render.
 6. training: cli.train at its defaults for 5 steps, then one joint
    renderer + treeNet step (__graft_entry__.dryrun_multichip(1)).

--four: render_sharded of the bench scene on a 4-card mesh against a 1-card
mesh, and dryrun_multichip(4). The mesh is flat: the cards are all-to-all.

The last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CARD = "?"


def log(*parts):
    print(f"[{CARD}]", *parts, flush=True)


def card_name() -> str:
    """Name and power limit of the first card, from nvidia-smi (a child that
    stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def timed(fn, *args, reps=5):
    """Mean seconds of fn(*args) over reps calls, closed by
    block_until_ready; the first call (compile) is not counted."""
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps, out


# ---------------------------------------------------------------------------
# phase 2: kernel vs reference
# ---------------------------------------------------------------------------

def _incoherent_rays(bounds, n_live, seed):
    rs = np.random.RandomState(seed)
    lo, hi = (np.asarray(b, np.float32) for b in bounds)
    n = n_live * 5 // 4
    o = lo + rs.rand(n, 3).astype(np.float32) * (hi - lo)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    t_max[::5] = -1.0
    return o, d, t_max


def _camera_rays(cam, n_live):
    import jax.numpy as jnp
    from nn_bvh.wavefront import camera as camera_mod

    R = cam.width * cam.height
    pix = jnp.arange(R, dtype=jnp.int32)
    half = jnp.full((R, 2), 0.5, jnp.float32)
    o, d = (np.asarray(a) for a in camera_mod.generate_rays(cam, pix, half, half))
    assert R == n_live
    # interleave dead lanes: one in five of the batch
    n = n_live * 5 // 4
    live = np.ones(n, bool)
    live[::5] = False
    O = np.zeros((n, 3), np.float32)
    D = np.tile(np.float32([0, 0, 1]), (n, 1))
    O[live], D[live] = o, d
    return O, D, np.where(live, 1e30, -1.0).astype(np.float32)


def compare_traversal(name, cu, xl, rays):
    """CUDA vs XLA walk on one ray set; asserts the acceptance bounds."""
    import jax
    import jax.numpy as jnp

    o, d, t_max = (jnp.asarray(a) for a in rays)
    live = np.asarray(t_max) > 0
    f_cc = jax.jit(lambda tb, *a: cu.bind(tb).closest(*a))
    f_xc = jax.jit(lambda tb, *a: xl.bind(tb).closest(*a))
    f_ca = jax.jit(lambda tb, *a: cu.bind(tb).any_hit(*a))
    f_xa = jax.jit(lambda tb, *a: xl.bind(tb).any_hit(*a))
    s_cc, hc = timed(f_cc, cu.tables, o, d, t_max)
    s_xc, hx = timed(f_xc, xl.tables, o, d, t_max, reps=2)
    s_ca, ac = timed(f_ca, cu.tables, o, d, t_max)
    s_xa, ax = timed(f_xa, xl.tables, o, d, t_max, reps=2)
    pc, px = np.asarray(hc.prim), np.asarray(hx.prim)
    tc, tx = np.asarray(hc.t), np.asarray(hx.t)
    ac, ax = np.asarray(ac), np.asarray(ax)
    n_live = int(live.sum())
    dis = live & (pc != px)
    both = live & (pc >= 0) & (px >= 0)
    dt = np.abs(tc[both] - tx[both])
    rel = dt / np.maximum(np.abs(tx[both]), 1e-30)
    tie = np.abs(tc[dis] - tx[dis]) <= 1e-5 * np.abs(tx[dis])
    any_mis = int((ac[live] != ax[live]).sum())
    dead_hits = int((pc[~live] >= 0).sum() + ac[~live].sum()
                    + np.isfinite(tc[~live]).sum())
    log(f"kernel {name}: live={n_live} hits={int((pc[live] >= 0).sum())} "
        f"closest_prim_mismatch={int(dis.sum())} (ties {int(tie.sum())}) "
        f"any_mismatch={any_mis} dead_lane_hits={dead_hits} "
        f"max|dt|={float(dt.max()) if dt.size else 0.0:.3e} "
        f"max_rel_dt={float(rel.max()) if rel.size else 0.0:.3e} "
        f"(at t={float(tx[both][rel.argmax()]) if rel.size else 0.0:.4g})")
    log(f"kernel {name}: closest cuda {s_cc * 1e3:.3f} ms xla {s_xc * 1e3:.3f} ms"
        f" | any cuda {s_ca * 1e3:.3f} ms xla {s_xa * 1e3:.3f} ms"
        f" | cuda closest {n_live / s_cc / 1e6:.1f} Mrays/s")
    assert any_mis == 0, f"{name}: any-hit differs on {any_mis} live lanes"
    assert dead_hits == 0, f"{name}: dead lanes report hits"
    assert dis.sum() <= 1e-4 * n_live, f"{name}: {int(dis.sum())} prim mismatches"
    assert tie.all(), f"{name}: a prim mismatch is not a tie in t"
    # rtol 1e-5 plus 1e-5 scene units: near hits (t ~ 1e-2) lose relative
    # precision to cancellation in the watertight test's t_scaled / det
    t_bad = dt > 1e-5 + 1e-5 * np.abs(tx[both])
    assert not t_bad.any(), f"{name}: t differs at t={tx[both][t_bad][:4]}"


def moving_scene(seed=7):
    """Seeded sphere field in which every third sphere moves over the
    shutter."""
    from nn_bvh import accel
    from nn_bvh.geometry import scene as scene_mod, transform as xf

    rs = np.random.RandomState(seed)
    b = scene_mod.SceneBuilder()
    m = b.add_material("diffuse", reflectance=(0.6, 0.5, 0.4))
    for i in range(24):
        c = (rs.rand(3) - 0.5) * np.array([6.0, 2.0, 6.0]) + np.array([0, 1.2, 0])
        r = 0.25 + 0.45 * rs.rand()
        kw = {}
        if i % 3 == 0:
            kw["transform_end"] = xf.translate((rs.rand(3) - 0.5) * 1.5)
        b.add_sphere(c, r, m, n_theta=24, n_phi=48, **kw)
    b.add_quad((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8), m)
    sc, dbvh, _ = accel.build_scene_bvh(b.build())
    return sc, dbvh


def phase_kernel(bench):
    from nn_bvh.accel import cuda_bvh4, dispatch

    t0 = time.perf_counter()
    so = cuda_bvh4.build_library()
    log(f"kernel build/load: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(so, REPO)}")
    sc, dbvh, _, cam = bench.build_bench_scene()
    t0 = time.perf_counter()
    cu = dispatch.make_intersectors(sc, dbvh, traversal="cuda")
    node_tab = cu.tables[0][0]
    log(f"kernel tables: {sc.n_tris} tris, {node_tab.shape[0]} wide nodes, "
        f"{node_tab.nbytes + cu.tables[0][1].nbytes} bytes, packed in "
        f"{time.perf_counter() - t0:.2f} s")
    xl = dispatch.make_intersectors(sc, dbvh, traversal="xla")
    compare_traversal("camera", cu, xl, _camera_rays(cam, 160000))
    compare_traversal("incoherent", cu, xl,
                      _incoherent_rays(sc.bounds, 160000, seed=1))

    msc, mdbvh = moving_scene()
    assert msc.tri_p_end is not None
    mcu = dispatch.make_intersectors(msc, mdbvh, traversal="cuda")
    mxl = dispatch.make_intersectors(msc, mdbvh, traversal="xla")
    assert mcu.tables_end is not None and mxl.tables_end is not None
    t = 0.37
    for isect in (mcu, mxl):
        isect.tables = dispatch.Intersectors.lerp_tables(
            isect.tables, isect.tables_end, t)
    compare_traversal(f"moving@t={t}", mcu, mxl,
                      _incoherent_rays(msc.bounds, 160000, seed=2))
    return sc, dbvh, cam


# ---------------------------------------------------------------------------
# phase 3: render
# ---------------------------------------------------------------------------

def phase_render(sc, dbvh, cam):
    import jax
    import jax.numpy as jnp
    from nn_bvh.core import samplers
    from nn_bvh.wavefront import integrator, film as film_mod

    n_waves = 4
    R = cam.width * cam.height
    depth = 4
    sampler_cfg = samplers.make_sampler("sobol", seed=0, spp=16)
    waves = {}
    for trav in ("cuda", "xla"):
        cfg = integrator.IntegratorConfig(max_depth=depth, mis=True,
                                          rr_depth=2, traversal=trav)
        t0 = time.perf_counter()
        wave = integrator.make_wave_fn(sc, dbvh, cam, sampler_cfg, cfg)
        film = film_mod.make_film(cam.height, cam.width)
        compiled = wave.lower(film, jnp.int32(0)).compile()
        mem = compiled.memory_analysis()
        jax.block_until_ready(wave(film, jnp.int32(0)))
        log(f"render {trav}: set-up+compile+first wave "
            f"{time.perf_counter() - t0:.2f} s; memory_analysis "
            f"args={mem.argument_size_in_bytes} out={mem.output_size_in_bytes} "
            f"temp={mem.temp_size_in_bytes} code={mem.generated_code_size_in_bytes}"
            f" bytes")
        waves[trav] = wave

    def run(trav):
        film = film_mod.make_film(cam.height, cam.width)
        film = jax.block_until_ready(waves[trav](film, jnp.int32(0)))
        t0 = time.perf_counter()
        for s in range(1, 1 + n_waves):
            film = waves[trav](film, jnp.int32(s))
        jax.block_until_ready(film)
        dt = (time.perf_counter() - t0) / n_waves
        return dt, np.asarray(film_mod.develop(film))

    secs = {"cuda": [], "xla": []}
    imgs = {}
    for trav in ("cuda", "xla", "xla", "cuda"):
        dt, img = run(trav)
        secs[trav].append(dt)
        imgs.setdefault(trav, []).append(img)
    rays_per_wave = R * (2 * depth + 1)
    for trav in ("cuda", "xla"):
        s = secs[trav]
        log(f"render {trav}: s/wave {s[0]:.6f} {s[1]:.6f} "
            f"(dense rays/s {rays_per_wave / np.mean(s):.4e}) "
            f"[{cam.width}x{cam.height} path MIS depth {depth} sobol]")
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    log(f"render: peak_bytes_in_use={peak}")
    for trav, (i1, i2) in imgs.items():
        assert np.isfinite(i1).all() and i1.mean() > 0, f"{trav}: bad image"
    same_seed = bool((imgs["cuda"][0] == imgs["cuda"][1]).all())
    # control: the same CUDA render with lane re-sorting off. Lanes compute
    # the same paths, but the program compiles differently, and last-bit
    # differences flip a few discrete path decisions (Russian roulette,
    # light choice) — the floor for any two compilations of the renderer.
    cfg = integrator.IntegratorConfig(max_depth=depth, mis=True, rr_depth=2,
                                      traversal="cuda", resort=False)
    waves["control"] = integrator.make_wave_fn(sc, dbvh, cam, sampler_cfg, cfg)
    _, ctrl = run("control")

    def out_of_tol(x, ref):
        return int((np.abs(x - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(-1).sum())

    a, b = imgs["cuda"][0], imgs["xla"][0]
    bad, bad_ctrl = out_of_tol(a, b), out_of_tol(ctrl, a)
    rel_mean = abs(a.mean() - b.mean()) / b.mean()
    log(f"render: cuda mean {a.mean():.6f} xla mean {b.mean():.6f} "
        f"(rel {rel_mean:.2e}) max|diff| {np.abs(a - b).max():.3e}; pixels "
        f"out of atol 1e-4/rtol 1e-3: cuda-vs-xla {bad}, control "
        f"(cuda resort off vs on) {bad_ctrl} of {R}; "
        f"same_seed_bit_identical={same_seed}")
    assert same_seed, "same-seed CUDA renders differ"
    assert rel_mean < 1e-4, "CUDA and XLA image means differ"
    assert bad <= 2e-3 * R, "CUDA and XLA renders differ on too many pixels"
    speedup = np.mean(secs["xla"]) / np.mean(secs["cuda"])
    log(f"render: xla/cuda wave-time ratio {speedup:.3f}")


# ---------------------------------------------------------------------------
# phases 4-6
# ---------------------------------------------------------------------------

def phase_furnace():
    import jax.numpy as jnp
    from nn_bvh.wavefront import integrator
    from test_render import furnace_scene

    sc, dbvh, cam = furnace_scene(albedo=0.5, le=0.5)
    cfg = integrator.IntegratorConfig(max_depth=10, mis=True, rr_depth=12)
    img = integrator.render(sc, dbvh, cam, spp=12, sampler="sobol", cfg=cfg)
    mean = float(jnp.mean(img))
    log(f"furnace: mean {mean:.6f} (analytic 0.9995, tol 0.025)")
    assert abs(mean - 1.0) < 0.025, f"furnace mean {mean}"


def phase_volpath():
    import jax.numpy as jnp
    from nn_bvh.core import samplers
    from nn_bvh.geometry import transform as xf
    from nn_bvh.wavefront import camera as camera_mod, film as film_mod, \
        integrator, volpath
    from test_phased_wave import _scene_with_medium

    sc, dbvh = _scene_with_medium()
    cam = camera_mod.make_perspective(
        xf.look_at((0, 2, -4), (0, 1, 0), (0, 1, 0)), fov=50.0,
        width=64, height=64)
    cfg = integrator.IntegratorConfig(max_depth=6, kind="volpath", rr_depth=2)
    spp = 2
    plain = np.asarray(integrator.render(sc, dbvh, cam, spp=spp,
                                         cfg=cfg._replace(compact=False)))
    wave = volpath.make_phased_wave(sc, dbvh, cam,
                                    samplers.make_sampler("sobol", seed=0,
                                                          spp=spp),
                                    cfg, phase_len=2)
    film = film_mod.make_film(cam.height, cam.width)
    for s in range(spp):
        film = wave(film, jnp.int32(s))
    phased = np.asarray(film_mod.develop(film))
    err = float(np.abs(phased - plain).max())
    log(f"volpath: phased vs plain max|diff| {err:.3e} (tol 1e-4), "
        f"mean {plain.mean():.6f}")
    assert np.isfinite(plain).all() and err <= 1e-4


def phase_train():
    from nn_bvh.cli import train
    import __graft_entry__ as entry

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train.main(["--steps", "5", "--log-every", "1"])
    hist = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    losses = [h["loss"] for h in hist]
    log(f"train: cli.train defaults (levels 4, capacity 128, pc 2048, "
        f"batch 8) 5 steps in {time.perf_counter() - t0:.2f} s, "
        f"losses {losses}")
    assert len(losses) == 5 and np.isfinite(losses).all()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        entry.dryrun_multichip(1)
    log("joint: " + buf.getvalue().strip())


def phase_four():
    import jax
    from nn_bvh.dist import sharding
    from nn_bvh.wavefront import integrator
    import bench
    import __graft_entry__ as entry

    devs = jax.devices()
    assert len(devs) >= 4, f"--four needs 4 GPUs, JAX sees {len(devs)}"
    log("four: devices " + ", ".join(f"{d.id}:{d.device_kind}" for d in devs[:4]))
    sc, dbvh, _, cam = bench.build_bench_scene()
    cfg = integrator.IntegratorConfig(max_depth=4, mis=True, rr_depth=2)
    imgs = {}
    for n in (4, 1):
        t0 = time.perf_counter()
        imgs[n] = np.asarray(sharding.render_sharded(
            sc, dbvh, cam, sharding.make_mesh(n), spp=4, cfg=cfg))
        log(f"four: render_sharded on {n} card(s): "
            f"{time.perf_counter() - t0:.2f} s incl. compile, "
            f"mean {imgs[n].mean():.6f}")
    err = np.abs(imgs[4] - imgs[1])
    bad = err > 1e-4 + 1e-3 * np.abs(imgs[1])
    log(f"four: 4-card vs 1-card max|diff| {err.max():.3e} "
        f"pixels_out_of_tol {int(bad.any(-1).sum())}")
    assert np.isfinite(imgs[4]).all() and not bad.any()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        entry.dryrun_multichip(4)
    log("four: " + buf.getvalue().strip())


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the 4-card sharded phases instead")
    args = ap.parse_args()

    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import jax
    from nn_bvh.utils.cache import cache_dir, enable_jax_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found {dev.platform!r}")
    CARD = card_name()
    enable_jax_cache()
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={cache_dir()}")
    t_start = time.perf_counter()
    if args.four:
        phase_four()
        count = 4
    else:
        import bench

        sc, dbvh, cam = phase_kernel(bench)
        phase_render(sc, dbvh, cam)
        phase_furnace()
        phase_volpath()
        phase_train()
        count = len(jax.devices())
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))


if __name__ == "__main__":
    main()
