"""CLI renderer: the `pbrt` executable analog (cmd/pbrt.cpp:105).

Usage:
    python -m nn_bvh.cli.render scene.pbrt [--spp N] [--outfile f.exr]
        [--integrator path|simplepath] [--maxdepth N] [--sampler s] [--seed N]
        [--res WxH] [--quick] [--stats] [--mse-reference-image ref.pfm]

Flags mirror the reference CLI (`options.h:37` PBRTOptions): --spp, --seed,
--quick, --outfile, --stats, --mse-reference-image.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="pbrt-class spectral renderer")
    ap.add_argument("scene")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--outfile", default=None)
    ap.add_argument("--integrator", default=None)
    ap.add_argument("--maxdepth", type=int, default=None)
    ap.add_argument("--sampler", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--res", default=None, help="WxH override")
    ap.add_argument("--quick", action="store_true", help="1/4 res, spp/4 (pbrt --quick)")
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--pixelstats", default=None, metavar="PREFIX",
                    help="write per-pixel stats images PREFIX-<name>.png "
                         "(--pixelstats analog, stats.cpp:443)")
    ap.add_argument("--mse-reference-image", default=None)
    ap.add_argument("--sharded", action="store_true",
                    help="shard rays over all visible devices")
    ap.add_argument("--display-server", default=None,
                    help="tev host[:port] to stream progress to")
    ap.add_argument("--write-partial-images", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np

    from ..utils.cache import enable_jax_cache

    enable_jax_cache()
    import jax

    from ..geometry import pbrt_parser
    from ..wavefront import integrator, camera as camera_mod
    from ..utils import image as image_mod
    from ..dist import sharding

    t0 = time.time()
    sc, dbvh, cam, res = pbrt_parser.load_scene(args.scene)
    for w in res.warnings:
        print(f"warning: {w}", file=sys.stderr)

    spp = args.spp or res.spp
    width, height = res.width, res.height
    if args.res:
        width, height = (int(v) for v in args.res.lower().split("x"))
    if args.quick:
        width, height, spp = width // 4, height // 4, max(spp // 4, 1)
    if (width, height) != (cam.width, cam.height):
        cam = cam._replace(width=width, height=height)

    integ = args.integrator or res.integrator
    mis = integ not in ("simplepath", "randomwalk", "ao")
    kind = {"randomwalk": "randomwalk", "ambientocclusion": "ao", "ao": "ao",
            "volpath": "volpath", "simplevolpath": "volpath"}.get(integ, "path")
    cfg = integrator.IntegratorConfig(
        max_depth=args.maxdepth or res.max_depth, mis=mis, kind=kind,
        rr_depth=2 if mis else 99,
        sample_lights=kind not in ("randomwalk", "ao"),
    )
    sampler = args.sampler or {"halton": "halton", "sobol": "sobol", "zsobol": "sobol",
                               "paddedsobol": "sobol", "independent": "independent",
                               "stratified": "stratified"}.get(res.sampler, "sobol")
    print(f"scene: {sc.n_tris} tris, {sc.n_lights} lights; {width}x{height}@{spp}spp "
          f"{integ}/{sampler} on {jax.devices()[0].platform}", file=sys.stderr)

    t1 = time.time()
    wave_cb = None
    tev = None
    if args.display_server or args.write_partial_images:
        from ..utils import image as image_mod_cb
        from ..wavefront import film as film_dev

        if args.display_server:
            from ..utils.display import TevDisplay

            hp = args.display_server.split(":")
            tev = TevDisplay(hp[0], int(hp[1]) if len(hp) > 1 else 14158)
            tev.create_image("render", width, height)

        def wave_cb(s, f):
            img_p = np.asarray(film_dev.develop(f))
            if tev is not None:
                tev.update_image("render", img_p)
            if args.write_partial_images and (s & (s + 1)) == 0:  # waves 1,3,7,...
                out_p = (args.outfile or res.filename) + f".partial.pfm"
                image_mod_cb.write_pfm(out_p, img_p)

    if args.sharded and len(jax.devices()) > 1:
        mesh = sharding.make_mesh()
        img = sharding.render_sharded(sc, dbvh, cam, mesh, spp=spp, sampler=sampler,
                                      seed=args.seed, cfg=cfg)
    elif integ == "bdpt":
        from ..wavefront import bdpt as bdpt_mod

        img = bdpt_mod.render_bdpt(sc, dbvh, cam, spp=spp, seed=args.seed,
                                   cfg=cfg)
    elif integ == "mlt":
        from ..wavefront import mlt as mlt_mod

        img = mlt_mod.render_mlt(sc, dbvh, cam, spp=spp, seed=args.seed,
                                 cfg=cfg)
    elif integ == "lightpath":
        from ..wavefront import lightpath as lightpath_mod

        img = lightpath_mod.render_lightpath(sc, dbvh, cam, spp=spp,
                                             seed=args.seed, cfg=cfg)
    else:
        img = integrator.render(sc, dbvh, cam, spp=spp, sampler=sampler,
                                seed=args.seed, cfg=cfg, wave_callback=wave_cb,
                                sensor=res.make_sensor())
    img.block_until_ready()
    t2 = time.time()

    out = args.outfile or res.filename
    arr = np.asarray(img)
    if out.endswith(".png"):
        image_mod.write_png(out, arr)
    elif out.endswith(".pfm"):
        image_mod.write_pfm(out, arr)
    else:
        image_mod.write_exr(out, arr)
    print(f"wrote {out}", file=sys.stderr)

    if args.stats:
        rays = width * height * spp * (2 * cfg.max_depth + 1)
        stats = {
            "scene_build_s": round(t1 - t0, 3),
            "render_s": round(t2 - t1, 3),
            "rays_per_s": round(rays / max(t2 - t1, 1e-9), 1),
            "tris": sc.n_tris,
            "lights": sc.n_lights,
            "spp": spp,
        }
        # STAT_INT_DISTRIBUTION analog (util/stats.h:88): one extra 1-spp
        # wave with per-pixel counters, summarized like PrintStats
        if cfg.kind in ("path", "volpath"):
            try:
                from ..core import samplers as samplers_mod
                import jax.numpy as jnp

                scfg1 = samplers_mod.make_sampler(sampler, seed=args.seed,
                                                  spp=1, width=cam.width)
                cfg_s = cfg._replace(collect_stats=True)
                R = cam.width * cam.height
                pix = jnp.arange(R, dtype=jnp.int32)
                if cfg.kind == "volpath":
                    from ..wavefront import volpath as vp_mod

                    outw = vp_mod.trace_wave_vol(sc, dbvh, cam, scfg1, cfg_s,
                                                 pix, jnp.int32(0))
                else:
                    outw = integrator.trace_wave(sc, dbvh, cam, scfg1, cfg_s,
                                                 pix, jnp.int32(0))
                stt = np.asarray(outw[4])
                names = ("path length", "shadow rays", "surface hits",
                         "RR terminations")
                print("per-pixel distributions (1 spp):", file=sys.stderr)
                for i, nm in enumerate(names):
                    v = stt[:, i]
                    print(f"  {nm:18s} avg {v.mean():7.2f}  min {v.min():4.0f}"
                          f"  max {v.max():5.0f}  total {v.sum():10.0f}",
                          file=sys.stderr)
                stats["dist_avg_path_length"] = round(float(stt[:, 0].mean()), 3)
                stats["rays_live_per_s"] = round(
                    float(stt[:, 0].sum() + stt[:, 1].sum()) * spp
                    / max(t2 - t1, 1e-9), 1)
            except Exception as e:
                print(f"stats distributions unavailable: {e}", file=sys.stderr)
        print(json.dumps(stats))

    if args.pixelstats:
        from ..wavefront import integrator as integ_mod

        imgs, totals = integ_mod.render_pixel_stats(
            sc, dbvh, cam, spp=min(spp, 4), sampler=sampler or "sobol",
            seed=args.seed, cfg=cfg)
        for name, im in imgs.items():
            mx = max(float(im.max()), 1e-9)
            image_mod.write_png(f"{args.pixelstats}-{name}.png",
                                np.repeat((im / mx)[..., None], 3, -1))
        print(json.dumps(totals))

    if args.mse_reference_image:
        ref = (image_mod.read_pfm(args.mse_reference_image)
               if args.mse_reference_image.endswith(".pfm")
               else image_mod.read_exr(args.mse_reference_image))
        print(json.dumps({"mse": image_mod.mse(arr, ref),
                          "mrse": image_mod.mrse(arr, ref)}))


if __name__ == "__main__":
    main()
