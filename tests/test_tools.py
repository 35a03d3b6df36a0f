"""CLI tools + aux subsystem tests (imgtool, stats, tree export, display)."""

import json
import subprocess
import sys

import numpy as np
import jax.numpy as jnp

from nn_bvh.utils import image as im, stats
from nn_bvh.learn import export as tree_export, data as learn_data, tree_eval
from nn_bvh.cli import imgtool


class TestImgtool:
    def _mk(self, tmp_path, name="a.pfm", seed=0, scale=1.0):
        img = np.random.RandomState(seed).rand(8, 8, 3).astype(np.float32) * scale
        p = str(tmp_path / name)
        im.write_pfm(p, img)
        return p, img

    def test_convert_exposure(self, tmp_path):
        p, img = self._mk(tmp_path)
        out = str(tmp_path / "out.pfm")
        imgtool.main(["convert", p, out, "--exposure", "1.0"])
        np.testing.assert_allclose(im.read_pfm(out), img * 2, rtol=1e-6)

    def test_diff_and_info(self, tmp_path, capsys):
        p1, img1 = self._mk(tmp_path, "a.pfm", 1)
        p2, img2 = self._mk(tmp_path, "b.pfm", 2)
        imgtool.main(["diff", p1, p2])
        out = json.loads(capsys.readouterr().out)
        np.testing.assert_allclose(out["mse"], im.mse(img1, img2), rtol=1e-6)
        imgtool.main(["info", p1])
        info = json.loads(capsys.readouterr().out)
        assert info["resolution"] == [8, 8]
        assert info["nan"] == 0

    def test_falsecolor_and_average(self, tmp_path):
        p1, _ = self._mk(tmp_path, "a.pfm", 3)
        p2, _ = self._mk(tmp_path, "b.pfm", 4)
        fc = str(tmp_path / "fc.pfm")
        imgtool.main(["falsecolor", p1, fc])
        assert im.read_pfm(fc).shape == (8, 8, 3)
        avg = str(tmp_path / "avg.pfm")
        imgtool.main(["average", p1, p2, "--output", avg])
        np.testing.assert_allclose(
            im.read_pfm(avg), (im.read_pfm(p1) + im.read_pfm(p2)) / 2, rtol=1e-6
        )


class TestStats:
    def test_counters(self):
        c = stats.make_counters(stats.RENDER_COUNTERS)
        c = stats.bump(c, "rays/camera rays", 100)
        c = stats.bump(c, "rays/camera rays", jnp.float32(28))
        rep = stats.render_report(c)
        assert "camera rays" in rep and "128" in rep

    def test_merge(self):
        a = stats.bump(stats.make_counters(("x/y",)), "x/y", 1)
        b = stats.bump(stats.make_counters(("x/y",)), "x/y", 2)
        assert float(stats.merge(a, b)["x/y"]) == 3


class TestTreeExport:
    def test_roundtrip(self, tmp_path):
        planes = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.2], [0, 0, 1, 0.8]], np.float32)
        p = str(tmp_path / "tree.bin")
        tree_export.export_tree(p, planes)
        np.testing.assert_array_equal(tree_export.import_tree(p), planes)

    def test_export_variables(self, tmp_path):
        import jax
        from nn_bvh.learn import treenet

        cfg = treenet.TreeNetConfig(levels=2, capacity=8, pc_size=16)
        params = treenet.init_params(cfg, jax.random.PRNGKey(0))
        d = str(tmp_path / "vars")
        tree_export.export_variables(d, params)
        import os

        files = os.listdir(d)
        assert len(files) >= 6  # at least the encoder matrices

    def test_planes_to_bvh(self):
        scene = learn_data.random_scene(n_meshes=2, prims_per_mesh=50, seed=1)
        prims = scene.base_cloud()
        planes = tree_eval.greedy_tree(prims, 3)
        bvh = tree_export.planes_to_bvh(prims, planes)
        assert sorted(bvh.prim_order.tolist()) == list(range(len(prims)))
        # traversal-ready: leaves cover all prims
        meta = bvh.node_meta
        assert meta[meta[:, 1] > 0][:, 1].sum() == len(prims)


def test_imgtool_extended_subcommands(tmp_path):
    """makeequiarea / makesky / assemble / splitn / bloom / despike /
    whitebalance round-trips (cmd/imgtool.cpp analogs)."""
    import numpy as np
    from nn_bvh.cli import imgtool
    from nn_bvh.utils import image as im

    d = str(tmp_path)
    # equirect source with a bright band at the horizon
    src = np.zeros((64, 128, 3), np.float32)
    src[28:36] = (1.0, 0.8, 0.6)
    im.write_pfm(f"{d}/equi.pfm", src)
    imgtool.main(["makeequiarea", f"{d}/equi.pfm", f"{d}/octa.pfm",
                  "--resolution", "64"])
    octa = im.read_pfm(f"{d}/octa.pfm")
    assert octa.shape == (64, 64, 3) and octa.max() > 0.5

    imgtool.main(["makesky", f"{d}/sky.pfm", "--resolution", "64",
                  "--elevation", "25"])
    sky = im.read_pfm(f"{d}/sky.pfm")
    assert np.isfinite(sky).all() and sky.max() > 1.0  # sun disk present

    # splitn + assemble round-trip
    img = np.random.RandomState(0).rand(32, 16, 3).astype(np.float32)
    im.write_pfm(f"{d}/a.pfm", img)
    imgtool.main(["splitn", f"{d}/a.pfm", f"{d}/part%d.pfm", "--n", "2"])
    imgtool.main(["assemble", f"{d}/part0.pfm:0,0", f"{d}/part1.pfm:0,16",
                  "--output", f"{d}/re.pfm"])
    re = im.read_pfm(f"{d}/re.pfm")
    assert np.allclose(re, img, atol=1e-6)

    # despike removes an isolated firefly
    spiky = img.copy()
    spiky[5, 5] = 1000.0
    im.write_pfm(f"{d}/spiky.pfm", spiky)
    imgtool.main(["despike", f"{d}/spiky.pfm", f"{d}/clean.pfm",
                  "--level", "50"])
    clean = im.read_pfm(f"{d}/clean.pfm")
    assert clean.max() < 10.0

    # bloom adds energy near bright pixels
    imgtool.main(["bloom", f"{d}/spiky.pfm", f"{d}/bloom.pfm",
                  "--level", "100"])
    bl = im.read_pfm(f"{d}/bloom.pfm")
    assert bl.sum() > spiky.sum()

    # whitebalance shifts channel balance
    imgtool.main(["whitebalance", f"{d}/a.pfm", f"{d}/wb.pfm",
                  "--temperature", "3000"])
    wb = im.read_pfm(f"{d}/wb.pfm")
    assert not np.allclose(wb, img)


def test_imgtool_round2_subcommands(tmp_path, capsys):
    """cat / makeemitters / denoise / convert --downsample/--gamma/
    --colorspace (cmd/imgtool.cpp analogs added in round 2)."""
    import numpy as np
    from nn_bvh.cli import imgtool
    from nn_bvh.utils import image as im

    d = str(tmp_path)
    rs = np.random.RandomState(1)
    img = rs.rand(8, 8, 3).astype(np.float32)
    im.write_pfm(f"{d}/a.pfm", img)

    imgtool.main(["cat", f"{d}/a.pfm", "--csv"])
    out = capsys.readouterr().out
    assert len(out.strip().splitlines()) == 64

    imgtool.main(["makeemitters", f"{d}/a.pfm", "--output", f"{d}/em.pbrt"])
    txt = open(f"{d}/em.pbrt").read()
    assert txt.count("AreaLightSource") == 64
    assert "bilinearmesh" in txt

    # denoise: noisy flat field converges toward its mean with AOV guides
    clean = np.full((16, 16, 3), 0.5, np.float32)
    noisy = clean + rs.randn(16, 16, 3).astype(np.float32) * 0.1
    nrm = np.tile(np.array([0, 0, 1], np.float32), (16, 16, 1))
    im.write_pfm(f"{d}/noisy.pfm", noisy)
    im.write_pfm(f"{d}/nrm.pfm", nrm)
    im.write_pfm(f"{d}/alb.pfm", clean)
    imgtool.main(["denoise", f"{d}/noisy.pfm", f"{d}/dn.pfm",
                  "--normal", f"{d}/nrm.pfm", "--albedo", f"{d}/alb.pfm",
                  "--radius", "3"])
    dn = im.read_pfm(f"{d}/dn.pfm")
    assert np.abs(dn - clean).mean() < np.abs(noisy - clean).mean() * 0.6

    # convert: downsample halves resolution; gamma brightens; colorspace
    # transform keeps luminance roughly constant
    imgtool.main(["convert", f"{d}/a.pfm", f"{d}/half.pfm",
                  "--downsample", "1"])
    assert im.read_pfm(f"{d}/half.pfm").shape == (4, 4, 3)
    imgtool.main(["convert", f"{d}/a.pfm", f"{d}/g.pfm", "--gamma", "2.2"])
    assert im.read_pfm(f"{d}/g.pfm").mean() > img.mean()
    imgtool.main(["convert", f"{d}/a.pfm", f"{d}/p3.pfm",
                  "--colorspace", "dci-p3"])
    p3 = im.read_pfm(f"{d}/p3.pfm")
    assert np.isfinite(p3).all()
    assert abs(p3.mean() - img.mean()) < 0.2


def test_pspec_power_spectrum():
    """pspec (cmd/pspec.cpp analog): white noise has a flat unit spectrum;
    low-discrepancy samplers suppress the low-frequency disk."""
    import numpy as np
    from nn_bvh.cli import pspec

    def run(kind):
        sets = np.stack([pspec.sample_points(kind, 128, s, 1)
                         for s in range(6)])
        P = pspec.power_spectrum(sets, 33)
        k = np.arange(33) - 16
        KX, KY = np.meshgrid(k, k, indexing="xy")
        r = np.sqrt(KX ** 2 + KY ** 2)
        lo = (r > 0) & (r < np.sqrt(128) / 2)
        return P[lo].mean(), P[(r > 0)].mean()

    lo_w, all_w = run("independent")
    lo_s, _ = run("sobol")
    assert 0.8 < all_w < 1.2, all_w          # white noise: flat ~1
    assert lo_s < 0.5 * lo_w, (lo_s, lo_w)   # sobol: low-freq suppression
