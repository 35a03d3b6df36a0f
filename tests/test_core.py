"""Core math/sampling/spectrum tests.

Mirrors the reference's unit + statistical test idiom
(`util/sampling_test.cpp`, `util/spectrum_test.cpp`, `util/color_test.cpp`):
exact asserts for algebra, Monte-Carlo integration checks for warps/pdfs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nn_bvh.core import (
    vecmath as vm,
    sampling,
    samplers,
    spectrum,
    colorspace,
    rgb2spec,
    lowdiscrepancy as ld,
    rng,
)


def _u2(n, seed=0):
    k = jax.random.PRNGKey(seed)
    return jax.random.uniform(k, (n, 2))


class TestVecmath:
    def test_normalize(self):
        v = jnp.array([[3.0, 0.0, 4.0], [0.0, 0.0, 0.0]])
        n = vm.normalize(v)
        np.testing.assert_allclose(n[0], [0.6, 0.0, 0.8], atol=1e-6)
        np.testing.assert_allclose(n[1], [0.0, 0.0, 0.0], atol=1e-6)

    def test_coordinate_system_orthonormal(self):
        key = jax.random.PRNGKey(1)
        n = vm.normalize(jax.random.normal(key, (100, 3)))
        t, b = vm.coordinate_system(n)
        np.testing.assert_allclose(vm.dot(t, n), 0, atol=1e-5)
        np.testing.assert_allclose(vm.dot(b, n), 0, atol=1e-5)
        np.testing.assert_allclose(vm.dot(t, b), 0, atol=1e-5)
        np.testing.assert_allclose(vm.length(t), 1, atol=1e-5)
        # right-handed: cross(t, b) == n
        np.testing.assert_allclose(vm.cross(t, b), n, atol=1e-5)

    def test_local_roundtrip(self):
        key = jax.random.PRNGKey(2)
        n = vm.normalize(jax.random.normal(key, (50, 3)))
        v = vm.normalize(jax.random.normal(jax.random.PRNGKey(3), (50, 3)))
        np.testing.assert_allclose(
            vm.from_local(n, vm.to_local(n, v)), v, atol=1e-5
        )

    def test_equal_area_roundtrip(self):
        key = jax.random.PRNGKey(4)
        d = vm.normalize(jax.random.normal(key, (200, 3)))
        p = vm.equal_area_sphere_to_square(d)
        d2 = vm.equal_area_square_to_sphere(p)
        np.testing.assert_allclose(d2, d, atol=2e-2)  # atan approx tolerance

    def test_ray_bounds_hit(self):
        o = jnp.array([[0.0, 0.0, -5.0]])
        d = jnp.array([[0.0, 0.0, 1.0]])
        hit, t = vm.ray_bounds_hit(
            o, 1.0 / d, jnp.array([1e9]), jnp.array([[-1.0, -1, -1]]), jnp.array([[1.0, 1, 1]])
        )
        assert bool(hit[0])
        np.testing.assert_allclose(t[0], 4.0, atol=1e-5)
        # miss
        hit2, _ = vm.ray_bounds_hit(
            o, 1.0 / d, jnp.array([1e9]), jnp.array([[2.0, 2, 2]]), jnp.array([[3.0, 3, 3]])
        )
        assert not bool(hit2[0])


class TestWarps:
    def test_cosine_hemisphere_integral(self):
        # E[f/pdf] of f=1 over hemisphere pdf should be 1 trivially; check pdf
        # consistency: integrate cos/pi * (pi/cos) = 1
        u = _u2(4096)
        w = sampling.sample_cosine_hemisphere(u)
        assert float(jnp.min(w[..., 2])) >= 0
        np.testing.assert_allclose(vm.length(w), 1.0, atol=1e-4)
        # estimate integral of cos over hemisphere = pi
        pdf = sampling.cosine_hemisphere_pdf(w[..., 2])
        est = jnp.mean(w[..., 2] / jnp.maximum(pdf, 1e-9))
        np.testing.assert_allclose(est, np.pi, rtol=1e-3)

    def test_uniform_sphere(self):
        u = _u2(8192)
        w = sampling.sample_uniform_sphere(u)
        np.testing.assert_allclose(vm.length(w), 1.0, atol=1e-4)
        np.testing.assert_allclose(float(jnp.mean(w[..., 2])), 0.0, atol=0.05)

    def test_triangle_warp(self):
        u = _u2(1000)
        b = sampling.sample_uniform_triangle(u)
        assert float(jnp.min(b)) >= -1e-6
        np.testing.assert_allclose(jnp.sum(b, -1), 1.0, atol=1e-5)

    def test_spherical_triangle_sampling_solid_angle(self):
        # large triangle; verify pdf = 1/solid angle, sampled dirs inside cone
        v0 = jnp.array([1.0, 0.0, 1.0])
        v1 = jnp.array([-1.0, 0.0, 1.0])
        v2 = jnp.array([0.0, 1.0, 1.0])
        p = jnp.zeros(3)
        n = 2000
        u = _u2(n, seed=7)
        bary, pdf, degen = sampling.sample_spherical_triangle(
            jnp.broadcast_to(v0, (n, 3)),
            jnp.broadcast_to(v1, (n, 3)),
            jnp.broadcast_to(v2, (n, 3)),
            jnp.broadcast_to(p, (n, 3)),
            u,
        )
        assert not bool(jnp.any(degen))
        omega = vm.spherical_triangle_area(
            vm.normalize(v0), vm.normalize(v1), vm.normalize(v2)
        )
        np.testing.assert_allclose(pdf, 1.0 / omega, rtol=1e-3)
        pts = (
            bary[:, 0:1] * v0 + bary[:, 1:2] * v1 + bary[:, 2:3] * v2
        )
        # all sampled points on the triangle plane z=1
        np.testing.assert_allclose(pts[:, 2], 1.0, atol=1e-3)

    def test_distribution_1d(self):
        f = jnp.array([1.0, 3.0, 0.0, 4.0])
        dist = sampling.make_distribution_1d(f)
        u = jax.random.uniform(jax.random.PRNGKey(5), (20000,))
        x, pdf, idx = sampling.sample_distribution_1d(dist, u)
        # bucket frequencies should match f/sum
        hist = np.histogram(np.asarray(x), bins=4, range=(0, 1))[0] / 20000
        np.testing.assert_allclose(hist, np.asarray(f) / 8.0, atol=0.01)
        # pdf consistency: E[1/pdf] = measure of the support (bin 2 is zero -> 3/4)
        np.testing.assert_allclose(float(jnp.mean(1.0 / pdf)), 0.75, rtol=2e-2)

    def test_distribution_2d(self):
        f = jnp.asarray(np.random.RandomState(0).rand(16, 32).astype(np.float32)) + 0.1
        dist = sampling.make_distribution_2d(f)
        u = _u2(20000, seed=9)
        p, pdf = sampling.sample_distribution_2d(dist, u)
        # sampled pdf must agree with the lookup pdf at the sampled point
        est = jnp.mean(sampling.distribution_2d_pdf(dist, p) / pdf * 1.0)
        np.testing.assert_allclose(est, 1.0, rtol=1e-5)
        # MC integration with this pdf: E[g/pdf] = integral(g) for g(x,y)=x
        est2 = jnp.mean(p[..., 0] / pdf)
        np.testing.assert_allclose(float(est2), 0.5, atol=0.01)
        # E[1/pdf] = measure of the unit square = 1
        np.testing.assert_allclose(float(jnp.mean(1.0 / pdf)), 1.0, atol=0.01)


class TestSamplers:
    @pytest.mark.parametrize("kind", ["independent", "stratified", "sobol", "halton"])
    def test_uniform_mean(self, kind):
        cfg = samplers.make_sampler(kind, seed=1, spp=16)
        pix = jnp.zeros(16, jnp.int32)
        smp = jnp.arange(16, dtype=jnp.int32)
        xs, ys = samplers.get_2d(cfg, pix, smp, 0)
        assert float(jnp.min(xs)) >= 0 and float(jnp.max(xs)) < 1
        np.testing.assert_allclose(float(jnp.mean(xs)), 0.5, atol=0.15)
        np.testing.assert_allclose(float(jnp.mean(ys)), 0.5, atol=0.15)

    def test_sobol_stratification(self):
        # first 16 owen-scrambled sobol points: each 1/16 stratum of dim0
        # contains exactly one point (elementary interval property survives
        # owen scrambling) — the reference checks this in samplers_test.cpp
        cfg = samplers.make_sampler("sobol", seed=3, spp=16)
        pix = jnp.zeros(16, jnp.int32)
        smp = jnp.arange(16, dtype=jnp.int32)
        xs, ys = samplers.get_2d(cfg, pix, smp, 0)
        bins = np.floor(np.asarray(xs) * 16).astype(int)
        assert sorted(bins.tolist()) == list(range(16))
        bins_y = np.floor(np.asarray(ys) * 16).astype(int)
        assert sorted(bins_y.tolist()) == list(range(16))
        # 4x4 joint stratification of the (0,2)-sequence
        bx = np.floor(np.asarray(xs) * 4).astype(int)
        by = np.floor(np.asarray(ys) * 4).astype(int)
        assert len(set(zip(bx.tolist(), by.tolist()))) == 16

    def test_sampler_decorrelated_across_pixels(self):
        cfg = samplers.make_sampler("sobol", seed=3, spp=4)
        a = samplers.get_1d(cfg, jnp.array([0], jnp.int32), jnp.array([0], jnp.int32), 0)
        b = samplers.get_1d(cfg, jnp.array([1], jnp.int32), jnp.array([0], jnp.int32), 0)
        assert abs(float(a[0]) - float(b[0])) > 1e-6


class TestSpectrum:
    def test_cie_y_integral(self):
        # Wyman fit integral should be close to the CIE standard 106.857
        assert abs(spectrum.CIE_Y_INTEGRAL - 106.857) < 3.0

    def test_wavelength_sampling_stratified(self):
        lam, pdf = spectrum.sample_wavelengths_uniform(jnp.array([0.3]))
        assert lam.shape == (1, 4)
        assert float(jnp.min(lam)) >= spectrum.LAMBDA_MIN
        assert float(jnp.max(lam)) <= spectrum.LAMBDA_MAX
        # stratified: sorted gaps ~ span/4
        l = np.sort(np.asarray(lam[0]))
        gaps = np.diff(l)
        assert np.all(gaps > 30)

    def test_constant_spectrum_white(self):
        # radiance == normalized illuminant --> sensor RGB == (1,1,1)
        n = 8192
        u = jax.random.uniform(jax.random.PRNGKey(0), (n,))
        lam, pdf = spectrum.sample_wavelengths_visible(u)
        vals = spectrum.illuminant_d_normalized(lam)
        xyz = spectrum.spectrum_to_xyz(vals, lam, pdf)
        rgb = colorspace.xyz_to_linear_srgb(jnp.mean(xyz, axis=0))
        np.testing.assert_allclose(np.asarray(rgb), 1.0, atol=0.02)

    def test_visible_pdf_normalized(self):
        lam = jnp.linspace(360.0, 830.0, 2000)
        integral = float(jnp.trapezoid(sampling.visible_wavelengths_pdf(lam), lam))
        np.testing.assert_allclose(integral, 1.0, atol=1e-3)


class TestRGB2Spec:
    def test_fit_roundtrip(self):
        rgbs = np.array(
            [[0.5, 0.5, 0.5], [0.8, 0.2, 0.2], [0.1, 0.6, 0.3], [0.9, 0.9, 0.1]],
            np.float32,
        )
        coeffs, scale = rgb2spec.rgb_to_coeffs_host(rgbs)
        np.testing.assert_allclose(scale, 1.0)
        # reconstruct RGB by dense spectral integration
        lam = jnp.linspace(360.0, 830.0, 200)
        s = rgb2spec.eval_sigmoid_poly(jnp.asarray(coeffs), jnp.broadcast_to(lam, (4, 200)))
        w = spectrum.illuminant_d(lam)
        cie = jnp.stack([spectrum.cie_x(lam), spectrum.cie_y(lam), spectrum.cie_z(lam)])
        norm = jnp.sum(spectrum.cie_y(lam) * w)
        xyz = jnp.einsum("cl,nl->nc", cie * w, s) / norm
        rgb = colorspace.xyz_to_linear_srgb(xyz)
        np.testing.assert_allclose(np.asarray(rgb), rgbs, atol=0.02)


class TestLowDiscrepancy:
    def test_sobol_dim0_is_van_der_corput(self):
        idx = jnp.arange(8, dtype=jnp.uint32)
        x, y = ld.sobol_2d_bits(idx)
        xf = np.asarray(x).astype(np.float64) / 2**32
        np.testing.assert_allclose(
            xf, [0.0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875]
        )

    def test_owen_shuffle_is_permutation(self):
        idx = jnp.arange(16, dtype=jnp.uint32)
        sh = ld.owen_shuffle_index(idx, 4, jnp.uint32(123))
        assert sorted(np.asarray(sh).tolist()) == list(range(16))

    def test_radical_inverse(self):
        a = jnp.array([0, 1, 2, 3, 4], jnp.uint32)
        ri = ld.radical_inverse(1, a)  # base 3
        np.testing.assert_allclose(
            np.asarray(ri), [0, 1 / 3, 2 / 3, 1 / 9, 4 / 9], atol=1e-6
        )

    def test_rng_uniformity(self):
        vals = rng.hash_float(
            jnp.arange(10000, dtype=jnp.uint32), jnp.uint32(0), jnp.uint32(1)
        )
        np.testing.assert_allclose(float(jnp.mean(vals)), 0.5, atol=0.02)
        np.testing.assert_allclose(float(jnp.var(vals)), 1 / 12, atol=0.01)


class TestGeneratedSamplerTables:
    """Generated Sobol' matrices + pmj02 sets (VERDICT r2 item 10;
    samplers_test.cpp elementary-interval idiom)."""

    def test_sobol_matrices_net_property(self):
        import numpy as np
        import jax.numpy as jnp
        from nn_bvh.core import lowdiscrepancy as ld

        V = ld.generate_sobol_matrices(16)
        idx = jnp.arange(256, dtype=jnp.uint32)
        for d in (0, 1, 3, 9, 15):
            x = np.asarray(ld.sobol_sample_dim(jnp.asarray(V[d]), idx)) / 2**32
            for k in range(1, 9):
                m = 1 << k
                assert len({int(v * m) for v in x[:m]}) == m, (d, k)

    def test_sobol_dims_0_1_are_02_net(self):
        import numpy as np
        import jax.numpy as jnp
        from nn_bvh.core import lowdiscrepancy as ld

        V = ld.generate_sobol_matrices(2)
        idx = jnp.arange(64, dtype=jnp.uint32)
        x = np.asarray(ld.sobol_sample_dim(jnp.asarray(V[0]), idx)) / 2**32
        y = np.asarray(ld.sobol_sample_dim(jnp.asarray(V[1]), idx)) / 2**32
        for m_log in (2, 4, 6):
            m = 1 << m_log
            for a in range(m_log + 1):
                b = m_log - a
                cells = {(int(xx * (1 << a)), int(yy * (1 << b)))
                         for xx, yy in zip(x[:m], y[:m])}
                assert len(cells) == m, (m, a, b)

    def test_pmj02_is_02_net(self):
        from nn_bvh.core import lowdiscrepancy as ld

        pts = ld.generate_pmj02(64, seed=3)
        for m_log in (2, 4, 6):
            m = 1 << m_log
            for a in range(m_log + 1):
                b = m_log - a
                cells = {(int(p[0] * (1 << a)), int(p[1] * (1 << b)))
                         for p in pts[:m]}
                assert len(cells) == m, (m, a, b)

    def test_pmj02bn_sampler_kind(self):
        import numpy as np
        import jax.numpy as jnp
        from nn_bvh.core import samplers

        cfg = samplers.make_sampler("pmj02bn", seed=0, spp=16)
        assert cfg.kind == samplers.PMJ02 and cfg.pmj is not None
        pix = jnp.zeros((16,), jnp.int32)
        smp = jnp.arange(16, dtype=jnp.int32)
        u, v = samplers.get_2d(cfg, pix, smp, 5)
        u, v = np.asarray(u), np.asarray(v)
        assert ((u >= 0) & (u < 1)).all() and ((v >= 0) & (v < 1)).all()
        # stratification survives the per-pixel Owen scramble: the 16
        # samples of one pixel cover all 16 strata of the 4x4 grid
        cells = {(int(a * 4), int(b * 4)) for a, b in zip(u, v)}
        assert len(cells) == 16, cells

    def test_fullsobol_sampler_kind(self):
        import numpy as np
        import jax.numpy as jnp
        from nn_bvh.core import samplers

        cfg = samplers.make_sampler("fullsobol", seed=0, spp=16)
        pix = jnp.zeros((32,), jnp.int32)
        smp = jnp.arange(32, dtype=jnp.int32)
        u = np.asarray(samplers.get_1d(cfg, pix, smp, 11))
        assert ((u >= 0) & (u < 1)).all()
        assert len({int(x * 32) for x in u}) == 32  # 1D stratified
