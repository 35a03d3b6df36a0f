"""Film: pixel accumulation and develop.

Counterpart of the reference's RGBFilm + PixelSensor (`film.h:232,36`). The
reference accumulates with per-pixel atomics (AtomicFloat splats); here film
accumulation is a scatter-add over flat pixel indices — order-independent and
deterministic, which is what makes the multi-device psum reduction exact
(SURVEY.md §5.8).

Film state is a pytree so it shards/donates cleanly through jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import colorspace, spectrum

Array = jax.Array


class Film(NamedTuple):
    xyz: Array      # (H*W, 3) weighted XYZ sums
    weight: Array   # (H*W,) filter-weight sums
    splat_xyz: Array  # (H*W, 3) splat accumulation (AddSplat path for BDPT/light tracing)
    height: int
    width: int


from ..utils.pytree import register_static as _register_static

# float32 products for radiance (a GPU's default precision may use TF32)
_HI = jax.lax.Precision.HIGHEST

_register_static(Film, ("height", "width"))


def make_film(height: int, width: int) -> Film:
    n = height * width
    return Film(
        xyz=jnp.zeros((n, 3), jnp.float32),
        weight=jnp.zeros((n,), jnp.float32),
        splat_xyz=jnp.zeros((n, 3), jnp.float32),
        height=height,
        width=width,
    )


def spectrum_to_sensor_rgb(values: Array, lam: Array, pdf: Array,
                           curves: Array) -> Array:
    """MC estimate of MEASURED-sensor RGB from point-sampled spectra
    (PixelSensor::ToSensorRGB, film.h:36: the per-sample projection onto the
    camera's r/g/b response curves instead of the CIE matching functions).
    curves: (3, 471) densified responses on the 1-nm grid [360, 830]."""
    from ..core.spectrum import safe_div, LAMBDA_MIN, CIE_Y_INTEGRAL

    w = safe_div(jnp.ones_like(pdf), pdf)
    f = jnp.clip(lam - LAMBDA_MIN, 0.0, curves.shape[1] - 1.001)
    i0 = f.astype(jnp.int32)
    t = f - i0
    out = []
    for c in range(3):
        resp = curves[c, i0] * (1 - t) + curves[c, i0 + 1] * t
        out.append(jnp.mean(resp * values * w, axis=-1))
    return jnp.stack(out, axis=-1)


class MeasuredSensor(NamedTuple):
    """Measured camera sensor (PixelSensor with named response curves,
    film.cpp PixelSensor ctor): swatch-trained RGB->XYZ matrix + dense
    response curves + imaging ratio."""
    curves: "object"        # (3, 471) np/jnp response curves
    xyz_from_rgb: "object"  # (3,3) camera RGB (under wb illum) -> output XYZ
    imaging_ratio: float


def make_measured_sensor(name: str, white_balance_temp: float | None = 6500.0,
                         iso: float = 100.0, exposure: float = 1.0):
    """Build a MeasuredSensor from the named response curves + the 24
    BabelColor ColorChecker swatches (both physical measurement data in
    data/named_spectra.npz, like the reference's spectrum.cpp tables). The
    3x3 matrix is the least-squares map from swatch camera-RGB under the
    white-balance illuminant to swatch XYZ under the output illuminant —
    exactly PixelSensor's training solve (film.cpp)."""
    import numpy as np

    from ..core import named_spectra, spectrum as sp

    if not named_spectra.has(f"{name}_r"):
        return None
    curves = np.stack([named_spectra.dense(f"{name}_{c}") for c in "rgb"])
    lam = np.arange(sp.LAMBDA_MIN, sp.LAMBDA_MAX + 1.0)
    wb = 6500.0 if not white_balance_temp else float(white_balance_temp)
    # true CIE D65 table for the ~6500K default (Spectra::D); blackbody
    # approximation only for other temperatures
    if named_spectra.has("stdillum-D65"):
        d65 = named_spectra.dense("stdillum-D65")
        d65 = d65 / max(d65[lam == 560.0][0] if (lam == 560.0).any()
                        else d65.max(), 1e-9)
    else:
        d65 = np.asarray(sp.blackbody_normalized(jnp.asarray(lam), 6500.0))
    if abs(wb - 6500.0) < 51.0:
        illum = d65
    else:
        illum = np.asarray(sp.blackbody_normalized(jnp.asarray(lam), wb))
    # The sensor illuminant applies only to the camera-RGB side; swatch XYZ is
    # projected under the OUTPUT colorspace illuminant (film.h:65,
    # outputColorSpace->illuminant = D65 for sRGB) — this is what performs the
    # chromatic adaptation for white_balance_temp far from 6500K.
    out_illum = d65
    sw = np.stack([named_spectra.dense(f"swatch_{i:02d}") for i in range(24)])
    g_int = float((curves[1] * illum).sum())
    rgb_cam = (sw * illum[None, :]) @ curves.T / max(g_int, 1e-9)
    cie = np.stack([np.asarray(sp.cie_x(jnp.asarray(lam))),
                    np.asarray(sp.cie_y(jnp.asarray(lam))),
                    np.asarray(sp.cie_z(jnp.asarray(lam)))])
    y_int = float((cie[1] * out_illum).sum())
    xyz_out = (sw * out_illum[None, :]) @ cie.T / max(y_int, 1e-9)
    X, *_ = np.linalg.lstsq(rgb_cam, xyz_out, rcond=None)
    # per-sample projection must use the same normalization as the training
    # projection (ProjectReflectance divides by the g-integral, film.h:96)
    return MeasuredSensor(curves=(curves / max(g_int, 1e-9)).astype(np.float32),
                          xyz_from_rgb=X.T.astype(np.float32),
                          imaging_ratio=float(exposure * iso / 100.0))


def add_samples(film: Film, pixel_idx: Array, L: Array, lam: Array, lam_pdf: Array,
                filter_weight: Array | None = None, sequential: bool = False,
                sensor_curves: Array | None = None) -> Film:
    """Accumulate spectral radiance samples (RGBFilm::AddSample analog).

    pixel_idx: (R,) flat indices; L: (R,4); lam/lam_pdf: (R,4).
    With filter importance sampling (the reference's FilterSampler), the
    filter weight is constant 1 — jitter position carries the filter.

    sequential=True asserts pixel_idx == arange(H*W) (the standard one-sample-
    per-pixel wave) and skips the scatter — a plain vector add instead of a
    scatter.
    """
    if sensor_curves is None:
        xyz = spectrum.spectrum_to_xyz(L, lam, lam_pdf)
    else:
        # measured sensor: the film's 'xyz' plane holds SENSOR RGB; develop
        # maps it through the sensor's swatch-trained matrix
        xyz = spectrum_to_sensor_rgb(L, lam, lam_pdf, sensor_curves)
    w = jnp.ones(pixel_idx.shape, jnp.float32) if filter_weight is None else filter_weight
    # clamp NaN/inf defensively (film.h RGBFilm max-component clamp)
    xyz = jnp.where(jnp.isfinite(xyz), xyz, 0.0)
    if sequential:
        new_xyz = film.xyz + xyz * w[..., None]
        new_w = film.weight + w
    else:
        new_xyz = film.xyz.at[pixel_idx].add(xyz * w[..., None])
        new_w = film.weight.at[pixel_idx].add(w)
    return film._replace(xyz=new_xyz, weight=new_w)


def add_splats(film: Film, pixel_idx: Array, L: Array, lam: Array, lam_pdf: Array) -> Film:
    xyz = spectrum.spectrum_to_xyz(L, lam, lam_pdf)
    xyz = jnp.where(jnp.isfinite(xyz), xyz, 0.0)
    return film._replace(splat_xyz=film.splat_xyz.at[pixel_idx].add(xyz))


class PixelSensor(NamedTuple):
    """Camera sensor response (PixelSensor, film.h:36): an XYZ->output-RGB
    matrix folding in white balance (chromatic adaptation from the
    white-balance illuminant to the output space's white) and an imaging
    ratio (exposure * ISO/100)."""

    xyz_to_rgb: "object"   # (3,3) np
    imaging_ratio: float


def make_sensor(white_balance_temp: float | None = None, iso: float = 100.0,
                exposure: float = 1.0, output_space: str = "srgb") -> PixelSensor:
    """white_balance_temp: blackbody CCT the scene illuminant should map to
    neutral (pbrt 'whitebalance' film parameter); None = adapt the renderer's
    standard illuminant (the default sensor contract)."""
    import numpy as np

    if white_balance_temp is None:
        src = spectrum.illuminant_whitepoint_xyz()
    else:
        lam = np.linspace(spectrum.LAMBDA_MIN, spectrum.LAMBDA_MAX, 471)
        import jax.numpy as _jnp
        bb = np.asarray(spectrum.blackbody_normalized(_jnp.asarray(lam),
                                                      float(white_balance_temp)))
        x = np.asarray(spectrum.cie_x(_jnp.asarray(lam)))
        y = np.asarray(spectrum.cie_y(_jnp.asarray(lam)))
        z = np.asarray(spectrum.cie_z(_jnp.asarray(lam)))
        src = np.array([np.trapezoid(bb * x, lam), np.trapezoid(bb * y, lam),
                        np.trapezoid(bb * z, lam)], np.float32)
        src = src / max(src[1], 1e-9)
    wb = colorspace.white_balance_matrix(src, colorspace.SRGB_WHITE_XYZ)
    m = colorspace.XYZ_TO_RGB[output_space] @ wb
    return PixelSensor(m.astype("float32"), float(exposure * iso / 100.0))


def develop(film: Film, splat_scale: float = 1.0,
            sensor: PixelSensor | None = None) -> Array:
    """-> (H, W, 3) linear output RGB (white-balanced sensor response,
    RGBFilm::GetImage)."""
    w = jnp.maximum(film.weight, 1e-9)[:, None]
    xyz = film.xyz / w + splat_scale * film.splat_xyz
    if sensor is None:
        rgb = colorspace.xyz_to_linear_srgb(xyz)
    elif isinstance(sensor, MeasuredSensor):
        # film plane holds sensor RGB (see add_samples): camera RGB ->
        # output XYZ (swatch matrix) -> linear sRGB, times imaging ratio
        x2 = jnp.einsum("ij,...j->...i", jnp.asarray(sensor.xyz_from_rgb), xyz,
                        precision=_HI)
        rgb = colorspace.xyz_to_linear_srgb(x2) * sensor.imaging_ratio
    else:
        rgb = jnp.einsum("ij,...j->...i", jnp.asarray(sensor.xyz_to_rgb),
                         xyz, precision=_HI) * sensor.imaging_ratio
    return rgb.reshape(film.height, film.width, 3)


# ---------------------------------------------------------------------------
# SpectralFilm (film.h:401): per-wavelength-bucket accumulation
# ---------------------------------------------------------------------------

class SpectralFilm(NamedTuple):
    buckets: Array   # (H*W, NB) radiance sums per wavelength bucket
    bweight: Array   # (H*W, NB) per-bucket pdf-weight sums
    height: int
    width: int
    lambda_min: float
    lambda_max: float


_register_static(SpectralFilm,
                 ("height", "width", "lambda_min", "lambda_max"))


def make_spectral_film(height: int, width: int, n_buckets: int = 16,
                       lambda_min: float = spectrum.LAMBDA_MIN,
                       lambda_max: float = spectrum.LAMBDA_MAX) -> SpectralFilm:
    n = height * width
    return SpectralFilm(
        buckets=jnp.zeros((n, n_buckets), jnp.float32),
        bweight=jnp.zeros((n, n_buckets), jnp.float32),
        height=height, width=width,
        lambda_min=float(lambda_min), lambda_max=float(lambda_max),
    )


def add_samples_spectral(film: SpectralFilm, pixel_idx: Array, L: Array,
                         lam: Array, lam_pdf: Array,
                         filter_weight: Array | None = None,
                         sequential: bool = False) -> SpectralFilm:
    """SpectralFilm::AddSample: each of the 4 hero-wavelength samples lands in
    its wavelength bucket with the radiance estimate L/pdf (film.cpp)."""
    nb = film.buckets.shape[-1]
    t = (lam - film.lambda_min) / (film.lambda_max - film.lambda_min)
    b = jnp.clip((t * nb).astype(jnp.int32), 0, nb - 1)  # (R,4)
    w = (jnp.ones(pixel_idx.shape, jnp.float32)
         if filter_weight is None else filter_weight)
    est = jnp.where(lam_pdf > 0, L / jnp.maximum(lam_pdf, 1e-20), 0.0)
    est = jnp.where(jnp.isfinite(est), est, 0.0) * w[..., None]
    # scatter the 4 samples into the per-pixel buckets
    onehot = jax.nn.one_hot(b, nb, dtype=jnp.float32)          # (R,4,NB)
    vals = jnp.einsum("rs,rsb->rb", est, onehot, precision=_HI)
    wsum = jnp.einsum("rs,rsb->rb", jnp.broadcast_to(w[..., None], est.shape),
                      onehot, precision=_HI)
    if sequential:
        return film._replace(buckets=film.buckets + vals,
                             bweight=film.bweight + wsum)
    return film._replace(buckets=film.buckets.at[pixel_idx].add(vals),
                         bweight=film.bweight.at[pixel_idx].add(wsum))


def develop_spectral(film: SpectralFilm) -> Array:
    """-> (H, W, NB) mean spectral radiance per bucket."""
    out = film.buckets / jnp.maximum(film.bweight, 1e-9)
    return out.reshape(film.height, film.width, -1)


def merge(films: list[Film]) -> Film:
    """Sum partial films (the psum analog for host-side combination)."""
    out = films[0]
    for f in films[1:]:
        out = out._replace(
            xyz=out.xyz + f.xyz,
            weight=out.weight + f.weight,
            splat_xyz=out.splat_xyz + f.splat_xyz,
        )
    return out
