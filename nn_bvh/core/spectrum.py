"""Point-sampled spectral rendering types.

Batched counterpart of the reference's `util/spectrum.h`:
- `SampledSpectrum` (spectrum.h:91) becomes a trailing axis of length
  N_SPECTRUM_SAMPLES = 4 (spectrum.h:36) on every radiance/throughput array.
- `SampledWavelengths` (spectrum.h:269) becomes a pair of (lambda, pdf) arrays
  with the same trailing axis, stratified per pixel-sample.
- The CIE 1931 matching curves are evaluated analytically with the multi-lobe
  piecewise-Gaussian fits of Wyman, Sloan & Shirley (JCGT 2013) instead of the
  reference's 471-entry tables — table-free, pure VPU math, accurate to ~1%.

Everything here is elementwise over batch axes — directly vmappable/shardable.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

Array = jax.Array

N_SPECTRUM_SAMPLES = 4
LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0


def _gauss(x, mu, s1, s2):
    """Piecewise Gaussian used by the Wyman et al. CIE fits.

    Works for both jnp and np inputs (np.where/exp dispatch on ndarray), so
    the module-level normalization integrals below can run in numpy at import
    time without touching the device."""
    xp = jnp if isinstance(x, jax.Array) else np
    s = xp.where(x < mu, s1, s2)
    t = (x - mu) / s
    return xp.exp(-0.5 * t * t)


def cie_x(lam: Array) -> Array:
    return (
        1.056 * _gauss(lam, 599.8, 37.9, 31.0)
        + 0.362 * _gauss(lam, 442.0, 16.0, 26.7)
        - 0.065 * _gauss(lam, 501.1, 20.4, 26.2)
    )


def cie_y(lam: Array) -> Array:
    return 0.821 * _gauss(lam, 568.8, 46.9, 40.5) + 0.286 * _gauss(lam, 530.9, 16.3, 31.1)


def cie_z(lam: Array) -> Array:
    return 1.217 * _gauss(lam, 437.0, 11.8, 36.0) + 0.681 * _gauss(lam, 459.0, 26.0, 13.8)


def _compute_y_integral() -> float:
    lam = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 1.0)
    return float(np.sum(cie_y(lam)))


CIE_Y_INTEGRAL = _compute_y_integral()  # analog of spectrum.h CIE_Y_integral (106.857)


# ---------------------------------------------------------------------------
# SampledWavelengths (spectrum.h:269)
# ---------------------------------------------------------------------------

def sample_wavelengths_uniform(u: Array):
    """Stratified uniform wavelengths from a single [0,1) sample per ray.

    u: (...,) -> (lambda (..., 4), pdf (..., 4)). Mirrors
    SampledWavelengths::SampleUniform (spectrum.h:274).
    """
    span = LAMBDA_MAX - LAMBDA_MIN
    offsets = jnp.arange(N_SPECTRUM_SAMPLES, dtype=jnp.float32) / N_SPECTRUM_SAMPLES
    up = jnp.mod(u[..., None] + offsets, 1.0)
    lam = LAMBDA_MIN + up * span
    pdf = jnp.full_like(lam, 1.0 / span)
    return lam, pdf


def sample_wavelengths_visible(u: Array):
    """Importance-sampled visible wavelengths (spectrum.h SampleVisible)."""
    from . import sampling

    offsets = jnp.arange(N_SPECTRUM_SAMPLES, dtype=jnp.float32) / N_SPECTRUM_SAMPLES
    up = jnp.mod(u[..., None] + offsets, 1.0)
    lam = sampling.sample_visible_wavelengths(up)
    pdf = sampling.visible_wavelengths_pdf(lam)
    return lam, pdf


def terminate_secondary(lam: Array, pdf: Array):
    """Collapse to the hero wavelength after dispersion
    (SampledWavelengths::TerminateSecondary, spectrum.h:300)."""
    new_pdf = jnp.concatenate(
        [pdf[..., :1] / N_SPECTRUM_SAMPLES, jnp.zeros_like(pdf[..., 1:])], axis=-1
    )
    return lam, new_pdf


# ---------------------------------------------------------------------------
# spectra
# ---------------------------------------------------------------------------

def blackbody(lam_nm: Array, T) -> Array:
    """Planck's law, W/(m^2 sr nm)-proportional (spectrum.h Blackbody:497)."""
    lam = lam_nm * 1e-9
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    xp = jnp if isinstance(lam_nm, jax.Array) else np
    x = (h * c) / (lam * kb * T)
    # avoid overflow
    x = xp.minimum(x, 80.0)
    return (2.0 * h * c * c) / (lam**5 * (xp.exp(x) - 1.0))


def blackbody_normalized(lam_nm: Array, T) -> Array:
    """Blackbody scaled so its peak is 1 (BlackbodySpectrum, spectrum.h:497)."""
    lam_max = 2.8977721e-3 / T * 1e9
    peak = float(blackbody(np.float64(lam_max), T))
    return blackbody(lam_nm, T) / peak


# Std illuminant: normalized blackbody at D65's CCT. The reference embeds the
# measured CIE D65 table (spectrum.cpp); the blackbody approximation keeps us
# table-free and is corrected to exact sRGB white by the sensor white-balance
# step (colorspace.white_balance_xyz), so an albedo-1 furnace renders to RGB 1.
STD_ILLUM_CCT = 6504.0


def illuminant_d(lam_nm: Array) -> Array:
    return blackbody_normalized(lam_nm, STD_ILLUM_CCT)


def _illum_y() -> float:
    l = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 1.0)
    return float(np.sum(cie_y(l) * illuminant_d(l))) / CIE_Y_INTEGRAL


ILLUM_D_Y = _illum_y()  # luminance of the unnormalized illuminant


def illuminant_d_normalized(lam_nm: Array) -> Array:
    """Illuminant scaled to luminance Y=1 (photometric normalization like
    scene.cpp's 'scale' handling for light spectra)."""
    return illuminant_d(lam_nm) / ILLUM_D_Y


def illuminant_whitepoint_xyz() -> np.ndarray:
    l = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 1.0)
    w = illuminant_d(l)
    x = float(np.sum(cie_x(l) * w))
    y = float(np.sum(cie_y(l) * w))
    z = float(np.sum(cie_z(l) * w))
    return np.array([x, y, z]) / y


# ---------------------------------------------------------------------------
# sampled-spectrum <-> XYZ (spectrum.h SpectrumToXYZ)
# ---------------------------------------------------------------------------

def safe_div(a: Array, b: Array) -> Array:
    return jnp.where(b != 0, a / jnp.where(b == 0, 1.0, b), 0.0)


def spectrum_to_xyz(values: Array, lam: Array, pdf: Array) -> Array:
    """MC estimate of XYZ from point-sampled spectrum.

    values/lam/pdf: (..., 4) -> xyz (..., 3). Mirrors
    SampledSpectrum::ToXYZ (spectrum.cpp) incl. pdf division and the
    CIE_Y_integral normalization.
    """
    w = safe_div(jnp.ones_like(pdf), pdf)
    x = jnp.mean(cie_x(lam) * values * w, axis=-1)
    y = jnp.mean(cie_y(lam) * values * w, axis=-1)
    z = jnp.mean(cie_z(lam) * values * w, axis=-1)
    return jnp.stack([x, y, z], axis=-1) / CIE_Y_INTEGRAL
