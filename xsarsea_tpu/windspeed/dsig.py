"""dsig weighting schemes and NESZ flattening.

JAX counterpart of the reference ``windspeed/utils.py``:
``get_dsig`` / ``get_dsig_wspd`` are elementwise jnp-compatible formulas;
``nesz_flattening`` replaces the per-row ``np.polyfit`` loop
(utils.py:138-163) with a vmapped closed-form weighted line fit.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from xsarsea_tpu.dimarray import DimArray
from xsarsea_tpu.interop import xarray_io

__all__ = ["get_dsig", "get_dsig_wspd", "nesz_flattening"]

# sigmoid-blend constants tuned per satellite (reference utils.py:26-42)
_DSIG_WSPD_PARAMS = {
    "dsig_wspd_rs2_v3": (-0.4908643753212401, 16.763199934792965,
                         1.3891445172991084, 20.616914824394343),
    "dsig_wspd_s1_ew_rec_v3": (-0.5858970325653666, 16.50039320910609,
                               1.1032031322520397, 7.434663633997121),
    "dsig_wspd_rcm_v3": (-0.7920301376936547, 15.8288289109038,
                         0.24040294696606557, 0.2538177092195224),
}


def _data(x):
    return x.data if isinstance(x, DimArray) else x


def _wrap_like(template, data):
    if isinstance(template, DimArray):
        out = template.copy(data=data)
        out.attrs = {}
        return out
    return data


@xarray_io
def get_dsig_wspd(name, U_crosspol, SNR_cr, Umax=30.0):
    """Wind-speed-dependent dsig blend alpha (reference utils.py:18-44)."""
    try:
        b, c0_base, gamma, k = _DSIG_WSPD_PARAMS[name]
    except KeyError:
        raise ValueError(f"unknown dsig_wspd name '{name}'")
    u = _data(U_crosspol)
    snr = _data(SNR_cr)
    xp = jnp if isinstance(u, jax.Array) or isinstance(snr, jax.Array) else np
    c0 = c0_base - gamma * snr
    alpha_core = 1.0 / (1.0 + xp.exp(-b * (u - c0)))
    drop = 1.0 / (1.0 + xp.exp((u - Umax) * k))
    return _wrap_like(U_crosspol, xp.clip(alpha_core * drop, 0.0, 1.0))


@xarray_io
def get_dsig(name, inc, sigma0_cr, nesz_cr):
    """Named dsig_cr weighting for the crosspol cost term (utils.py:47-91)."""
    inc_d, s0, nesz = _data(inc), _data(sigma0_cr), _data(nesz_cr)
    xp = jnp if any(isinstance(v, jax.Array) for v in (inc_d, s0, nesz)) else np

    if name == "gmf_s1_v2":
        c0, c1, d0, d1 = 1.57952257, 25.61843791, 1.46852088, 1.4058646
        c = d0 + d1 / (1.0 + xp.exp(-c0 * (inc_d - c1)))
        out = 1.0 / xp.sqrt((s0 / nesz) ** c)
    elif name == "gmf_rs2_v2":
        out = 1.0 / xp.sqrt((s0 / nesz) ** 8.0)
    elif name in ("sarwing_lut_cmodms1ahw", "nc_lut_cmodms1ahw"):
        out = (1.25 / (s0 / nesz)) ** 4.0
    else:
        raise ValueError(
            "dsig names other than 'gmf_s1_v2', 'gmf_rs2_v2', "
            "'sarwing_lut_cmodms1ahw' or 'nc_lut_cmodms1ahw' are not handled. "
            "You can compute your own dsig_cr."
        )
    return _wrap_like(sigma0_cr, out)


@jax.jit
def _flatten_rows(noise, inc_1d, col_mean):
    """vmapped order-1 fit of noise_dB vs incidence, per row.

    Equivalent to the reference per-row np.polyfit (utils.py:138-160):
    NaNs are first replaced by the column mean, then remaining non-finite
    samples are excluded from the fit via zero weights (closed-form
    weighted least squares on a line).
    """

    def one_row(noise_row):
        filled = jnp.where(jnp.isnan(noise_row), col_mean, noise_row)
        noise_db = 10.0 * jnp.log10(filled)
        w = jnp.isfinite(noise_db).astype(noise_db.dtype)
        y = jnp.where(w > 0, noise_db, 0.0)
        x = jnp.where(w > 0, inc_1d, 0.0)
        sw = jnp.sum(w)
        sx = jnp.sum(x)
        sy = jnp.sum(y)
        sxx = jnp.sum(x * x)
        sxy = jnp.sum(x * y)
        denom = sw * sxx - sx * sx
        slope = (sw * sxy - sx * sy) / denom
        intercept = (sy - slope * sx) / sw
        flat = 10.0 ** ((inc_1d * slope + intercept - 1.0) / 10.0)
        # all-NaN row (sw == 0) -> NaN row, like the reference TypeError path
        return jnp.where(sw > 0, flat, jnp.nan)

    return jax.vmap(one_row)(noise)


@xarray_io
def nesz_flattening(noise, inc):
    """Flatten NESZ by a per-row order-1 polynomial fit in dB (utils.py:94-163).

    `noise` is linear NESZ with shape (line, sample); `inc` the incidence
    array of the same shape. Incidence is reduced to its column mean (it is
    nearly constant along the line dim).
    """
    noise_d = _data(noise)
    inc_d = _data(inc)
    if np.ndim(noise_d) != 2:
        raise IndexError("Only 2D noise allowed")

    noise_j = jnp.asarray(noise_d)
    inc_1d = jnp.nanmean(jnp.asarray(inc_d), axis=0)
    col_mean = jnp.nanmean(noise_j, axis=0)
    out = _flatten_rows(noise_j, inc_1d, col_mean)
    return _wrap_like(noise, out)
