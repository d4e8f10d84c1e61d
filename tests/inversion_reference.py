"""Plain float64 numpy reference of the Bayesian wind inversion.

A per-pixel loop written from the published method (xsarsea
``windspeed.py:183-282``, SURVEY §3.1), independent of the code under
test: nearest-incidence LUT slice, full-grid cost, first-minimum argmin,
±phi disambiguation against the ancillary direction, the crosspol 1-D
argmin with the copol speed as prior, and the NaN guards.

Departures from the published code, none of which moves a grid node:

- the crosspol prior uses the copol node's wspd, where the reference
  takes ``|w e^{i phi}|`` of the complex copol wind (1 ulp apart);
- inputs are arrays of pixels, not a numba gufunc over dask chunks.
"""

import numpy as np

D_ANTENNA, D_AZI, DWSPD_FG = 2.0, 2.0, 2.0


def prepare(lut_co=None, lut_cr=None):
    """LUT DimArrays (dB; dims incidence, wspd[, phi]) -> f64 numpy grids."""
    t = {}
    if lut_co is not None:
        phi = np.asarray(lut_co.coords["phi"], np.float64)
        wspd = np.asarray(lut_co.coords["wspd"], np.float64)
        phir = np.deg2rad(phi)
        t.update(co=np.asarray(lut_co.data, np.float64),
                 co_inc=np.asarray(lut_co.coords["incidence"], np.float64),
                 co_wspd=wspd, co_phir=phir,
                 u=wspd[:, None] * np.cos(phir)[None, :],
                 v=wspd[:, None] * np.sin(phir)[None, :],
                 # symmetric-LUT rule (windspeed.py:152-156); also true
                 # for a 0..360 span
                 phi_180=(180.0 - (phi[-1] - phi[0])) < 2.0)
    if lut_cr is not None:
        t.update(cr=np.asarray(lut_cr.data, np.float64),
                 cr_inc=np.asarray(lut_cr.coords["incidence"], np.float64),
                 cr_wspd=np.asarray(lut_cr.coords["wspd"], np.float64))
    return t


def copol_cost(t, inc, s0_db, ma, mz, dsig_co=0.1):
    """(W, P) cost surface of one pixel (windspeed.py:212-225)."""
    lut = t["co"][np.argmin(np.abs(t["co_inc"] - inc))]
    mz = abs(mz) if t["phi_180"] else mz
    jwind = ((t["u"] - ma) / D_ANTENNA) ** 2 + ((t["v"] - mz) / D_AZI) ** 2
    return jwind + ((lut - s0_db) / dsig_co) ** 2


def crosspol_cost(t, inc, s0_db, dsig_cr, wspd_co):
    """(Wc,) crosspol cost of one pixel (windspeed.py:252-276); the
    prior term only when a copol speed exists."""
    lut = t["cr"][np.argmin(np.abs(t["cr_inc"] - inc))]
    j = ((lut - s0_db) / dsig_cr) ** 2
    if not np.isnan(wspd_co):
        j = j + ((t["cr_wspd"] - wspd_co) / DWSPD_FG) ** 2
    return j


def invert(t, inc, s0_co_db, s0_cr_db, dsig_cr, anc, dsig_co=0.1):
    """Per-pixel inversion of flat f64 arrays (sigma0 in dB).

    Returns (wind_co, wind_dual) complex128, before the dual-pol < 5 m/s
    merge. Missing copol gives nan+nanj; the NaN-incidence and
    NaN-ancillary guards give nan+0j, as in the reference.
    """
    n = len(inc)
    co = np.full(n, np.nan + 0j)
    dual = np.full(n, np.nan + 0j)
    for i in range(n):
        ma, mz = anc[i].real, anc[i].imag
        if np.isnan(inc[i]) or (not np.isnan(s0_co_db[i])
                                and np.isnan(ma + mz)):
            continue  # guards 1 and 2: nan+0j
        wspd_co = phi_co = np.nan
        if "co" in t and not np.isnan(s0_co_db[i]):
            j = copol_cost(t, inc[i], s0_co_db[i], ma, mz, dsig_co)
            iw, ip = np.unravel_index(np.argmin(j), j.shape)
            wspd_co, phi_co = t["co_wspd"][iw], t["co_phir"][ip]
            if t["phi_180"]:
                anc_ang = np.arctan2(mz, ma)
                d1 = abs(np.angle(np.exp(1j * (anc_ang - phi_co))))
                d2 = abs(np.angle(np.exp(1j * (anc_ang + phi_co))))
                phi_co = phi_co if d1 <= d2 else -phi_co
        co[i] = wspd_co * np.exp(1j * phi_co) if not np.isnan(wspd_co) \
            else np.nan * 1j
        if "cr" in t and not (np.isnan(s0_cr_db[i]) or np.isnan(dsig_cr[i])):
            j = crosspol_cost(t, inc[i], s0_cr_db[i], dsig_cr[i], wspd_co)
            phi = phi_co if not np.isnan(wspd_co) else 0.0
            dual[i] = t["cr_wspd"][np.argmin(j)] * np.exp(1j * phi)
        else:
            dual[i] = np.nan * 1j
    return co, dual


def to_db(sigma0_linear):
    """The reference's dB conversion (windspeed.py:126-130)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return 10.0 * np.log10(np.asarray(sigma0_linear, np.float64) + 1e-15)
