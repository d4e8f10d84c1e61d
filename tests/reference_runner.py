"""Parity oracles: the *reference* xsarsea physics, and the inversion.

The reference library cannot be imported as-is here (numba/xarray/dask are
not installed), but its physics lives in pure numpy+python. This module
executes selected reference source files inside surgically stubbed module
trees (numba -> pure-python gufunc shim, xarray -> numpy shims), so parity
tests compare against the reference's *actual* code, not a transcription.

Nothing from the reference is copied into the framework: this runner exists
only under tests/ and loads the sources from /root/reference at test time.
"""

from __future__ import annotations

import importlib.util
import sys
import types

import numpy as np

import inversion_reference

REF_SRC = "/root/reference/src/xsarsea"


def _exec_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _ensure_pkg(name):
    if name not in sys.modules:
        mod = types.ModuleType(name)
        mod.__path__ = []
        sys.modules[name] = mod
    return sys.modules[name]


# --------------------------------------------------------------------- GMFs

_ref_gmfs_cache = None


def load_ref_gmfs():
    """Dict of reference scalar GMF functions {name: f(inc, wspd, phi)}."""
    global _ref_gmfs_cache
    if _ref_gmfs_cache is not None:
        return _ref_gmfs_cache

    collected = {}

    class FakeGmfModel:
        @classmethod
        def register(cls, name=None, pol=None, units=None, defer=True, **kw):
            def inner(func):
                collected[name or func.__name__] = func
                return func

            return inner

    _ensure_pkg("xsarsea_ref")
    _ensure_pkg("xsarsea_ref.windspeed")
    fake_gmfs = types.ModuleType("xsarsea_ref.windspeed.gmfs")
    fake_gmfs.GmfModel = FakeGmfModel
    sys.modules["xsarsea_ref.windspeed.gmfs"] = fake_gmfs

    src = open(f"{REF_SRC}/windspeed/gmfs_impl.py").read()
    src = src.replace("from xsarsea.windspeed.gmfs import GmfModel",
                      "from xsarsea_ref.windspeed.gmfs import GmfModel")
    mod = types.ModuleType("xsarsea_ref.windspeed.gmfs_impl")
    sys.modules[mod.__name__] = mod
    exec(compile(src, f"{REF_SRC}/windspeed/gmfs_impl.py", "exec"), mod.__dict__)

    _ref_gmfs_cache = collected
    return collected


def ref_gmf_grid(name, inc, wspd, phi=None):
    """Evaluate a reference scalar GMF over an outer-product grid (f64)."""
    fn = load_ref_gmfs()[name]
    inc = np.atleast_1d(np.asarray(inc, dtype=np.float64))
    wspd = np.atleast_1d(np.asarray(wspd, dtype=np.float64))
    if phi is None:
        out = np.empty((inc.size, wspd.size))
        for i, one_inc in enumerate(inc):
            for j, one_wspd in enumerate(wspd):
                out[i, j] = fn(one_inc, one_wspd)
        return out
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    out = np.empty((inc.size, wspd.size, phi.size))
    for i, one_inc in enumerate(inc):
        for j, one_wspd in enumerate(wspd):
            for k, one_phi in enumerate(phi):
                out[i, j, k] = fn(one_inc, one_wspd, one_phi)
    return out


# ---------------------------------------------------------------- inversion
#
# The inversion oracle is the plain float64 numpy loop of
# tests/inversion_reference.py (written from the published method), so
# these parity tests need no reference checkout.

def ref_invert(inc, sigma0_co, sigma0_cr, dsig_cr, ancillary_wind,
               lut_co_db, lut_cr_db, dsig_co=0.1):
    """Reference dual-pol inversion of image arrays (sigma0 linear).

    LUTs are DimArrays in dB with dims (incidence, wspd, phi) /
    (incidence, wspd). Returns (wind_co, wind_dual) complex arrays,
    before the dual-pol merge.
    """
    t = inversion_reference.prepare(lut_co_db, lut_cr_db)
    shape = np.shape(sigma0_co)
    co, dual = inversion_reference.invert(
        t, _flat(inc, shape), inversion_reference.to_db(sigma0_co).ravel(),
        inversion_reference.to_db(sigma0_cr).ravel(), _flat(dsig_cr, shape),
        _flat(ancillary_wind, shape, np.complex128), dsig_co)
    return co.reshape(shape), dual.reshape(shape)


def ref_invert_mono_copol(inc, sigma0_co, ancillary_wind, lut_co_db,
                          dsig_co=0.1):
    t = inversion_reference.prepare(lut_co_db, None)
    shape = np.shape(sigma0_co)
    nan = np.full(int(np.prod(shape)), np.nan)
    co, _ = inversion_reference.invert(
        t, _flat(inc, shape), inversion_reference.to_db(sigma0_co).ravel(),
        nan, nan, _flat(ancillary_wind, shape, np.complex128), dsig_co)
    return co.reshape(shape)


def ref_invert_mono_crosspol(inc, sigma0_cr, dsig_cr, lut_cr_db):
    """Crosspol-only inversion: wind speed (real array)."""
    t = inversion_reference.prepare(None, lut_cr_db)
    shape = np.shape(sigma0_cr)
    nan = np.full(int(np.prod(shape)), np.nan)
    _, dual = inversion_reference.invert(
        t, _flat(inc, shape), nan,
        inversion_reference.to_db(sigma0_cr).ravel(), _flat(dsig_cr, shape),
        nan.astype(np.complex128))
    return np.abs(dual).reshape(shape)


def _flat(a, shape, dtype=np.float64):
    return np.broadcast_to(np.asarray(a, dtype), shape).ravel()


# ----------------------------------------------------------------- gradients

_ref_gradients_cache = None


def load_ref_gradients():
    """Load reference gradients.py with an (unused-at-import) xarray stub.

    Only the pure-numpy pieces are usable from it (gradient_histogram);
    the xarray-dependent class machinery is exercised through hand-built
    cv2/scipy oracles in the tests instead.
    """
    global _ref_gradients_cache
    if _ref_gradients_cache is None:
        xr_stub = types.ModuleType("xarray")
        saved = sys.modules.get("xarray")
        sys.modules["xarray"] = xr_stub
        try:
            utils_stub = types.ModuleType("xsarsea.utils")
            utils_stub.timing = lambda logger=None: (lambda f: f)
            _ensure_pkg("xsarsea")
            sys.modules["xsarsea.utils"] = utils_stub
            _ref_gradients_cache = _exec_file(
                f"{REF_SRC}/gradients.py", "xsarsea_ref_gradients"
            )
        finally:
            if saved is None:
                sys.modules.pop("xarray", None)
            else:
                sys.modules["xarray"] = saved
    return _ref_gradients_cache


# ------------------------------------------------------- windspeed utilities

_ref_wutils_cache = None


def load_ref_windspeed_utils():
    """Reference windspeed/utils.py (get_dsig, get_dsig_wspd, nesz_flattening)."""
    global _ref_wutils_cache
    if _ref_wutils_cache is None:
        _ref_wutils_cache = _exec_file(f"{REF_SRC}/windspeed/utils.py", "xsarsea_ref_wutils")
    return _ref_wutils_cache
