"""Model registry: abstract Model, LUT normalization, alias resolution.

JAX redesign of the reference registry (xsarsea
``windspeed/models.py``): the same public
surface (``Model``, ``available_models``, ``get_model``, ``register_luts``,
``Model.to_lut``, ``Model.to_netcdf``) but LUTs are
:class:`~xsarsea_tpu.dimarray.DimArray` objects whose payload lives on the
accelerator, re-gridding runs as jitted separable linear interpolation, and
serialization goes through :mod:`xsarsea_tpu.io.lut_io`.
"""

from __future__ import annotations

import logging

import numpy as np

from xsarsea_tpu.dimarray import DimArray
from xsarsea_tpu.utils import from_dB, to_dB

logger = logging.getLogger("xsarsea_tpu.models")

__all__ = ["Model", "LutModel", "available_models", "get_model", "register_luts"]


def _grid(rng, step):
    """linspace grid from an inclusive range and step (models.py:154-160)."""
    if rng is None:
        return None
    num = int(np.round((rng[1] - rng[0]) / step) + 1)
    return np.linspace(rng[0], rng[1], num=num)


class Model:
    """Abstract GMF/LUT model. Instances self-register by name.

    Registered models are discovered with :func:`available_models`; short
    names are aliased to the lowest-priority implementation, mirroring the
    reference resolution table (models.py:453-507).
    """

    _available_models: dict = {}
    _name_prefix = ""
    _priority = None

    # default LUT generation parameters (reference models.py:38-48)
    DEFAULT_INC_RANGE = [16.0, 66.0]

    def __init__(self, name, **kwargs):
        self.name = name
        self.pol = kwargs.pop("pol", None)
        self.units = kwargs.pop("units", None)
        self.phi_range = kwargs.pop("phi_range", None)
        self.wspd_range = kwargs.pop("wspd_range", None)
        self.inc_range = kwargs.pop("inc_range", None) or list(self.DEFAULT_INC_RANGE)
        self.resolution = kwargs.pop("resolution", None)

        self.inc_step_lr = kwargs.pop("inc_step_lr", 1.0)
        self.wspd_step_lr = kwargs.pop("wspd_step_lr", 0.2)
        self.phi_step_lr = kwargs.pop("phi_step_lr", 2.5)
        self.inc_step = kwargs.pop("inc_step", 0.1)
        self.wspd_step = kwargs.pop("wspd_step", 0.1)
        self.phi_step = kwargs.pop("phi_step", 1.0)

        for k, v in kwargs.items():
            setattr(self, k, v)

        self._lut_cache = {}
        Model._available_models[name] = self
        logger.debug("registered model %s pol=%s units=%s", name, self.pol, self.units)

    # ------------------------------------------------------------ properties
    @property
    def short_name(self):
        if self._name_prefix and self.name.startswith(self._name_prefix):
            return self.name[len(self._name_prefix):]
        return None

    @property
    def iscopol(self):
        """True if model is copol (e.g. 'VV', 'HH')."""
        return self.pol is not None and len(set(self.pol)) == 1

    @property
    def iscrosspol(self):
        """True if model is crosspol (e.g. 'VH', 'HV')."""
        return self.pol is not None and len(set(self.pol)) == 2

    def __repr__(self):
        return f"<{self.__class__.__name__}('{self.name}') pol={self.pol}>"

    # ----------------------------------------------------------------- LUTs
    def _raw_lut(self, **kwargs):
        raise NotImplementedError

    def _steps_for(self, resolution, **overrides):
        if resolution == "low":
            return (
                overrides.get("inc_step_lr", self.inc_step_lr),
                overrides.get("wspd_step_lr", self.wspd_step_lr),
                overrides.get("phi_step_lr", self.phi_step_lr),
            )
        return (
            overrides.get("inc_step", self.inc_step),
            overrides.get("wspd_step", self.wspd_step),
            overrides.get("phi_step", self.phi_step),
        )

    def _normalize_lut(self, lut: DimArray, resolution="high", **kwargs):
        """Validate dims and re-grid the raw LUT to the requested resolution.

        Matches the reference semantics (models.py:82-174): the target grid
        is rebuilt from (range, step) per dim; interpolation is separable
        linear; skipped when the raw grid already matches.
        """
        if lut.dims not in (("incidence", "wspd"), ("incidence", "wspd", "phi")):
            raise IndexError(f"Bad lut dims {lut.dims}")
        units = lut.attrs.get("units")
        if units not in ("linear", "dB"):
            raise ValueError(f"Unknown lut units '{units}'")

        if resolution is None:
            resolution = "high"
        inc_step, wspd_step, phi_step = self._steps_for(resolution, **kwargs)

        target = {
            "incidence": _grid(self.inc_range, inc_step),
            "wspd": _grid(self.wspd_range, wspd_step),
        }
        if "phi" in lut.dims and self.phi_range is not None:
            target["phi"] = _grid(self.phi_range, phi_step)

        needs = {}
        for dim, tgt in target.items():
            if tgt is None:
                continue
            cur = np.asarray(lut.coords[dim], dtype=np.float64)
            if len(cur) != len(tgt) or not np.allclose(cur, tgt):
                needs[dim] = tgt
        if needs:
            lut = lut.interp(needs, bounds_error=True)
        lut = lut.assign_attrs(resolution=resolution)
        return lut

    def to_lut(self, units="linear", **kwargs):
        """Return the model LUT as a DimArray (dims incidence, wspd[, phi]).

        Parameters mirror the reference ``Model.to_lut`` (models.py:186-230):
        ``units`` in {'linear', 'dB', None}, ``resolution`` in
        {'high', 'low', None} plus per-dim step overrides.
        """
        # list-valued kwargs (e.g. range overrides) are normalized to
        # tuples so the key stays hashable; cache hits return a fresh
        # container (copy()) so a caller mutating .attrs/.data can never
        # corrupt later inversions built from the same model.
        def _hashable(v):
            return tuple(v) if isinstance(v, (list, np.ndarray)) else v

        key = (units, tuple(sorted((k, _hashable(v)) for k, v in kwargs.items())))
        if key in self._lut_cache:
            return self._lut_cache[key].copy()

        # The resolution kwarg reaches _raw_lut only when explicitly given —
        # so by default an analytic model generates at its native (low) grid
        # and is then interpolated to the high-res target, exactly like the
        # reference default path (gmfs.py:353 + models.py:108-167).
        _UNSET = object()
        user_res = kwargs.pop("resolution", _UNSET)
        raw_kwargs = dict(kwargs)
        if user_res is not _UNSET:
            raw_kwargs["resolution"] = user_res
        lut = self._raw_lut(**raw_kwargs)
        resolution = "high" if user_res in (_UNSET, None) else user_res
        lut = self._normalize_lut(lut, resolution=resolution, **kwargs)

        if units is not None and units != lut.attrs["units"]:
            if units == "dB":
                lut = lut.copy(data=to_dB(lut.data)).assign_attrs(units="dB")
            elif units == "linear":
                lut = lut.copy(data=from_dB(lut.data)).assign_attrs(units="linear")
            else:
                raise ValueError(f"Unit not known: {units}")

        lut = lut.assign_attrs(model=self.name, pol=self.pol)
        lut.name = "sigma0_model"
        # the cached payload is shared zero-copy between hits (a high-res
        # LUT is ~180 MB); freeze numpy buffers so an in-place edit by a
        # caller raises instead of silently corrupting later inversions
        # (jax arrays are immutable already)
        if isinstance(lut.data, np.ndarray):
            lut.data.flags.writeable = False
        self._lut_cache[key] = lut
        return lut.copy()

    def to_netcdf(self, file):
        """Serialize this model as a dB LUT netCDF file (models.py:232-262).

        Copol models are stored at low resolution, crosspol at high, like
        the reference. Also writes the packed device-ready sidecar when
        requested via :mod:`xsarsea_tpu.io.lut_io`.
        """
        from xsarsea_tpu.io.lut_io import write_lut

        resolution = "low" if self.iscopol else "high"
        lut = self.to_lut(resolution=resolution, units="dB")
        attrs = {
            "units": "dB",
            "pol": self.pol,
            "model": self.short_name or self.name,
            "resolution": resolution,
            "inc_range": np.asarray(self.inc_range, dtype=np.float64),
            "wspd_range": np.asarray(self.wspd_range, dtype=np.float64),
            "inc_step": float(np.round(np.diff(lut.coords["incidence"]).mean(), 2)),
            "wspd_step": float(np.round(np.diff(lut.coords["wspd"]).mean(), 2)),
        }
        if "phi" in lut.dims:
            attrs["phi_range"] = np.asarray(self.phi_range, dtype=np.float64)
            attrs["phi_step"] = float(np.round(np.diff(lut.coords["phi"]).mean(), 2))
        write_lut(file, lut, attrs)

    def __call__(self, inc, wspd, phi=None, broadcast=False):
        raise NotImplementedError(self.__class__)


class LutModel(Model):
    """Abstract base for tabulated models (netCDF / binary / pickle LUTs).

    Evaluation interpolates the (possibly re-gridded) LUT — scalar and 1-D
    outer-product calls are supported, like the reference LutModel
    (models.py:318-347).
    """

    _name_prefix = "nc_lut_"
    _priority = None

    def __call__(self, inc, wspd, phi=None, units=None, **kwargs):
        vals = [v for v in (inc, wspd, phi) if v is not None]
        all_scalar = all(np.isscalar(v) for v in vals)
        all_1d = all(hasattr(v, "ndim") and v.ndim == 1 for v in vals)
        if not (all_scalar or all_1d):
            raise NotImplementedError("Only scalar or 1D arrays are supported for LutModel")

        lut = self.to_lut(units=units, **kwargs)
        indexers = {"incidence": inc, "wspd": wspd}
        if "phi" in lut.dims and phi is not None:
            indexers["phi"] = phi
        sigma0 = lut.interp({k: np.asarray(v, dtype=np.float64) for k, v in indexers.items()})
        sigma0.name = "sigma0_gmf"
        sigma0 = sigma0.assign_attrs(model=self.name, units=self.units)
        if all_scalar:
            return sigma0.item()
        return sigma0


def available_models(pol=None):
    """Table of registered models with alias resolution.

    Returns a pandas DataFrame indexed by model name with columns
    ['alias', 'pol', 'model'], reproducing the reference priority rule
    (models.py:453-498): among models sharing a short name, the lowest
    ``_priority`` owns the alias.
    """
    import pandas as pd

    rows = {}
    for name, model in Model._available_models.items():
        rows[name] = dict(
            short_name=model.short_name,
            priority=model._priority if model._priority is not None else np.inf,
            pol=model.pol,
            model=model,
        )
    df = pd.DataFrame.from_dict(rows, orient="index")
    if df.empty:
        return pd.DataFrame(columns=["alias", "pol", "model"])

    aliased = (
        df.sort_values("priority", ascending=True)
        .drop_duplicates("short_name")
        .rename(columns=dict(short_name="alias"))
        .drop(columns="priority")
    )
    rest = df.drop(aliased.index).drop(columns="priority").rename(columns=dict(short_name="alias"))
    rest["alias"] = None
    out = pd.concat([aliased, rest])
    if pol is not None:
        out = out[out.pol == pol]
    return out


def get_model(name):
    """Resolve a model by exact name or by alias (models.py:510-538)."""
    if isinstance(name, Model):
        return name
    models = Model._available_models
    if name in models:
        return models[name]
    table = available_models()
    match = table[table.alias == name]
    if len(match) == 1:
        return match.model.iloc[0]
    raise KeyError(f"model {name} not found")


def register_luts(topdir=None, topdir_cmod7=None):
    """Register deferred GMFs, netCDF LUTs under `topdir`, and CMOD7.

    Equivalent of the reference ``register_luts`` (models.py:541-568).
    """
    from xsarsea_tpu.models.gmf import GmfModel

    GmfModel.activate_gmfs_impl()
    if topdir is not None:
        from xsarsea_tpu.models.nc_lut import register_nc_luts

        register_nc_luts(topdir)
    if topdir_cmod7 is not None:
        from xsarsea_tpu.models.cmod7 import register_cmod7

        register_cmod7(topdir_cmod7)
