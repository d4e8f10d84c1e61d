"""GmfModel: analytic GMFs as jit/vmap-compiled XLA programs.

Replaces the reference numba compilation zoo (``gmfs.py:174-264`` compiles
each scalar GMF five ways: njit / vectorize / guvectorize / numpy
fallbacks). Here a registered GMF is a *pure, broadcasting jnp function*,
so one code path serves scalar calls, N-D broadcast evaluation and
on-device 3-D LUT generation — shape polymorphism comes from XLA, not from
a dispatch table. The user registration contract becomes "write a
jnp-traceable function" instead of "write numba-compilable scalar python".
"""

from __future__ import annotations

import logging

import numpy as np

import jax
import jax.numpy as jnp

from xsarsea_tpu.dimarray import DimArray, is_chunked
from xsarsea_tpu.models.base import Model, _grid

logger = logging.getLogger("xsarsea_tpu.models.gmf")

__all__ = ["GmfModel"]


def _float_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _cpu_device():
    return jax.devices("cpu")[0]


class _LazyGmfEval:
    """Lazy block-evaluated GMF result over chunked broadcast inputs.

    The reference keeps direct GMF evaluation on dask inputs lazy via
    ``da.broadcast_arrays`` + the numba ufunc (gmfs.py:293-316). The
    equivalent here is this duck chunked array: it satisfies the
    package-wide lazy protocol (``shape``/``ndim``/``dtype``/``chunks``
    + numpy-style first-axis slicing, see ``is_chunked``) and evaluates
    the jitted GMF on row blocks only when a block is requested — the
    full result never materializes unless the caller asks for it
    (``np.asarray``), and downstream streaming consumers (the inversion
    source, detrend, banded gradients) can pull it piece-wise.
    """

    _BLOCK_ELEMS = 1 << 22

    def __init__(self, eval_fn, raws, shape, dtype):
        self._eval_fn = eval_fn  # jitted broadcast eval over prepared args
        self._raws = raws  # (inc, wspd, phi) raw data objects (phi may be None)
        self.shape = tuple(int(s) for s in shape)
        self.ndim = len(self.shape)
        self.dtype = np.dtype(jnp.dtype(dtype).name)
        self._small = {}  # materialized non-full-shape chunked inputs
        row = 1
        for s in self.shape[1:]:
            row *= s
        rows = max(1, self._BLOCK_ELEMS // max(row, 1))
        n0 = self.shape[0] if self.shape else 1
        self.chunks = (tuple(
            min(rows, n0 - lo) for lo in range(0, n0, rows)
        ),) + tuple((s,) for s in self.shape[1:])

    def _block(self, raw, lo, hi):
        if raw is None:
            return None
        if is_chunked(raw) and tuple(raw.shape) == self.shape:
            return np.asarray(raw[lo:hi])
        if is_chunked(raw):  # broadcast input smaller than the result:
            # materialize once (it is the small operand) and reuse
            key = id(raw)
            if key not in self._small:
                # the lazy protocol guarantees first-axis slicing only
                self._small[key] = np.asarray(raw[0:raw.shape[0]])
            raw = self._small[key]
        return np.broadcast_to(np.asarray(raw), self.shape)[lo:hi]

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if not (idx and isinstance(idx[0], slice) and
                all(s == slice(None) for s in idx[1:])):
            raise IndexError(
                "lazy GMF result supports first-axis slicing only; "
                "np.asarray() it for random access")
        lo, hi, step = idx[0].indices(self.shape[0])
        if step != 1:
            raise IndexError("lazy GMF result does not support strided slices")
        blocks = [self._block(r, lo, hi) for r in self._raws]
        args = [jnp.asarray(b, dtype=self.dtype) if b is not None else None
                for b in blocks]
        return np.asarray(self._eval_fn(*args), dtype=self.dtype)

    def __array__(self, dtype=None, copy=None):
        out = np.empty(self.shape, dtype=self.dtype)
        lo = 0
        for rows in self.chunks[0]:
            out[lo:lo + rows] = self[lo:lo + rows]
            lo += rows
        return out if dtype is None else out.astype(dtype)


class GmfModel(Model):
    """Model backed by an analytic jnp function ``f(inc, wspd, phi)``."""

    _name_prefix = "gmf_"
    _priority = 3
    _deferred = []

    @classmethod
    def register(cls, name=None, pol=None, units="linear", defer=True, **kwargs):
        """Decorator registering a GMF function (reference gmfs.py:23-105).

        The decorated function must be jnp-traceable and broadcasting over
        its (inc, wspd[, phi]) arguments.

        >>> @GmfModel.register(pol="VH", units="linear", defer=False)
        ... def gmf_dummy(inc, wspd, phi=None):
        ...     a = 1e-4 - 4.5e-6 * inc
        ...     return a * wspd ** 1.39
        """

        def inner(func):
            gmf_name = name or func.__name__
            if not gmf_name.startswith(cls._name_prefix):
                raise ValueError(f"gmf function name must start with '{cls._name_prefix}'")
            wspd_range = kwargs.pop("wspd_range", None)
            if wspd_range is None:
                wspd_range = [0.2, 50.0] if len(set(pol)) == 1 else [3.0, 80.0]
            if defer:
                cls._deferred.append((func, gmf_name, wspd_range, pol, units, dict(kwargs)))
            else:
                cls.register_function(func, gmf_name, wspd_range=wspd_range, pol=pol,
                                      units=units, **kwargs)
            return func

        return inner

    @classmethod
    def register_function(cls, func, name, wspd_range=None, pol=None, units="linear", **kwargs):
        """Immediately register `func` under `name`. Idempotent re-registration."""
        return cls(name, func, wspd_range=wspd_range, pol=pol, units=units, **kwargs)

    @classmethod
    def activate_gmfs_impl(cls, gmfs_names=None, **kwargs):
        """Process deferred registrations (reference gmfs.py:112-125)."""
        for func, name, wspd_range, pol, units, reg_kwargs in cls._deferred:
            if gmfs_names is None or name in gmfs_names:
                cls.register_function(func, name, wspd_range=wspd_range, pol=pol, units=units,
                                      **{**reg_kwargs, **kwargs})

    def __init__(self, name, gmf_fn, wspd_range=None, pol=None, units=None, **kwargs):
        # probe: does the function accept/require phi, and with what period?
        # (reference probes the same way, gmfs.py:134-158). Probing runs
        # eagerly on the *host CPU device* — tiny scalar ops are not worth
        # an accelerator dispatch each.
        phi_range = kwargs.pop("phi_range", None)
        needs_phi = True
        with jax.default_device(_cpu_device()):
            try:
                val = gmf_fn(35.0, 0.2, None)
                _ = np.asarray(val, dtype=np.float64)
                needs_phi = False
            except (TypeError, ValueError):
                needs_phi = True

            if phi_range is None and needs_phi:
                # a phi-periodic-180 GMF is symmetric under phi -> -phi;
                # probe all four quadrants and require symmetry at EVERY
                # one (diff.max()). The reference's probe (gmfs.py:146-155)
                # takes min() over a set that includes phi=0, whose
                # difference is identically 0 — so it classifies every
                # phi-dependent GMF as 180-symmetric; all built-in GMFs
                # genuinely are (cos-series in phi), but an asymmetric
                # user GMF would silently get half its phi domain. max()
                # keeps the built-in classifications identical and makes
                # asymmetric GMFs correctly register as [0, 360].
                probe = np.array([0.0, 90.0, 180.0, 270.0])
                diff = np.abs(
                    np.asarray(gmf_fn(35.0, 0.2, probe))
                    - np.asarray(gmf_fn(35.0, 0.2, -probe))
                )
                phi_range = [0.0, 180.0] if diff.max() < 1e-15 else [0.0, 360.0]
            elif not needs_phi:
                phi_range = None

        super().__init__(
            name,
            units=units,
            pol=pol,
            wspd_range=wspd_range or [0.2, 50.0],
            phi_range=phi_range,
            **kwargs,
        )
        self._gmf_fn = gmf_fn
        self._needs_phi = needs_phi
        self._jit_broadcast = jax.jit(self._eval_broadcast)
        self._jit_grid = jax.jit(self._eval_grid)

    # ------------------------------------------------------------ evaluation
    def _eval_broadcast(self, inc, wspd, phi):
        if self._needs_phi:
            return self._gmf_fn(inc, wspd, phi)
        return self._gmf_fn(inc, wspd)

    def _eval_grid(self, inc, wspd, phi):
        """Outer-product grid evaluation → shape (inc, wspd[, phi])."""
        if self._needs_phi:
            return self._gmf_fn(inc[:, None, None], wspd[None, :, None], phi[None, None, :])
        return self._gmf_fn(inc[:, None], wspd[None, :])

    def __call__(self, inc, wspd, phi=None, broadcast=False, numba=None):
        """Evaluate the GMF.

        Dispatch mirrors the reference ``GmfModel.__call__``
        (gmfs.py:266-348): all-scalar → scalar; all-1D → outer-product
        DimArray over (incidence, wspd[, phi]); otherwise (or with
        ``broadcast=True``) → elementwise broadcast evaluation. ``numba``
        is accepted for API compatibility and ignored (XLA compiles here).
        """
        if self._needs_phi and phi is None:
            raise ValueError(
                f"model {self.name} ({self.pol}) requires a phi argument "
                "(wind direction relative to antenna, degrees)")
        vals = [v for v in (inc, wspd, phi) if v is not None]
        all_scalar = all(np.isscalar(v) for v in vals)
        all_1d = all(hasattr(v, "ndim") and v.ndim == 1 for v in vals)
        if any(hasattr(v, "ndim") and v.ndim > 1 for v in vals):
            broadcast = True

        dtype = _float_dtype()

        def prep(v):
            if v is None:
                return None
            data = v.data if isinstance(v, DimArray) else v
            return jnp.asarray(data, dtype=dtype)

        if broadcast:
            template = next((v for v in (inc, wspd, phi) if isinstance(v, DimArray)), None)
            raws = [v.data if isinstance(v, DimArray) else v
                    for v in (inc, wspd, phi)]
            if not self._needs_phi:
                raws[2] = None
            if any(is_chunked(v.data if isinstance(v, DimArray) else v)
                   for v in vals):
                # chunked/lazy inputs stay lazy (reference gmfs.py:293-316
                # via da.broadcast_arrays): block-evaluated on demand.
                # The output shape broadcasts over ALL provided inputs —
                # including phi for phi-independent models — to match the
                # eager branch below (which broadcasts over `vals`).
                shape = np.broadcast_shapes(
                    *(np.shape(v.data if isinstance(v, DimArray) else v)
                      for v in vals))
                out = _LazyGmfEval(self._jit_broadcast, tuple(raws),
                                   shape, dtype)
                if template is not None:
                    res = template.copy(data=out)
                    res.attrs = {"units": self.units}
                    return res
                return out
            out = self._jit_broadcast(prep(inc), prep(wspd),
                                      prep(phi) if self._needs_phi else None)
            # shapes come from the raw inputs: prep()-ing again here would
            # host->device-transfer every scene-sized array a second time
            out = jnp.broadcast_to(
                out, np.broadcast_shapes(
                    *(np.shape(v.data if isinstance(v, DimArray) else v)
                      for v in vals)))
            if template is not None:
                res = template.copy(data=out)
                res.attrs = {"units": self.units}
                return res
            return out

        if all_scalar:
            # scalar evaluation on the host CPU: dispatching one scalar to an
            # accelerator costs far more than the arithmetic
            with jax.default_device(_cpu_device()):
                args = (prep(inc), prep(wspd), prep(phi) if self._needs_phi else None)
                return float(self._eval_broadcast(*args))

        if all_1d:
            inc_j, wspd_j = prep(inc), prep(wspd)
            phi_j = prep(phi) if (self._needs_phi and phi is not None) else None
            if self._needs_phi and phi_j is None:
                raise ValueError(f"model {self.name} requires phi")
            data = self._jit_grid(inc_j, wspd_j, phi_j)

            def coord_of(v, default):
                if isinstance(v, DimArray):
                    return np.asarray(v.data)
                return np.asarray(default)

            dims = ["incidence", "wspd"]
            coords = {"incidence": coord_of(inc, inc), "wspd": coord_of(wspd, wspd)}
            if self._needs_phi:
                dims.append("phi")
                coords["phi"] = coord_of(phi, phi)
            return DimArray(data, dims=dims, coords=coords,
                            attrs={"units": self.units}, name="sigma0_gmf")

        raise ValueError("inputs must be all-scalar, all-1D, or broadcastable N-D")

    # ------------------------------------------------------------------ LUTs
    def _raw_lut(self, resolution="low", **kwargs):
        """Generate the LUT on-device over linspace grids (gmfs.py:350-395).

        Low resolution by default; ``Model.to_lut`` then up-interpolates to
        the requested resolution, matching the reference pipeline (which
        means high-res LUT values are *linear interps* of the low-res
        analytic evaluation — important for numerical parity).
        """
        if resolution not in ("low", "high", None):
            raise ValueError("resolution must be 'low', 'high' or None")
        if resolution is None:
            resolution = "low" if self.iscopol else "high"

        inc_step, wspd_step, phi_step = self._steps_for(resolution, **kwargs)
        inc = _grid(self.inc_range, inc_step)
        wspd = _grid(self.wspd_range, wspd_step)
        phi = _grid(self.phi_range, phi_step) if self.phi_range is not None else None

        # LUT construction is a one-off host-side task: evaluate on the CPU
        # device and keep the result as numpy, so the accelerator
        # is only handed the final packed table.
        with jax.default_device(_cpu_device()):
            lut = self.__call__(inc, wspd, phi)
        lut = lut.copy(data=np.asarray(lut.data))
        lut = lut.assign_attrs(resolution=resolution, units=self.units)
        return lut
