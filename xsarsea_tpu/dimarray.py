"""Lightweight labeled N-D array for the JAX xsarsea framework.

The reference library (umr-lops/xsarsea) operates on ``xarray.DataArray``
objects everywhere (e.g. ``src/xsarsea/windspeed/models.py:82-174``,
``src/xsarsea/gradients.py``).  This framework is JAX-first: the payload
of a :class:`DimArray` is a ``jax.Array`` (or numpy array on host), and the
object is registered as a JAX pytree so it can cross ``jit`` boundaries.

Only the slice of xarray behaviour actually used by the SAR ocean pipeline
is implemented: named dims, 1-D coordinates, attrs, ``sel/isel``, separable
multilinear ``interp``, broadcasting arithmetic, reductions, ``coarsen``,
``pad`` and friends.  Coordinates are host-side numpy arrays (they index the
data, they are never traced).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["DimArray", "DimDataset", "is_chunked", "blocked_coord_mean"]


def _as_index_array(c):
    return np.asarray(c)


def is_chunked(obj):
    """True for dask/zarr-style lazy chunked arrays.

    The protocol the whole package keys out-of-core behavior on: a
    ``.chunks`` attribute plus ``.ndim``/numpy-style first-axis slicing,
    and NOT an in-memory numpy/jax array. Single source of truth — used
    by DimArray's constructor, the xarray interop layer, the streamed
    inversion source and the detrend row streamer.
    """
    return (hasattr(obj, "chunks") and hasattr(obj, "ndim")
            and not isinstance(obj, (np.ndarray, jax.Array)))


def blocked_coord_mean(c, f=2):
    """Block-mean a 1-D coordinate: trim to a multiple of ``f``, average
    per block (the coarsen/R2/INTER_AREA coordinate rule — one shared
    implementation so injected and recomputed coords stay bit-identical)."""
    c = np.asarray(c, dtype=np.float64)
    n = (len(c) // f) * f
    return c[:n].reshape(-1, f).mean(axis=1)


class _CoordsAux:
    """Hashable wrapper for (dims, coords, attrs, name) used as pytree aux data."""

    __slots__ = ("dims", "coords", "attrs", "name")

    def __init__(self, dims, coords, attrs, name):
        self.dims = tuple(dims)
        self.coords = dict(coords)
        self.attrs = dict(attrs)
        self.name = name

    def _key(self):
        coord_key = tuple(
            (k, v.shape, v.dtype.str, v.tobytes()) for k, v in sorted(self.coords.items())
        )
        attr_key = tuple(sorted((k, repr(v)) for k, v in self.attrs.items()))
        return (self.dims, coord_key, attr_key, self.name)

    def __eq__(self, other):
        return isinstance(other, _CoordsAux) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


@jax.tree_util.register_pytree_node_class
class DimArray:
    """N-D array with named dims, 1-D coords and attrs. JAX pytree."""

    __slots__ = ("data", "dims", "coords", "attrs", "name")

    def __init__(self, data, dims=None, coords=None, attrs=None, name=None):
        if isinstance(data, DimArray):
            dims = dims or data.dims
            coords = coords if coords is not None else data.coords
            attrs = attrs if attrs is not None else data.attrs
            name = name or data.name
            data = data.data
        if not (isinstance(data, jax.Array) or isinstance(data, np.ndarray)):
            # chunked/lazy duck arrays (dask/zarr convention, is_chunked)
            # are stored as-is so out-of-core pipelines stay lazy;
            # anything else is coerced
            if not is_chunked(data):
                data = np.asarray(data)
        ndim = data.ndim
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(ndim))
        dims = tuple(dims)
        if len(dims) != ndim:
            raise ValueError(f"dims {dims} do not match data ndim {ndim}")
        self.data = data
        self.dims = dims
        self.coords = {}
        if coords:
            for k, v in coords.items():
                v = _as_index_array(v)
                if k in dims:
                    ax = dims.index(k)
                    if v.ndim != 1 or v.shape[0] != data.shape[ax]:
                        raise ValueError(
                            f"coord '{k}' of shape {v.shape} does not match dim size "
                            f"{data.shape[ax]}"
                        )
                self.coords[k] = v
        self.attrs = dict(attrs) if attrs else {}
        self.name = name

    # ---------------------------------------------------------------- pytree
    def tree_flatten(self):
        return (self.data,), _CoordsAux(self.dims, self.coords, self.attrs, self.name)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.data = children[0]
        obj.dims = aux.dims
        obj.coords = dict(aux.coords)
        obj.attrs = dict(aux.attrs)
        obj.name = aux.name
        return obj

    # ---------------------------------------------------------------- basics
    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def size(self):
        return self.data.size

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.data.shape))

    @property
    def values(self):
        """Host numpy copy of the data."""
        return np.asarray(self.data)

    def item(self):
        return np.asarray(self.data).item()

    def __array__(self, dtype=None):
        arr = np.asarray(self.data)
        return arr.astype(dtype) if dtype is not None else arr

    def __getattr__(self, key):
        # coordinate access as attributes (xarray-style): lut.wspd, lut.phi...
        coords = object.__getattribute__(self, "coords")
        if key in coords:
            return coords[key]
        raise AttributeError(key)

    def __len__(self):
        return self.data.shape[0]

    def __repr__(self):
        coord_info = ", ".join(f"{k}: {len(v)}" for k, v in self.coords.items() if k in self.dims)
        return (
            f"<DimArray {self.name or ''}{dict(zip(self.dims, self.shape))} "
            f"dtype={self.dtype} coords=[{coord_info}]>"
        )

    def copy(self, data=None):
        return DimArray(
            self.data if data is None else data,
            dims=self.dims,
            coords=self.coords,
            attrs=self.attrs,
            name=self.name,
        )

    def astype(self, dtype):
        return self.copy(data=self.data.astype(dtype))

    def jnp(self):
        """Return data as a jnp array."""
        return jnp.asarray(self.data)

    def rename(self, name=None, **dim_renames):
        dims = tuple(dim_renames.get(d, d) for d in self.dims)
        coords = {dim_renames.get(k, k): v for k, v in self.coords.items()}
        return DimArray(self.data, dims=dims, coords=coords, attrs=self.attrs,
                        name=name or self.name)

    def assign_coords(self, **coords):
        new = dict(self.coords)
        for k, v in coords.items():
            new[k] = _as_index_array(v)
        return DimArray(self.data, dims=self.dims, coords=new, attrs=self.attrs, name=self.name)

    def assign_attrs(self, **attrs):
        new = dict(self.attrs)
        new.update(attrs)
        return DimArray(self.data, dims=self.dims, coords=self.coords, attrs=new, name=self.name)

    def drop_coords(self, *names):
        coords = {k: v for k, v in self.coords.items() if k not in names}
        return DimArray(self.data, dims=self.dims, coords=coords, attrs=self.attrs, name=self.name)

    # ------------------------------------------------------------- selection
    def _axis(self, dim):
        try:
            return self.dims.index(dim)
        except ValueError:
            raise KeyError(f"dim '{dim}' not in {self.dims}")

    def isel(self, indexers=None, **kwargs):
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        data = self.data
        dims = list(self.dims)
        coords = dict(self.coords)
        # apply in reverse-axis order so axis numbers stay valid on drops
        items = sorted(indexers.items(), key=lambda kv: -self._axis(kv[0]))
        for dim, idx in items:
            ax = dims.index(dim)
            sl = [slice(None)] * data.ndim
            sl[ax] = idx
            data = data[tuple(sl)]
            if isinstance(idx, (int, np.integer)):
                dims.pop(ax)
                if dim in coords:
                    coords[dim] = np.asarray(coords[dim][idx])
            elif dim in coords:
                coords[dim] = coords[dim][idx]
        return DimArray(data, dims=dims, coords=coords, attrs=self.attrs, name=self.name)

    def sel(self, indexers=None, method=None, **kwargs):
        """Select by coordinate value. method='nearest' supported; exact otherwise."""
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        iidx = {}
        for dim, val in indexers.items():
            coord = self.coords[dim]
            val_arr = np.atleast_1d(np.asarray(val))
            if method == "nearest":
                pos = np.abs(coord[None, :] - val_arr[:, None]).argmin(axis=1)
            else:
                sorter = np.argsort(coord)
                # searchsorted returns len(coord) for values above the
                # max — clip so the allclose guard below raises the
                # contractual KeyError instead of an opaque IndexError
                ins = np.clip(np.searchsorted(coord, val_arr, sorter=sorter),
                              0, len(coord) - 1)
                pos = sorter[ins]
                if not np.allclose(coord[pos], val_arr):
                    raise KeyError(f"values {val} not found in coord '{dim}'")
            iidx[dim] = int(pos[0]) if np.isscalar(val) or np.asarray(val).ndim == 0 else pos
        return self.isel(iidx)

    def squeeze(self, dim=None):
        if dim is None:
            idx = {d: 0 for d, s in self.sizes.items() if s == 1}
        else:
            if self.sizes[dim] != 1:
                raise ValueError(f"cannot squeeze dim '{dim}' of size {self.sizes[dim]}")
            idx = {dim: 0}
        return self.isel(idx)

    def expand_dims(self, dim, axis=0):
        if isinstance(dim, (list, tuple)):
            out = self
            for d in reversed(dim):
                out = out.expand_dims(d, axis=axis)
            return out
        data = (jnp if isinstance(self.data, jax.Array) else np).expand_dims(self.data, axis)
        dims = list(self.dims)
        dims.insert(axis, dim)
        return DimArray(data, dims=dims, coords=self.coords, attrs=self.attrs, name=self.name)

    def transpose(self, *dims):
        if not dims:
            dims = self.dims[::-1]
        axes = [self._axis(d) for d in dims]
        data = self.data.transpose(axes)
        return DimArray(data, dims=dims, coords=self.coords, attrs=self.attrs, name=self.name)

    # ---------------------------------------------------------------- interp
    def interp(self, indexers=None, bounds_error=False, **kwargs):
        """Separable multilinear interpolation onto new 1-D coords per dim.

        Equivalent to ``xarray.DataArray.interp`` with linear method on a
        rectilinear grid (used by the reference to re-grid LUTs,
        ``models.py:142-167``). Out-of-range points yield NaN unless
        ``bounds_error=True`` in which case a ValueError is raised.
        """
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        out = self
        for dim, new_c in indexers.items():
            out = out._interp_1d(dim, np.asarray(new_c, dtype=np.float64), bounds_error)
        return out

    def _interp_1d(self, dim, new_c, bounds_error):
        ax = self._axis(dim)
        old_c = np.asarray(self.coords[dim], dtype=np.float64)
        if len(old_c) > 1 and old_c[0] > old_c[-1]:
            # descending coordinate (supported everywhere else — sel,
            # nearest_index): flip to ascending before searchsorted,
            # which would otherwise return 0/len for every point
            flipped = self.isel({dim: slice(None, None, -1)})
            return flipped._interp_1d(dim, new_c, bounds_error)
        if new_c.ndim == 1 and np.array_equal(old_c, new_c):
            # identity re-grid: skip the gather/lerp entirely (the
            # StackedGradients alignment hits this — windows_at is
            # propagated from the first instance, so the grids already
            # match). Also avoids 0*NaN pollution from NaN neighbors.
            coords = dict(self.coords)
            coords[dim] = new_c
            return DimArray(self.data, dims=self.dims, coords=coords,
                            attrs=self.attrs, name=self.name)
        if bounds_error and (new_c.min() < old_c.min() - 1e-12 or new_c.max() > old_c.max() + 1e-12):
            raise ValueError(f"interp out of bounds on dim '{dim}'")
        scalar = new_c.ndim == 0
        new_c = np.atleast_1d(new_c)
        i1 = np.clip(np.searchsorted(old_c, new_c), 1, len(old_c) - 1)
        i0 = i1 - 1
        denom = old_c[i1] - old_c[i0]
        w = (new_c - old_c[i0]) / np.where(denom == 0, 1.0, denom)
        oob = (new_c < old_c[0]) | (new_c > old_c[-1])

        xp = jnp if isinstance(self.data, jax.Array) else np
        data = xp.moveaxis(self.data, ax, 0)
        if not (np.issubdtype(np.dtype(data.dtype), np.floating)
                or np.issubdtype(np.dtype(data.dtype), np.complexfloating)):
            # integer/bool data: promote (like xarray) — casting the lerp
            # weights to the data dtype would truncate them all to 0
            data = data.astype(jnp.float32 if xp is jnp else np.float64)
        w_b = xp.asarray(w).reshape((-1,) + (1,) * (data.ndim - 1)).astype(data.dtype)
        res = data[i0] * (1 - w_b) + data[i1] * w_b
        if oob.any():
            mask = xp.asarray(oob).reshape((-1,) + (1,) * (data.ndim - 1))
            res = xp.where(mask, xp.asarray(np.nan, dtype=res.dtype), res)
        res = xp.moveaxis(res, 0, ax)
        coords = dict(self.coords)
        coords[dim] = new_c
        out = DimArray(res, dims=self.dims, coords=coords, attrs=self.attrs, name=self.name)
        if scalar:
            out = out.isel({dim: 0})
        return out

    # ------------------------------------------------------------ reductions
    def _reduce(self, fn, dim=None, **kw):
        if dim is None:
            return fn(self.data, **kw)
        dims = (dim,) if isinstance(dim, str) else tuple(dim)
        axes = tuple(self._axis(d) for d in dims)
        data = fn(self.data, axis=axes, **kw)
        new_dims = tuple(d for d in self.dims if d not in dims)
        coords = {k: v for k, v in self.coords.items() if k not in dims}
        return DimArray(data, dims=new_dims, coords=coords, attrs=self.attrs, name=self.name)

    def mean(self, dim=None):
        xp = jnp if isinstance(self.data, jax.Array) else np
        return self._reduce(xp.mean, dim)

    def nanmean(self, dim=None):
        xp = jnp if isinstance(self.data, jax.Array) else np
        return self._reduce(xp.nanmean, dim)

    def sum(self, dim=None):
        xp = jnp if isinstance(self.data, jax.Array) else np
        return self._reduce(xp.sum, dim)

    def min(self, dim=None):
        xp = jnp if isinstance(self.data, jax.Array) else np
        return self._reduce(xp.min, dim)

    def max(self, dim=None):
        xp = jnp if isinstance(self.data, jax.Array) else np
        return self._reduce(xp.max, dim)

    def argmax(self, dim):
        ax = self._axis(dim)
        xp = jnp if isinstance(self.data, jax.Array) else np
        data = xp.argmax(self.data, axis=ax)
        new_dims = tuple(d for d in self.dims if d != dim)
        coords = {k: v for k, v in self.coords.items() if k != dim}
        return DimArray(data, dims=new_dims, coords=coords, attrs=self.attrs, name=self.name)

    def coarsen_mean(self, factors, boundary="trim"):
        """Block-mean coarsening, like ``xr.coarsen(...).mean()`` with trim.

        Mirrors the behaviour used by the reference R2 pyramid
        (``gradients.py:714``): trailing rows/cols that do not fill a block
        are trimmed; coords are averaged per block.
        """
        if boundary != "trim":
            raise NotImplementedError("only boundary='trim'")
        xp = jnp if isinstance(self.data, jax.Array) else np
        data = self.data
        coords = dict(self.coords)
        for dim, f in factors.items():
            if f == 1:
                continue
            ax = self._axis(dim)
            n = (data.shape[ax] // f) * f
            sl = [slice(None)] * data.ndim
            sl[ax] = slice(0, n)
            data = data[tuple(sl)]
            new_shape = data.shape[:ax] + (n // f, f) + data.shape[ax + 1:]
            data = xp.mean(data.reshape(new_shape), axis=ax + 1)
            if dim in coords:
                coords[dim] = blocked_coord_mean(coords[dim], f)
        return DimArray(data, dims=self.dims, coords=coords, attrs=self.attrs, name=self.name)

    def pad(self, pad_widths, mode="wrap"):
        """Pad along named dims. pad_widths: {dim: int or (before, after)}."""
        xp = jnp if isinstance(self.data, jax.Array) else np
        widths = []
        for d in self.dims:
            w = pad_widths.get(d, 0)
            widths.append((w, w) if isinstance(w, int) else tuple(w))
        data = xp.pad(self.data, widths, mode=mode)
        coords = {k: v for k, v in self.coords.items()
                  if k not in pad_widths or (np.asarray(pad_widths[k]) == 0).all()}
        return DimArray(data, dims=self.dims, coords=coords, attrs=self.attrs, name=self.name)

    # ----------------------------------------------------------- arithmetic
    def broadcast_like(self, other):
        """Broadcast to the dims/shape of `other` (dims must be a subset)."""
        missing = [d for d in other.dims if d not in self.dims]
        out = self
        for d in missing:
            out = out.expand_dims(d, axis=0)
        out = out.transpose(*other.dims)
        xp = jnp if isinstance(out.data, jax.Array) or isinstance(other.data, jax.Array) else np
        data = xp.broadcast_to(out.data, other.shape)
        coords = dict(other.coords)
        coords.update({k: v for k, v in self.coords.items() if k not in other.dims})
        return DimArray(data, dims=other.dims, coords=coords, attrs=self.attrs, name=self.name)

    def _binary(self, other, fn):
        if isinstance(other, DimArray):
            a, b, dims, coords = _align(self, other)
            data = fn(a, b)
            return DimArray(data, dims=dims, coords=coords, attrs={}, name=self.name)
        data = fn(self.data, other)
        return DimArray(data, dims=self.dims, coords=self.coords, attrs={}, name=self.name)

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __radd__(self, other):
        return self._binary(other, lambda a, b: b + a)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binary(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binary(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._binary(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._binary(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._binary(other, lambda a, b: b / a)

    def __pow__(self, other):
        return self._binary(other, lambda a, b: a ** b)

    def __rpow__(self, other):
        return self._binary(other, lambda a, b: b ** a)

    def __neg__(self):
        return self.copy(data=-self.data)

    def __abs__(self):
        xp = jnp if isinstance(self.data, jax.Array) else np
        return self.copy(data=xp.abs(self.data))

    def __lt__(self, other):
        return self._binary(other, lambda a, b: a < b)

    def __le__(self, other):
        return self._binary(other, lambda a, b: a <= b)

    def __gt__(self, other):
        return self._binary(other, lambda a, b: a > b)

    def __ge__(self, other):
        return self._binary(other, lambda a, b: a >= b)

    # elementwise like the other comparisons (and xarray): without these,
    # ``da == flag`` silently degrades to identity comparison
    def __eq__(self, other):
        return self._binary(other, lambda a, b: a == b)

    def __ne__(self, other):
        return self._binary(other, lambda a, b: a != b)

    __hash__ = None  # elementwise __eq__ makes instances unhashable

    def _conform(self, arr):
        """Raw data of ``arr`` laid out to this array's dim order.

        A DimArray whose dims are a permutation of (a suffix of) ours is
        transposed by NAME first — positional xp.where/broadcasting on a
        transposed same-size mask would silently hit the wrong pixels.
        """
        if not isinstance(arr, DimArray):
            return arr
        if arr.dims != self.dims and set(arr.dims) <= set(self.dims):
            order = tuple(d for d in self.dims if d in arr.dims)
            if order != arr.dims:
                arr = arr.transpose(*order)
        return arr.data

    def where(self, cond, other=np.nan):
        xp = jnp if isinstance(self.data, jax.Array) else np
        return self.copy(data=xp.where(self._conform(cond), self.data,
                                       self._conform(other)))

    def fillna(self, value):
        xp = jnp if isinstance(self.data, jax.Array) else np
        if xp is np and np.issubdtype(self.data.dtype, np.complexfloating):
            mask = np.isnan(self.data)
        else:
            mask = xp.isnan(self.data) if not jnp.issubdtype(self.data.dtype, jnp.complexfloating) \
                else jnp.isnan(self.data.real) | jnp.isnan(self.data.imag)
        return self.copy(data=xp.where(mask, value, self.data))

    # helpers for getting per-dim coord spacing (used by gradients windows)
    def coord_spacing(self, dim):
        c = np.asarray(self.coords[dim], dtype=np.float64)
        d = np.diff(c)
        return float(d[0]) if len(d) else 1.0


class DimDataset:
    """Minimal named collection of DimArrays sharing coordinates.

    Stands in for the xarray.Dataset objects the reference gradients
    pipeline returns (e.g. gradients.py:120-125): variable access by key or
    attribute, shared isel/sel, concat along a new or existing dim.
    """

    def __init__(self, variables=None, attrs=None):
        self.variables = dict(variables or {})
        self.attrs = dict(attrs or {})

    def __getitem__(self, key):
        return self.variables[key]

    def __setitem__(self, key, value):
        self.variables[key] = value

    def __contains__(self, key):
        return key in self.variables

    def __getattr__(self, key):
        variables = object.__getattribute__(self, "variables")
        if key in variables:
            return variables[key]
        raise AttributeError(key)

    def __repr__(self):
        return f"<DimDataset vars={list(self.variables)}>"

    @property
    def dims(self):
        out = {}
        for v in self.variables.values():
            out.update(v.sizes)
        return out

    def isel(self, indexers=None, **kwargs):
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        return DimDataset(
            {
                k: v.isel({d: i for d, i in indexers.items() if d in v.dims})
                for k, v in self.variables.items()
            },
            attrs=self.attrs,
        )

    def sel(self, indexers=None, method=None, **kwargs):
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        for k, v in self.variables.items():
            bad = [d for d in indexers if d in v.dims and d not in v.coords]
            if bad:
                # silently skipping would leave this variable full-length
                # while others shrink — inconsistent sizes along the dim
                raise KeyError(
                    f"cannot label-select dim(s) {bad} on variable '{k}': "
                    "it has the dim but no coordinate (use isel)")
        return DimDataset(
            {
                k: v.sel({d: i for d, i in indexers.items() if d in v.coords},
                         method=method)
                for k, v in self.variables.items()
            },
            attrs=self.attrs,
        )

    def interp(self, indexers=None, **kwargs):
        indexers = dict(indexers or {})
        indexers.update(kwargs)
        return DimDataset(
            {
                k: v.interp({d: i for d, i in indexers.items() if d in v.dims})
                for k, v in self.variables.items()
            },
            attrs=self.attrs,
        )

    def expand_dims(self, dims):
        return DimDataset(
            {k: v.expand_dims(dims) for k, v in self.variables.items()},
            attrs=self.attrs,
        )

    def assign_coords(self, **coords):
        return DimDataset(
            {k: v.assign_coords(**{c: val for c, val in coords.items()})
             for k, v in self.variables.items()},
            attrs=self.attrs,
        )

    def mean(self, dim):
        return DimDataset(
            {k: v.mean(dim=[d for d in (dim if isinstance(dim, (list, tuple)) else [dim])
                            if d in v.dims]) if any(
                d in v.dims for d in (dim if isinstance(dim, (list, tuple)) else [dim])
            ) else v for k, v in self.variables.items()},
            attrs=self.attrs,
        )

    @staticmethod
    def concat(datasets, dim):
        """Concatenate datasets along ``dim`` (like ``xr.concat``).

        A dim already present in the variables concatenates along that
        axis (coords for it are concatenated too); a new dim stacks it
        in front.
        """
        import numpy as _np

        out = {}
        keys = datasets[0].variables.keys()
        for k in keys:
            arrs = [ds[k] for ds in datasets]
            first = arrs[0]
            xp = jnp if isinstance(first.data, jax.Array) else _np
            if dim in first.dims:
                ax = first.dims.index(dim)
                data = xp.concatenate([a.data for a in arrs], axis=ax)
                coords = dict(first.coords)
                if dim in coords:
                    coords[dim] = _np.concatenate(
                        [_np.asarray(a.coords[dim]) for a in arrs])
                out[k] = DimArray(data, dims=first.dims, coords=coords,
                                  attrs=first.attrs, name=first.name)
            else:
                data = xp.stack([a.data for a in arrs], axis=0)
                out[k] = DimArray(data, dims=(dim,) + first.dims,
                                  coords=first.coords, attrs=first.attrs,
                                  name=first.name)
        return DimDataset(out, attrs=datasets[0].attrs)


def _align(a: DimArray, b: DimArray):
    """Broadcast two DimArrays xarray-style: union of dims, by name."""
    dims = list(a.dims) + [d for d in b.dims if d not in a.dims]

    def reshaped(x):
        order = [d for d in dims if d in x.dims]
        x = x.transpose(*order)
        shape = [x.sizes[d] if d in x.dims else 1 for d in dims]
        return x.data.reshape(shape)

    coords = dict(b.coords)
    coords.update(a.coords)
    return reshaped(a), reshaped(b), tuple(dims), coords
