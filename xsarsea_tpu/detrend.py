"""sigma0 detrending ("roughness" / nice display) and the sarwing OWI reader.

`sigma0_detrend` divides out the incidence-angle trend predicted by a GMF at
a fixed (wind speed, direction), following the reference algorithm
(``detrend.py:8-68``): one GMF evaluation per column of the first image
line, normalized by its mean, broadcast-divided into sigma0. The GMF
evaluation and the divide run under jit on the device.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from xsarsea_tpu.dimarray import DimArray, is_chunked
from xsarsea_tpu.interop import xarray_io
from xsarsea_tpu.models.base import get_model
from xsarsea_tpu.utils import logger, timing

__all__ = ["sigma0_detrend", "read_sarwing_owi"]

# module-level jit: compiled once per (shape, dtype), shared across calls
_divide_ratio = jax.jit(lambda s0, r: s0 / r[None, :])


@xarray_io
@timing(logger=logger.info)
def sigma0_detrend(
    sigma0,
    inc_angle,
    wind_speed_gmf=10.0,
    wind_dir_gmf=45.0,
    model="gmf_cmod5n",
):
    """Compute detrended sigma0 from linear sigma0 and incidence (deg).

    Parameters mirror the reference ``sigma0_detrend`` (detrend.py:8-68);
    `sigma0` and `inc_angle` may be DimArrays with ('line', 'sample') dims
    or plain 2-D arrays (line, sample).
    """
    model = get_model(model)

    wspd = np.asarray(wind_speed_gmf, dtype=np.float64).reshape(-1)
    phi = np.asarray(wind_dir_gmf, dtype=np.float64).reshape(-1)
    if wspd.size != 1 or phi.size != 1:
        raise ValueError("wind_speed_gmf and wind_dir_gmf must be scalars (size 1)")

    is_dimarray = isinstance(sigma0, DimArray)
    raw_s0 = sigma0.data if is_dimarray else sigma0
    raw_inc = inc_angle.data if isinstance(inc_angle, DimArray) else inc_angle

    # only the FIRST line of incidence feeds the GMF (detrend.py:55);
    # lazy inputs materialize that one row
    inc_row_np = np.asarray(raw_inc[0:1])[0] if is_chunked(raw_inc) \
        else np.asarray(raw_inc)[0]
    lazy = is_chunked(raw_s0)

    gmf_fn = model._jit_broadcast if hasattr(model, "_jit_broadcast") else None

    if gmf_fn is not None:
        # the jitted ratio fn is cached ON the model (jax.jit keys on
        # function identity — a fresh closure per call would retrace and
        # recompile every sigma0_detrend in a processing loop); wspd/phi
        # enter as traced operands so different values reuse the program
        ratio_fn = model.__dict__.get("_detrend_ratio_fn")
        if ratio_fn is None:
            @jax.jit
            def ratio_fn(inc_row, w, p):
                sample = gmf_fn(inc_row, w.astype(inc_row.dtype),
                                p.astype(inc_row.dtype))
                return sample / jnp.nanmean(sample)

            model._detrend_ratio_fn = ratio_fn
        ratio = ratio_fn(jnp.asarray(inc_row_np), jnp.asarray(wspd[0]),
                         jnp.asarray(phi[0]))
    else:
        # tabulated model: evaluate through the LUT interp (host path)
        sample = model(inc_row_np, wspd, phi)
        sample_v = np.squeeze(np.asarray(
            sample.data if isinstance(sample, DimArray) else sample))
        ratio = jnp.asarray(sample_v / np.nanmean(sample_v))

    if lazy:
        # stream the broadcast divide row-block-wise: host memory is
        # O(output + block), never O(2x scene) — the reference runs this
        # lazily on dask-backed DataArrays (detrend.py:55-64)
        shape = tuple(int(s) for s in np.shape(raw_s0))
        ratio_np = np.asarray(ratio)
        out = np.empty(shape, dtype=ratio_np.dtype)
        rows = max(1, (1 << 22) // max(1, shape[1]))
        for r0 in range(0, shape[0], rows):
            r1 = min(r0 + rows, shape[0])
            out[r0:r1] = np.asarray(raw_s0[r0:r1]) / ratio_np[None, :]
        detrended_data = out
    else:
        detrended_data = _divide_ratio(jnp.asarray(raw_s0), ratio)

    if is_dimarray:
        out = sigma0.copy(data=detrended_data)
        out.attrs = dict(sigma0.attrs)
        out = out.assign_attrs(comment=f"detrended with model {model.name}")
        return out
    return detrended_data


def read_sarwing_owi(owi_file):
    """Read a sarwing OWI netCDF file.

    Counterpart of the reference ``read_sarwing_owi`` (detrend.py:71-93):
    with xarray installed, returns an ``xr.Dataset`` (reference parity);
    otherwise a plain ``dict`` keyed by variable name. Each variable is
    2-D over ('line', 'sample'), with the ``owiInversionTables_UV`` group
    merged in and line/sample coordinates assigned.
    """
    import h5py

    out = {}
    with h5py.File(owi_file, "r") as f:

        def load_group(grp):
            for key, dset in grp.items():
                if not hasattr(dset, "shape") or dset.ndim != 2:
                    continue
                if key in ("owiCalConstObsi", "owiCalConstInci"):
                    continue
                data = np.asarray(dset)
                out[key] = DimArray(
                    data,
                    dims=("line", "sample"),
                    coords={
                        "line": np.arange(data.shape[0]),
                        "sample": np.arange(data.shape[1]),
                    },
                    name=key,
                )

        load_group(f)
        if "owiInversionTables_UV" in f:
            load_group(f["owiInversionTables_UV"])

    try:  # reference parity: an xr.Dataset when xarray is available
        import xarray as xr
    except ImportError:
        return out
    from xsarsea_tpu.interop import to_dataset

    ds = to_dataset(out, xr.DataArray)
    return ds if ds is not None else out
