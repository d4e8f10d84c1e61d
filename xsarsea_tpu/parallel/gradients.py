"""Spatially-sharded wind-streak pipeline over a device mesh.

Counterpart of the reference's ``dask.array.map_overlap``
stencil parallelism (reference gradients.py:649-667): instead of manual
overlap/halo bookkeeping, the whole local-gradients → windows → histogram
pipeline (:func:`xsarsea_tpu.gradients.streaks_histogram_core`) is jitted
over a :class:`jax.sharding.Mesh` with the image sharded along ``line``.
XLA SPMD inserts the halo exchanges for the Scharr/B2/B4 stencils and the
collective gathers for windows straddling shard boundaries — the kernels
themselves stay single-device code.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from xsarsea_tpu.gradients import hist_bin_form, streaks_histogram_core

__all__ = ["sharded_streaks_histogram"]

# jitted-program cache: jax.jit keys on function identity, so a fresh
# jit(partial(...)) per call would retrace + recompile the whole SPMD
# pipeline every time (the same defect fixed for sharded_invert_pixels)
_fn_cache = {}


def _get_fn(window, mesh):
    key = (int(window), mesh)
    if key not in _fn_cache:
        _fn_cache[key] = jax.jit(
            partial(streaks_histogram_core, window=int(window),
                    bin_form=hist_bin_form(mesh.devices.flat[0].platform)),
            out_shardings=NamedSharding(mesh, P()),
        )
    return _fn_cache[key]


def sharded_streaks_histogram(img, centers_l, centers_s, window,
                              angles_bins, mesh, data_axis="data"):
    """Streaks histograms with the image line-sharded over ``mesh``.

    ``img``: (line, sample) linear sigma0 (host or device array);
    ``centers_l``/``centers_s``: window-center indices in local-gradient
    pixels; ``window``: static window size in lg pixels; ``angles_bins``:
    histogram bin centers. Returns host numpy
    (weight (n_l, n_s, n_angles), used_ratio (n_l, n_s)), identical to the
    single-device :class:`~xsarsea_tpu.gradients.Gradients2D` result.
    """
    img_sh = jax.device_put(
        jnp.asarray(img), NamedSharding(mesh, P(data_axis, None)))
    cl = jnp.asarray(np.asarray(centers_l, np.int32))
    cs = jnp.asarray(np.asarray(centers_s, np.int32))
    bins = jnp.asarray(angles_bins)

    fn = _get_fn(window, mesh)
    weight, ratio = fn(img_sh, centers_l=cl, centers_s=cs, angles_bins=bins)
    n_l, n_s = len(np.asarray(centers_l)), len(np.asarray(centers_s))
    return (np.asarray(weight).reshape(n_l, n_s, -1),
            np.asarray(ratio).reshape(n_l, n_s))
