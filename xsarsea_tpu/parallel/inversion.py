"""Sharded wind inversion over a (data, model) device mesh.

Parallelism design (replacement of the reference's dask ``apply_gufunc``
chunk parallelism, windspeed.py:356-364):

* **data axis** — pixels are flat-sharded; each device inverts its shard
  against its LUT tables. No communication (embarrassingly parallel).
* **model axis** — the (wspd, phi) cost grid is sharded along phi: each
  device holds a phi-slab of the copol LUT, computes its local per-pixel
  (min, argmin) and the global winner is resolved with an ``all_gather``
  over the model axis plus a first-minimum tie-break — the collective is
  tiny ((n_model, chunk) floats), so the heavy cost evaluation stays fully
  local. Exact path only.

Implemented with ``jax.shard_map``; the same code runs on a virtual CPU
mesh for testing (see tests/test_sharding.py) and on multi-GPU hosts.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from xsarsea_tpu.windspeed.inversion import (
    D_ANTENNA,
    D_AZI,
    InversionTables,
    _disambiguate_phi,
    _nearest_index,
    _postprocess_pixel,
    resolve_mode,
)

__all__ = ["sharded_invert_pixels", "pad_tables_for_model_axis"]


def pad_tables_for_model_axis(tables: InversionTables, n_model: int):
    """Pad the copol phi dimension so it splits evenly over `n_model`.

    Padded LUT entries get a huge dB value so their cost never wins;
    padded phi/u/v entries are inert.
    """
    if not tables.has_co:
        return tables, 0  # crosspol-only: no copol grid to pad
    P_ = np.asarray(tables.co_phi).shape[0]
    pad = (-P_) % n_model if n_model > 1 else 0
    if pad == 0:
        return tables, P_
    # _copy_with resets the cached device copies (_device_full,
    # _invert_fn_cache) — a hand-rolled __dict__ copy would leave the
    # padded table pointing at the UNPADDED device LUTs
    out = tables._copy_with(
        co_lut=jnp.pad(tables.co_lut, ((0, 0), (0, 0), (0, pad)),
                       constant_values=1e19),
        co_u=jnp.pad(tables.co_u, ((0, 0), (0, pad))),
        co_v=jnp.pad(tables.co_v, ((0, 0), (0, pad))),
        co_phi=jnp.pad(tables.co_phi, (0, pad)),
        co_phir=jnp.pad(tables.co_phir, (0, pad)),
    )
    return out, P_


def _sharded_invert_pixels_kernel(tables, inc, s0_co_db, s0_cr_db, dsig_cr,
                                  ancillary_wind, mesh, dsig_co, mode):
    """Data-parallel kernel inversion over the mesh's 'data' axis."""
    from xsarsea_tpu.windspeed.inversion import _make_kernel_invert_fn

    cache = tables.__dict__.setdefault("_invert_fn_cache", {})
    # Mesh is hashable and compared by devices+axes — no id() reuse issues
    key = ("sharded", mode, mesh)
    if key not in cache:
        cache[key] = _make_kernel_invert_fn(
            tables, interpret=mode == "triton_interpret", mesh=mesh)
    fn = cache[key]

    n_data = mesh.shape["data"]
    n = np.shape(inc)[0]
    pad = (-n) % n_data
    dtype = tables.dtype
    anc = np.asarray(ancillary_wind)
    arrs = [
        jnp.asarray(np.pad(np.asarray(a, dtype=np.float64), (0, pad),
                           constant_values=np.nan), dtype=dtype)
        for a in (inc, s0_co_db, s0_cr_db, dsig_cr, anc.real, anc.imag)
    ]
    co_re, co_im, du_re, du_im = fn(*arrs, jnp.asarray(dsig_co, dtype))
    return _assemble(co_re, co_im, du_re, du_im, n, dtype)


def _local_copol_candidate(tables_shard, phi_offset, n_phi_local,
                           i_inc, s0_co_db, ma, mz, dsig_co):
    """Per-pixel (min cost, global flat argmin) over this device's phi slab."""
    lut_inc = tables_shard.co_lut[i_inc]  # (W, P_local)
    mz_eff = jnp.abs(mz) if tables_shard.phi_180 else mz
    # EXACT op order of the single-device _copol_solution: (u + v) + sig.
    # fp addition is not associative — a different summation order can
    # flip the argmin on <1-ulp near-ties and break sharded-vs-single
    # parity.
    jwind = (((tables_shard.co_u - ma) / D_ANTENNA) ** 2
             + ((tables_shard.co_v - mz_eff) / D_AZI) ** 2)
    jsig = ((lut_inc - s0_co_db) / dsig_co) ** 2
    j = jwind + jsig
    flat_local = jnp.argmin(j.reshape(-1))
    iw = flat_local // n_phi_local
    ip = flat_local % n_phi_local
    val = j.reshape(-1)[flat_local]
    return val, iw, ip + phi_offset


def sharded_invert_pixels(tables: InversionTables, inc, s0_co_db, s0_cr_db,
                          dsig_cr, ancillary_wind, mesh, dsig_co=0.1,
                          chunk_size=256, mode="exact"):
    """Dual-pol inversion of flat pixel arrays sharded over `mesh`.

    Pixel arrays are sharded over the 'data' axis; the copol LUT is sharded
    along phi over the 'model' axis (u/v/phi grids likewise); everything
    else is replicated. Returns complex (wind_co, wind_dual) numpy arrays
    like :func:`~xsarsea_tpu.windspeed.inversion.invert_pixels`.

    ``mode`` is resolved by
    :func:`~xsarsea_tpu.windspeed.inversion.resolve_mode` for the mesh's
    devices, except that a mesh with a model axis wider than 1 runs the
    exact path. The kernel modes run the band-bucketed kernel per device
    — pure data parallelism with LUT operands replicated and zero
    collectives; they require a 1-wide 'model' axis (the kernel owns its
    grid blocking).
    """
    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]

    if mode == "auto" and n_model != 1:
        mode = "exact"
    mode = resolve_mode(mode, tables, mesh.devices.flat[0].platform)
    if mode != "exact":
        if n_model != 1:
            raise ValueError(
                f"mode='{mode}' shards data only; use a mesh with model=1")
        return _sharded_invert_pixels_kernel(
            tables, inc, s0_co_db, s0_cr_db, dsig_cr, ancillary_wind,
            mesh, dsig_co, mode)
    # caches live on the ORIGINAL tables object (the padded copy below is
    # rebuilt fresh, with empty caches, whenever padding applies)
    cache = tables.__dict__.setdefault("_invert_fn_cache", {})
    pad_key = ("padded_model", n_model)
    if pad_key not in cache:
        cache[pad_key] = pad_tables_for_model_axis(tables, n_model)
    tables, n_phi_true = cache[pad_key]
    n_phi_pad = np.asarray(tables.co_phi).shape[0] if tables.has_co else 0
    n_phi_local = n_phi_pad // n_model if tables.has_co else 0

    n = np.shape(inc)[0]
    lane = n_data * chunk_size
    pad = (-n) % lane
    dtype = tables.dtype

    anc = np.asarray(ancillary_wind)
    arrs = [
        np.pad(np.asarray(a, dtype=np.float64), (0, pad), constant_values=np.nan)
        for a in (inc, s0_co_db, s0_cr_db, dsig_cr, anc.real, anc.imag)
    ]
    arrs = [jnp.asarray(a, dtype=dtype) for a in arrs]

    # tables sharding: big copol grids split along phi, everything else
    # replicated
    def table_spec(t):
        specs = {}
        if t.has_co:
            specs.update(
                co_lut=P(None, None, "model"),
                co_u=P(None, "model"),
                co_v=P(None, "model"),
                co_phi=P("model"),
                co_phir=P("model"),
                co_inc=P(),
                co_wspd=P(),
            )
        if t.has_cr:
            specs.update(cr_lut=P(), cr_inc=P(), cr_wspd=P())
        fields = (t._CO_FIELDS if t.has_co else ()) + (t._CR_FIELDS if t.has_cr else ())
        children = tuple(specs[f] for f in fields)
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(t), children
        )

    tables_spec = table_spec(tables)
    # full (replicated) small arrays needed for decode after the argmin
    co_wspd_full = tables.co_wspd if tables.has_co else jnp.zeros((1,), dtype)
    co_phir_full = tables.co_phir if tables.has_co else jnp.zeros((1,), dtype)

    # compiled-program cache: jax.jit keys on function identity, so the
    # fresh closures below would force a full retrace + XLA compile on
    # EVERY call (a serving loop would pay tens of seconds per batch).
    # The key pins everything the closures bake in as trace-time state.
    fn_key = ("sharded_exact", mesh, chunk_size, float(dsig_co),
              n_phi_pad, n_phi_local, tables.has_co, tables.has_cr,
              str(dtype))
    if fn_key in cache:
        jitted = cache[fn_key]
        co_re, co_im, du_re, du_im = jitted(
            tables, co_wspd_full, co_phir_full, *arrs)
        return _assemble(co_re, co_im, du_re, du_im, n, dtype)

    def local_fn(tables_shard, co_wspd_full, co_phir_full, *pixel_shards):
        inc_s, s0co_s, s0cr_s, dsigcr_s, are_s, aim_s = pixel_shards
        model_idx = lax.axis_index("model")
        phi_offset = model_idx * n_phi_local

        def one_pixel(inc_p, s0_p, s0cr_p, dsigcr_p, are_p, aim_p):
            if tables.has_co:
                i_inc = _nearest_index(tables_shard.co_inc, inc_p)
                val, iw, ip_g = _local_copol_candidate(
                    tables_shard, phi_offset, n_phi_local,
                    i_inc, s0_p, are_p, aim_p, dsig_co)
                # resolve global argmin across the model axis:
                # min value first, lower flat index on ties (np.argmin rule)
                flat_g = iw * n_phi_pad + ip_g
                vals = lax.all_gather(val, "model")      # (n_model,)
                flats = lax.all_gather(flat_g, "model")  # (n_model,)
                best_val = jnp.min(vals)
                best_flat = jnp.min(jnp.where(vals == best_val, flats, 2 ** 30))
                iw_b = best_flat // n_phi_pad
                ip_b = best_flat % n_phi_pad
                wspd_co = co_wspd_full[iw_b]
                phi_co = _disambiguate_phi(tables_shard, co_phir_full[ip_b],
                                           are_p, aim_p)
            else:
                wspd_co = jnp.asarray(jnp.nan, dtype=inc_p.dtype)
                phi_co = wspd_co
            return _postprocess_pixel(tables_shard, inc_p, s0_p, s0cr_p,
                                      dsigcr_p, are_p, aim_p,
                                      wspd_co, phi_co)

        chunks = [a.reshape(-1, chunk_size) for a in pixel_shards]
        out = lax.map(lambda xs: jax.vmap(one_pixel)(*xs), tuple(chunks))
        return tuple(o.reshape(-1) for o in out)

    shard_fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(tables_spec, P(), P()) + (P("data"),) * 6,
        out_specs=(P("data"),) * 4,
        # outputs are replicated over 'model' by the all_gather+min combine;
        # the static checker cannot infer that
        check_vma=False,
    )

    jitted = jax.jit(shard_fn)
    cache[fn_key] = jitted
    co_re, co_im, du_re, du_im = jitted(tables, co_wspd_full, co_phir_full, *arrs)
    return _assemble(co_re, co_im, du_re, du_im, n, dtype)


def _assemble(co_re, co_im, du_re, du_im, n, dtype):
    """Device (re, im) pairs -> trimmed host complex arrays."""
    ctype = np.complex128 if dtype == jnp.float64 else np.complex64
    wind_co = (np.asarray(co_re, np.float64)
               + 1j * np.asarray(co_im, np.float64))[:n].astype(ctype)
    wind_dual = (np.asarray(du_re, np.float64)
                 + 1j * np.asarray(du_im, np.float64))[:n].astype(ctype)
    return wind_co, wind_dual
