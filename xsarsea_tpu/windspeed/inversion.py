"""Bayesian wind inversion from sigma0 — the framework's hot path.

JAX redesign of the reference inversion (xsarsea
``windspeed/windspeed.py:17-439``). The reference runs a
numba-guvectorized per-pixel loop over dask chunks; here the per-pixel
Bayesian cost minimization over the (wspd, phi) LUT grid is a jitted
program over pixel blocks, with the LUT resident on device. Pixel-level
data parallelism scales over a device mesh via ``jax.sharding`` (see
:mod:`xsarsea_tpu.parallel`).

Algorithm (per pixel, faithfully matching windspeed.py:183-282):

* copol: select the nearest-incidence LUT slice, minimize
  ``J = Jwind + Jsig`` over the (wspd, phi) grid with the ancillary-wind
  prior ``Jwind = ((u - u_anc)/2)^2 + ((v - v_anc)/2)^2`` and
  ``Jsig = ((lut_dB - sigma0_dB)/dsig_co)^2``; for symmetric (0..180°)
  LUTs resolve the ±phi ambiguity against the ancillary direction.
* crosspol: 1-D minimization over wspd of
  ``Jsig_cr + ((wspd - |wind_co|)/2)^2`` (the prior term only when a
  copol solution exists); direction taken from copol.
* NaN semantics: NaN incidence → all NaN; valid copol sigma0 with NaN
  ancillary → NaN; NaN encodes land/missing data throughout.

Execution modes (see :func:`invert_pixels`):

* ``mode='exact'`` — portable full-grid argmin in XLA (bit-matches the
  reference's np.argmin first-minimum tie rule in f64).
* ``mode='triton'`` — the band-bucketed Pallas kernel compiled through
  Triton (GPU, f32): pixels sharing an incidence band share one LUT
  slice, with the exact path's cost arithmetic and tie rule; the same
  grid node as ``'exact'`` in f32 up to rounding at exact cost ties.
  ``'triton_interpret'`` runs the kernel in interpreter mode (CPU tests).
* ``mode='auto'`` — :func:`resolve_mode`: ``'triton'`` on a GPU when a
  copol table is present, ``'exact'`` elsewhere.
"""

from __future__ import annotations

import copy
import logging
import warnings
from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from xsarsea_tpu.dimarray import DimArray, is_chunked
from xsarsea_tpu.interop import xarray_io
from xsarsea_tpu.models.base import get_model
from xsarsea_tpu.utils import timing

logger = logging.getLogger("xsarsea_tpu.windspeed")

__all__ = ["invert_from_model", "InversionTables", "prepare_tables"]

# cost-function constants (reference windspeed.py:139-141)
D_ANTENNA = 2.0
D_AZI = 2.0
DWSPD_FG = 2.0


@jax.tree_util.register_pytree_node_class
class InversionTables:
    """Device-resident LUT tables prepared for the inversion kernel.

    copol LUT is stored as (incidence, wspd, phi) in dB with precomputed
    wind-component grids; crosspol as (incidence, wspd) in dB. Registered
    as a JAX pytree so tables enter jitted programs as runtime buffers —
    never as trace-time constants embedded in the HLO.
    """

    _CO_FIELDS = ("co_lut", "co_inc", "co_wspd", "co_phi", "co_u", "co_v", "co_phir")
    _CR_FIELDS = ("cr_lut", "cr_inc", "cr_wspd")

    def tree_flatten(self):
        fields = (self._CO_FIELDS if self.has_co else ()) + (
            self._CR_FIELDS if self.has_cr else ()
        )
        children = tuple(getattr(self, f) for f in fields)
        aux = (self.has_co, self.has_cr, getattr(self, "phi_180", None),
               jnp.dtype(self.dtype).name, fields)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.has_co, obj.has_cr, phi_180, dtype_name, fields = aux
        if phi_180 is not None:
            obj.phi_180 = phi_180
        obj.dtype = jnp.dtype(dtype_name).type
        for f, c in zip(fields, children):
            setattr(obj, f, c)
        obj._device_full = None
        return obj

    def __init__(self, lut_co_db=None, lut_cr_db=None, dtype=jnp.float32):
        self.dtype = dtype
        self.has_co = lut_co_db is not None
        self.has_cr = lut_cr_db is not None
        # fields stay host-side (numpy). Device residency is explicit:
        # to_device() for the exact path, the kernel path's own packed
        # operands, and sharded device_put in the parallel path.
        np_dtype = np.dtype(jnp.dtype(dtype).name)

        if self.has_co:
            if np.ndim(lut_co_db.data) != 3:
                # mirror of the crosspol-slot diagnostic below: a 2-D
                # (phi-less, crosspol) LUT in the copol slot would
                # otherwise die on an opaque KeyError('phi')
                raise ValueError(
                    "copol model LUT must be 3-D (incidence, wspd, phi); "
                    f"got {np.shape(lut_co_db.data)} — was a crosspol "
                    "(phi-independent) model passed as the copol model?")
            # lut dims (incidence, wspd, phi)
            self.co_lut = np.ascontiguousarray(lut_co_db.data, dtype=np_dtype)
            self.co_inc = np.asarray(
                lut_co_db.coords["incidence"], dtype=np_dtype)
            wspd = np.asarray(lut_co_db.coords["wspd"], dtype=np.float64)
            phi = np.asarray(lut_co_db.coords["phi"], dtype=np.float64)
            self.co_wspd = wspd.astype(np_dtype)
            self.co_phi = phi.astype(np_dtype)
            # symmetric LUT detection (windspeed.py:152-156). NOTE: the
            # reference rule is also True for a full 0..360 span
            # (180 - 360 < 2), so 360-phi LUTs deliberately run through
            # the symmetric path too — characterized in
            # tests/test_inversion.py::test_phi_360_lut_characterization.
            self.phi_180 = bool((180.0 - (phi[-1] - phi[0])) < 2.0)
            phir = np.deg2rad(phi)
            self.co_u = (wspd[:, None] * np.cos(phir)[None, :]).astype(np_dtype)
            self.co_v = (wspd[:, None] * np.sin(phir)[None, :]).astype(np_dtype)
            self.co_phir = phir.astype(np_dtype)

        if self.has_cr:
            if np.ndim(lut_cr_db.data) != 2:
                # a phi-dependent (copol) model slipped into the crosspol
                # slot; fail with the actual mistake instead of a shape
                # unpack error deep in the kernel builders
                raise ValueError(
                    "crosspol model LUT must be 2-D (incidence, wspd); got "
                    f"{np.shape(lut_cr_db.data)} — was a copol "
                    "(phi-dependent) model passed as the crosspol model?")
            self.cr_lut = np.ascontiguousarray(lut_cr_db.data, dtype=np_dtype)
            self.cr_inc = np.asarray(lut_cr_db.coords["incidence"], dtype=np_dtype)
            self.cr_wspd = np.asarray(lut_cr_db.coords["wspd"], dtype=np_dtype)

        self._device_full = None
        self._invert_fn_cache = {}

    def _copy_with(self, **overrides):
        obj = object.__new__(InversionTables)
        obj.__dict__.update(self.__dict__)
        obj.__dict__.update(overrides)
        obj._device_full = None
        obj._invert_fn_cache = {}
        return obj

    def to_device(self):
        """All-fields device copy (cached) for the exact jit path."""
        if self._device_full is None:
            fields = (self._CO_FIELDS if self.has_co else ()) + (
                self._CR_FIELDS if self.has_cr else ())
            self._device_full = self._copy_with(
                **{f: jnp.asarray(getattr(self, f)) for f in fields})
        return self._device_full


@lru_cache(maxsize=32)
def _cached_tables(model_co_name, model_cr_name, dtype_name, kwargs_key):
    kwargs = dict(kwargs_key)
    lut_co = get_model(model_co_name).to_lut(units="dB", **kwargs) if model_co_name else None
    lut_cr = get_model(model_cr_name).to_lut(units="dB", **kwargs) if model_cr_name else None
    return InversionTables(lut_co, lut_cr, dtype=jnp.dtype(dtype_name).type)


def prepare_tables(model_co=None, model_cr=None, dtype=jnp.float32, **kwargs):
    """Build (and cache) InversionTables for the given models."""
    # list/ndarray kwargs (range overrides etc. — Model.to_lut accepts
    # them) must become tuples before entering the lru_cache key, the
    # same normalization to_lut itself applies (base.py _hashable)
    def _hashable(v):
        return tuple(v) if isinstance(v, (list, np.ndarray)) else v

    return _cached_tables(
        get_model(model_co).name if model_co is not None else None,
        get_model(model_cr).name if model_cr is not None else None,
        jnp.dtype(dtype).name,
        tuple(sorted((k, _hashable(v)) for k, v in kwargs.items())),
    )


# --------------------------------------------------------------- kernel core

def _nearest_index(axis, value):
    """First-minimum nearest index, matching np.argmin(|axis - v|)."""
    return jnp.argmin(jnp.abs(axis - value))


def _wrap_angle(a):
    """wrap to (-pi, pi], like np.angle of a unit complex."""
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))


def _copol_solution(tables: InversionTables, i_inc, s0_co_db, ma, mz, dsig_co):
    """Per-pixel copol cost minimization. Returns (wspd, phi_signed_rad)."""
    lut_inc = tables.co_lut[i_inc]  # (W, P)
    mz_eff = jnp.abs(mz) if tables.phi_180 else mz
    jwind = ((tables.co_u - ma) / D_ANTENNA) ** 2 + ((tables.co_v - mz_eff) / D_AZI) ** 2
    jsig = ((lut_inc - s0_co_db) / dsig_co) ** 2
    j = jwind + jsig
    flat_idx = jnp.argmin(j.reshape(-1))
    iw, ip = flat_idx // j.shape[-1], flat_idx % j.shape[-1]
    wspd = tables.co_wspd[iw]
    phir = tables.co_phir[ip]
    return wspd, _disambiguate_phi(tables, phir, ma, mz)


def _disambiguate_phi(tables: InversionTables, phir, ma, mz):
    """±phi ambiguity for symmetric LUTs: pick the sign closest to the
    ancillary direction (windspeed.py:234-245)."""
    if not tables.phi_180:
        return phir
    anc_ang = jnp.arctan2(mz, ma)
    d1 = jnp.abs(_wrap_angle(anc_ang - phir))
    d2 = jnp.abs(_wrap_angle(anc_ang + phir))
    return jnp.where(d1 <= d2, phir, -phir)


def _crosspol_solution(tables: InversionTables, i_inc_cr, s0_cr_db, dsig_cr, wspd_co):
    """Per-pixel crosspol 1-D cost minimization. Returns wspd_dual."""
    lut_inc = tables.cr_lut[i_inc_cr]  # (Wc,)
    jsig = ((lut_inc - s0_cr_db) / dsig_cr) ** 2
    jwind = ((tables.cr_wspd - wspd_co) / DWSPD_FG) ** 2
    has_co = ~jnp.isnan(wspd_co)
    j = jsig + jnp.where(has_co, jwind, 0.0)
    return tables.cr_wspd[jnp.argmin(j)]


def _invert_pixel(tables: InversionTables, inc, s0_co_db, s0_cr_db, dsig_cr,
                  anc_re, anc_im, dsig_co):
    """Single-pixel inversion; returns (co_re, co_im, dual_re, dual_im).

    Replicates the reference per-pixel kernel (windspeed.py:183-282)
    including the NaN guard ordering.
    """
    nan = jnp.asarray(jnp.nan, dtype=inc.dtype)
    if tables.has_co:
        i_inc = _nearest_index(tables.co_inc, inc)
        wspd_co, phi_co = _copol_solution(tables, i_inc, s0_co_db, anc_re, anc_im, dsig_co)
    else:
        wspd_co, phi_co = nan, nan
    return _postprocess_pixel(tables, inc, s0_co_db, s0_cr_db, dsig_cr,
                              anc_re, anc_im, wspd_co, phi_co)


def _postprocess_pixel(tables: InversionTables, inc, s0_co_db, s0_cr_db, dsig_cr,
                       anc_re, anc_im, wspd_co, phi_co, wspd_dual=None):
    """Masking + crosspol + NaN guards, shared by the XLA and kernel paths.

    (wspd_co, phi_co) is the raw copol solution; may be garbage when the
    pixel has no valid copol observation — it is masked here. When the
    crosspol solution was already computed (the kernel's crosspol
    epilogue), pass it as ``wspd_dual`` to skip the per-pixel row-gather
    minimization. Elementwise: works per pixel and on whole arrays.
    """
    nan = jnp.asarray(jnp.nan, dtype=inc.dtype)

    # --- copol validity
    if tables.has_co:
        co_valid = ~jnp.isnan(s0_co_db)
        wspd_co = jnp.where(co_valid, wspd_co, nan)
        phi_co = jnp.where(co_valid, phi_co, nan)

    co_re = wspd_co * jnp.cos(phi_co)
    co_im = wspd_co * jnp.sin(phi_co)

    # --- crosspol / dualpol
    if tables.has_cr:
        if wspd_dual is None:
            i_inc_cr = _nearest_index(tables.cr_inc, inc)
            wspd_dual = _crosspol_solution(tables, i_inc_cr, s0_cr_db, dsig_cr,
                                           wspd_co)
        phi_dual = jnp.where(~jnp.isnan(wspd_co), phi_co, 0.0)
        cr_valid = (~jnp.isnan(s0_cr_db)) & (~jnp.isnan(dsig_cr))
        dual_re = jnp.where(cr_valid, wspd_dual * jnp.cos(phi_dual), nan)
        dual_im = jnp.where(cr_valid, wspd_dual * jnp.sin(phi_dual), nan)
    else:
        dual_re, dual_im = nan, nan

    # --- NaN guards (windspeed.py:198-207): order matters.
    # guard 1: NaN incidence -> all NaN. guard 2: valid copol sigma0 but
    # NaN ancillary -> all NaN. The reference assigns the *real* np.nan on
    # guards (-> nan+0j) vs nan*1j (-> nan+nan.j) for missing copol.
    anc_nan = jnp.isnan(anc_re) | jnp.isnan(anc_im)
    guard = jnp.isnan(inc) | ((~jnp.isnan(s0_co_db)) & anc_nan)

    return (
        jnp.where(guard, nan, co_re),
        jnp.where(guard, 0.0, co_im),
        jnp.where(guard, nan, dual_re),
        jnp.where(guard, 0.0, dual_im),
    )


def _make_invert_fn(tables: InversionTables, chunk_size=8192):
    """Build the jitted flat-pixel inversion function for these tables.

    The LUT tables are passed as jit *arguments* (via the pytree-registered
    InversionTables fields), never captured as closure constants — closure
    capture would embed hundreds of MB of LUT literals into the HLO and
    blow up compile times. Pixels run in ``lax.map`` steps of
    ``chunk_size`` (at most the input, rounded up to 256): XLA fuses each
    step's per-pixel slice gather into the argmin reduction.
    """

    def invert_flat(tbl, inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im, dsig_co):
        n = inc.shape[0]
        chunk = min(chunk_size, -(-n // 256) * 256)
        pad = (-n) % chunk
        args = [jnp.pad(a, (0, pad), constant_values=np.nan)
                for a in (inc, s0_co_db, s0_cr_db, dsig_cr, anc_re, anc_im)]
        args = [a.reshape(-1, chunk) for a in args]

        pixel = lambda i, sc, sx, dc, ar, ai: _invert_pixel(
            tbl, i, sc, sx, dc, ar, ai, dsig_co
        )
        chunk_fn = jax.vmap(pixel)
        out = lax.map(lambda xs: chunk_fn(*xs), tuple(args))
        return tuple(o.reshape(-1)[:n] for o in out)

    jitted = jax.jit(invert_flat)
    # materialize at build time, NOT first call: run may be traced inside
    # an outer jit (_wrap_for_spec), and a trace-time to_device() would
    # store tracers in the tables' _device_full cache
    tbl_dev = tables.to_device()

    def run(*args):
        return jitted(tbl_dev, *args)

    return run


def _make_kernel_invert_fn(tables: InversionTables, interpret=False,
                           mesh=None, data_axis="data"):
    """Band-bucketed Pallas kernel pipeline (``mode="triton"``).

    Pixels are bucketed by nearest-incidence band, one kernel program per
    block sweeps its band's full (wspd, phi) slice and then the crosspol
    wspd axis (see :mod:`xsarsea_tpu.ops.pallas_inversion`), and the
    winners are scattered back to pixel order and post-processed by the
    same code as the exact path, so both return identical winds for
    identical grid nodes.

    With ``mesh``, the pipeline runs data-parallel under ``shard_map``:
    pixels sharded over ``data_axis``, LUT operands replicated, no
    collectives.
    """
    from xsarsea_tpu.ops.pallas_inversion import (
        BLOCK as block,
        NUM_STAGES,
        NUM_WARPS,
        TILE as tile,
        band_argmin,
        build_band_arrays,
        bucket_by_band,
        nearest_index_sorted,
    )

    if not tables.has_co:
        raise ValueError("the kernel path needs a copol table; use "
                         "mode='exact' for crosspol-only inversion")
    if jnp.dtype(tables.dtype) != jnp.float32:
        raise ValueError("the kernel path computes in float32; build the "
                         "tables with dtype=float32")
    n_inc, n_wspd, n_phi = np.shape(tables.co_lut)
    n_phi_pad = -(-n_phi // tile) * tile
    has_cr = tables.has_cr
    co_inc = np.asarray(tables.co_inc)
    operands = tuple(jnp.asarray(a) for a in build_band_arrays(
        tables.co_lut, tables.co_u, tables.co_v, tile,
        tables.cr_lut if has_cr else None,
        tables.cr_wspd if has_cr else None))
    grids = (jnp.asarray(tables.co_wspd), jnp.asarray(tables.co_phir),
             jnp.asarray(tables.cr_wspd if has_cr
                         else np.zeros(1, np.float32)))

    def invert_flat(operands, co_wspd, co_phir, cr_wspd, inc, s0_co_db,
                    s0_cr_db, dsig_cr, anc_re, anc_im, dsig_co):
        n = inc.shape[0]
        perm, band_of_block = bucket_by_band(
            nearest_index_sorted(co_inc, inc), n_bands=n_inc, block=block)
        valid = perm >= 0
        pidx = jnp.clip(perm, 0)
        mz = jnp.abs(anc_im) if tables.phi_180 else anc_im
        pix = jnp.stack([s0_co_db, anc_re * 0.5, mz * 0.5, s0_cr_db,
                         dsig_cr], axis=1)
        feats = jnp.where(valid[:, None], pix[pidx], jnp.nan)
        icr = (nearest_index_sorted(np.asarray(tables.cr_inc), inc)[pidx]
               if has_cr else jnp.zeros_like(perm))
        live = valid.reshape(-1, block).any(axis=1).astype(jnp.int32)
        # the sweep of each block starts at the wspd row of its mean
        # ancillary speed (only the speed of the kernel depends on it)
        speed = jnp.nanmean(jnp.hypot(feats[:, 1], feats[:, 2])
                            .reshape(-1, block), axis=1) * 2.0
        anchor = nearest_index_sorted(np.asarray(tables.co_wspd), speed) \
            * (n_phi_pad // tile)
        flat_s, cr_s = band_argmin(
            operands, co_wspd, jnp.reshape(dsig_co, (1,)).astype(jnp.float32),
            feats, icr, band_of_block, live, anchor, n_phi_pad=n_phi_pad,
            has_cr=has_cr, block=block, tile=tile, num_warps=NUM_WARPS,
            num_stages=NUM_STAGES, interpret=interpret)

        dest = jnp.where(valid, perm, n)

        def unbucket(x):
            return jnp.zeros((n,), x.dtype).at[dest].set(
                x, mode="drop", unique_indices=True)

        flat = unbucket(flat_s)
        wspd_co = co_wspd[flat // n_phi_pad]
        phi_co = _disambiguate_phi(tables, co_phir[flat % n_phi_pad],
                                   anc_re, anc_im)
        wspd_dual = cr_wspd[unbucket(cr_s)] if has_cr else None
        return _postprocess_pixel(tables, inc, s0_co_db, s0_cr_db, dsig_cr,
                                  anc_re, anc_im, wspd_co, phi_co,
                                  wspd_dual=wspd_dual)

    if mesh is None:
        jitted = jax.jit(invert_flat)
    else:
        from jax.sharding import PartitionSpec as P

        jitted = jax.jit(jax.shard_map(
            invert_flat, mesh=mesh,
            in_specs=(P(),) * 4 + (P(data_axis),) * 6 + (P(),),
            out_specs=(P(data_axis),) * 4,
            # pallas_call outputs carry no varying-axis annotation
            check_vma=False))

    def run(*args):
        return jitted(operands, *grids, *args)

    return run


def resolve_mode(mode, tables, platform=None):
    """Map ``mode="auto"`` to the inversion path for a device platform.

    ``"triton"`` (the band-bucketed Pallas kernel) on a GPU when a copol
    table is present, ``"exact"`` everywhere else. ``platform`` defaults
    to the default device's. Explicit modes are validated and returned.
    """
    if mode == "auto":
        if platform is None:
            platform = jax.devices()[0].platform
        return "triton" if platform == "gpu" and tables.has_co else "exact"
    if mode not in MODES:
        raise ValueError(f"unknown inversion mode '{mode}' "
                         f"(expected one of {MODES + ('auto',)})")
    return mode


#: inversion paths: the plain XLA full-grid argmin, the Pallas kernel
#: compiled through Triton, and the same kernel interpreted (CPU tests)
MODES = ("exact", "triton", "triton_interpret")


def _wrap_for_spec(fn, spec):
    """Adapt the canonical 6-stream invert fn to a :class:`_LazySource` spec.

    Reconstructs the canonical (inc, s0_co_db, s0_cr_db, dsig_cr, anc_re,
    anc_im, dsig_co) arguments from only the streams the source actually
    ships: missing streams become device-side NaN fills (bit-identical to
    shipping NaN arrays), a scalar dsig_cr broadcasts on device, and with
    ``device_db`` the sigma0 streams arrive linear and convert to dB here
    — inside the jit, where XLA fuses the elementwise log10 into the
    pipeline's first pass. See _LazySource for the wire-format rationale.
    """
    device_db, has_co, has_cr, dsig_scalar, has_anc, inc_mode = spec

    # Only the (cheap, elementwise) reconstruction is jitted here; the
    # base fn stays its own compiled program, whose LUT operands enter as
    # arguments (nesting it would capture them as HLO constants).
    @jax.jit
    def reconstruct(*args):
        it = iter(args)
        if inc_mode == "full":
            inc = next(it)
        else:
            vec, meta = next(it), next(it)
            inc = None  # needs the piece length — set from sigma0 below
        raw_co = next(it) if has_co else None
        raw_cr = next(it) if has_cr else None
        dsig = next(it)
        anc = (next(it), next(it)) if has_anc else None

        if inc is None:
            # reconstruct the flat-broadcast inc stream on device: same
            # f32 values a host broadcast would ship, zero wire bytes.
            # _LazySource guarantees a sigma0 stream exists in this mode.
            ref = raw_co if raw_co is not None else raw_cr
            idx = meta[0] + jnp.arange(ref.shape[0], dtype=jnp.int32)
            pos = idx % meta[1] if inc_mode == "sample" else idx // meta[1]
            inc = vec[pos]
        nanv = jnp.full(inc.shape, jnp.nan, dtype=inc.dtype)

        def db(x):
            if not device_db:
                return x
            return 10.0 * jnp.log10(x + jnp.asarray(1e-15, x.dtype))

        s0_co = db(raw_co) if has_co else nanv
        s0_cr = db(raw_cr) if has_cr else nanv
        if dsig_scalar:
            dsig = jnp.broadcast_to(dsig, inc.shape)
        anc_re, anc_im = anc if has_anc else (nanv, nanv)
        return inc, s0_co, s0_cr, dsig, anc_re, anc_im

    def wrapped(*args):
        return fn(*reconstruct(*args[:-1]), args[-1])

    return wrapped


def _get_invert_fn(tables, chunk_size, mode="exact", spec=None):
    # The compiled-closure cache lives ON the tables instance, so its
    # lifetime is tied to the tables it was built from (an id()-keyed
    # global dict can hand a stale closure to a new object that reuses a
    # garbage-collected id). The kernel path is unchunked: chunk_size
    # must not split its cache.
    cache = tables.__dict__.setdefault("_invert_fn_cache", {})
    key = (chunk_size if mode == "exact" else None, mode, spec)
    if key not in cache:
        if spec is not None:
            cache[key] = _wrap_for_spec(
                _get_invert_fn(tables, chunk_size, mode=mode), spec)
        elif mode == "exact":
            cache[key] = _make_invert_fn(tables, chunk_size)
        elif mode in ("triton", "triton_interpret"):
            cache[key] = _make_kernel_invert_fn(
                tables, interpret=mode == "triton_interpret")
        else:
            raise ValueError(f"unknown inversion mode '{mode}'")
    return cache[key]


# ------------------------------------------------------ streamed piece source

def _flat_slice(arr, shape, lo, hi):
    """Materialize flat row-major [lo, hi) of ``arr`` as a 1-D numpy array.

    Contiguous numpy arrays are sliced as zero-copy views. Everything else
    — non-contiguous views (broadcast dsig), and duck arrays with
    numpy-style first-axis slicing (dask.array, h5py/zarr datasets,
    np.memmap) — goes through a first-axis row slice covering [lo, hi), so
    only O(piece) elements are ever materialized on the host. This is the
    out-of-core boundary the reference implements with dask
    (windspeed.py:345-367).
    """
    if isinstance(arr, np.ndarray) and arr.flags.c_contiguous:
        return arr.reshape(-1)[lo:hi]
    rest = 1
    for s in shape[1:]:
        rest *= int(s)
    r0, r1 = lo // rest, -(-hi // rest)
    block = np.ascontiguousarray(np.asarray(arr[r0:r1])).reshape(-1)
    return block[lo - r0 * rest: hi - r0 * rest]


class _PreparedSource:
    """Piece source over flat, already-dB-converted arrays (invert_pixels)."""

    def __init__(self, np_dtype, inc, s0_co_db, s0_cr_db, dsig_cr, anc):
        self.np_dtype = np_dtype
        self.n = int(np.shape(inc)[0])
        anc = np.asarray(anc)
        self._arrs = (inc, s0_co_db, s0_cr_db, dsig_cr, anc.real, anc.imag)

    def piece(self, lo, hi):
        return [np.ascontiguousarray(a[lo:hi], dtype=self.np_dtype)
                for a in self._arrs]


class _LazySource:
    """Piece source running the reference's host prep slice-by-slice.

    The reference converts the whole scene upfront — f64 dB conversion
    with the 1e-15 clip (windspeed.py:126-130), complex128 ancillary,
    broadcast dsig_cr — peaking at ~6 full-scene f64 temporaries. Here
    every transform runs on the rows covering one [lo, hi) piece (same
    f64 math, so results are bit-identical), keeping host memory O(piece)
    and accepting lazy/chunked inputs that never fit in memory at once.
    ``s0_co``/``s0_cr``/``anc`` may be None (NaN streams); ``dsig_cr``
    may be a scalar.

    Wire format (``spec``): missing streams are never shipped — the jit
    wrapper synthesizes the NaN fills on device (bit-identical, zero
    bytes on the wire) — a scalar ``dsig_cr`` ships as one 0-d scalar
    instead of a broadcast full-scene stream, and a broadcastable
    incidence (scalar, ``(nx,)``/``(1, nx)`` sample vector, or
    ``(ny, 1)`` line vector — SAR incidence varies along range only)
    ships as the small vector + a (lo, divisor) pair, reconstructed on
    device by an index gather (bit-identical to a host broadcast;
    drops the 4 B/px inc stream). With ``device_db``
    set (the default of the f32 kernel path), sigma0 ships LINEAR and the
    ``10*log10(x + 1e-15)`` conversion runs inside the jitted pipeline:
    same bytes but the host log10 (the bulk of host prep) disappears.
    The input dB then differs from host-f64 prep at f32-ulp scale; on
    pixels whose cost surface has two near-equal minima, the argmin can
    land on the other one (a near-equal-cost solution). The exact path
    keeps host prep, preserving reference parity; pass
    ``device_db=False`` for strict cross-mode reproducibility.
    Dual-pol + scalar dsig: 24 -> 20 B/px; mono-pol copol: 24 -> 16.
    """

    def __init__(self, shape, np_dtype, inc, s0_co=None, s0_cr=None,
                 dsig_cr=0.1, anc=None, device_db=None):
        self.shape = tuple(int(s) for s in shape)
        self.np_dtype = np_dtype
        self.n = 1
        for s in self.shape:
            self.n *= s
        self.inc, self.s0_co, self.s0_cr = inc, s0_co, s0_cr
        self.dsig_cr, self.anc = dsig_cr, anc
        self.device_db = device_db

        # broadcastable incidence: SAR incidence varies along range only,
        # so scenes naturally carry a (nx,) sample vector (or a (ny, 1)
        # line vector / a scalar). Ship the SMALL vector once per piece
        # plus a (lo, divisor) tuple and reconstruct the full stream on
        # device with an index gather — bit-identical to broadcasting on
        # host (same f32 values), and it drops the 4 B/px inc stream from
        # the wire (dual-pol + scalar dsig: 20 -> 16 B/px).
        self.inc_mode = "full"
        self._inc_vec = None
        self._inc_div = 1
        inc_shape = None if inc is None else tuple(
            int(s) for s in np.shape(inc))
        if inc_shape is not None and inc_shape != self.shape:
            if inc_shape in ((), (1,)):
                self.inc_mode, self._inc_div = "sample", 1
            elif len(self.shape) == 2 and inc_shape in (
                    (self.shape[1],), (1, self.shape[1])):
                self.inc_mode, self._inc_div = "sample", self.shape[1]
            elif len(self.shape) == 2 and inc_shape == (self.shape[0], 1):
                self.inc_mode, self._inc_div = "line", self.shape[1]
            else:
                raise ValueError(
                    f"incidence shape {inc_shape} is neither the scene "
                    f"shape {self.shape} nor broadcastable to it as a "
                    "scalar, (nx,)/(1, nx) sample vector or (ny, 1) line "
                    "vector")
            if s0_co is None and s0_cr is None:
                raise ValueError(
                    "broadcastable incidence requires a sigma0 stream")
            if self.n >= 2 ** 31:  # flat index rides an i32 on the wire
                raise ValueError("broadcastable incidence supports scenes "
                                 "< 2**31 pixels; pass a full inc array")
            self._inc_vec = np.ascontiguousarray(
                np.asarray(inc, dtype=np.float64).reshape(-1))

    @property
    def n_header(self):
        """Leading piece entries that are not per-pixel streams (and so
        must never be tail-padded): the inc vector + its (lo, div)."""
        return 0 if self.inc_mode == "full" else 2

    @property
    def spec(self):
        return (bool(self.device_db), self.s0_co is not None,
                self.s0_cr is not None, np.ndim(self.dsig_cr) == 0,
                self.anc is not None, self.inc_mode)

    def _db(self, arr, lo, hi):
        if self.device_db:  # ship linear; log10 runs on device (f32)
            return np.ascontiguousarray(
                _flat_slice(arr, self.shape, lo, hi), dtype=self.np_dtype)
        x = _flat_slice(arr, self.shape, lo, hi).astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            x = 10.0 * np.log10(x + 1e-15)
        return np.ascontiguousarray(x, dtype=self.np_dtype)

    def piece(self, lo, hi):
        if self.inc_mode == "full":
            out = [np.ascontiguousarray(
                _flat_slice(self.inc, self.shape, lo, hi),
                dtype=self.np_dtype)]
        else:
            # small vector + (lo, divisor): device reconstructs the flat
            # inc stream as vec[(lo+i) % div] (sample; div == len(vec))
            # or vec[(lo+i) // div] (line; div == scene width)
            out = [np.ascontiguousarray(self._inc_vec, dtype=self.np_dtype),
                   np.asarray([lo, self._inc_div], dtype=np.int32)]
        if self.s0_co is not None:
            out.append(self._db(self.s0_co, lo, hi))
        if self.s0_cr is not None:
            out.append(self._db(self.s0_cr, lo, hi))
        if np.ndim(self.dsig_cr) == 0:  # 0-d scalar: broadcast on device
            out.append(np.asarray(float(np.asarray(self.dsig_cr)),
                                  dtype=self.np_dtype))
        elif tuple(np.shape(self.dsig_cr)) == self.shape:
            out.append(np.ascontiguousarray(
                _flat_slice(self.dsig_cr, self.shape, lo, hi),
                dtype=self.np_dtype))
        else:  # broadcastable shape (e.g. per-row): numpy view, O(piece) copy
            out.append(np.ascontiguousarray(
                _flat_slice(np.broadcast_to(
                    np.asarray(self.dsig_cr), self.shape), self.shape, lo, hi),
                dtype=self.np_dtype))
        if self.anc is not None:
            a = _flat_slice(self.anc, self.shape, lo, hi)
            out.append(np.ascontiguousarray(a.real, dtype=self.np_dtype))
            out.append(np.ascontiguousarray(
                a.imag if np.iscomplexobj(a) else np.zeros_like(a),
                dtype=self.np_dtype))
        return out


def _invert_source(tables: InversionTables, source, dsig_co=0.1,
                   chunk_size=8192, mode="auto", device_output=False,
                   piece_size=None):
    """Run the inversion over a piece source (see invert_pixels for modes).

    Large inputs stream in fixed-size pieces with THREE overlapped lanes:
    a prep worker slices + casts + host->device-transfers piece k+1, the
    main thread's (async-dispatched) kernels chew on piece k, and a fetch
    worker copies piece k-1's results device->host straight into the
    preallocated output arrays. Device residency and host temporaries
    both stay O(piece).

    ``device_output=True`` opts out of that residency bound BY DESIGN:
    the caller wants the full results as device arrays (downstream
    device-side consumption), so per-piece outputs accumulate on device
    (O(n) residency, ~16 B/px f32) and concatenate once. Use the default
    host output for scenes that don't fit device memory.
    """
    mode = resolve_mode(mode, tables)
    dtype = tables.dtype
    # f32 kernel path: ship linear sigma0 and convert to dB on device
    # (the exact path keeps the reference's host f64 prep for bit
    # parity). device_db=None means auto; an explicit False/True from
    # the constructor is respected. Auto-resolution is PER CALL, onto a
    # shallow copy — never stamped onto the caller's source, so one
    # source object reused across modes gets each mode's wire format
    # (an exact call after a kernel call must keep host f64 dB prep).
    if (isinstance(source, _LazySource) and source.device_db is None
            and mode != "exact"):
        source = copy.copy(source)
        source.device_db = True
    spec = getattr(source, "spec", None)
    fn = _get_invert_fn(tables, chunk_size, mode=mode, spec=spec)
    dsig_dev = jnp.asarray(dsig_co, dtype=dtype)
    n = source.n
    ctype = np.complex128 if dtype == jnp.float64 else np.complex64

    _PIECE = piece_size or (1 << 22)
    if n <= _PIECE + (_PIECE >> 1):
        piece = [jnp.asarray(a) for a in source.piece(0, n)]
        co_re, co_im, du_re, du_im = fn(*piece, dsig_dev)
        if device_output:
            return lax.complex(co_re, co_im), lax.complex(du_re, du_im)
        wind_co = np.empty(n, dtype=ctype)
        wind_dual = np.empty(n, dtype=ctype)
        wind_co.real, wind_co.imag = np.asarray(co_re), np.asarray(co_im)
        wind_dual.real, wind_dual.imag = np.asarray(du_re), np.asarray(du_im)
        return wind_co, wind_dual

    from concurrent.futures import ThreadPoolExecutor

    # leading piece entries that are NOT per-pixel streams (the vector-inc
    # header) must never be tail-padded
    n_header = getattr(source, "n_header", 0)

    def prep(lo):
        hi = min(lo + _PIECE, n)
        piece = source.piece(lo, hi)
        if hi - lo < _PIECE:  # pad the tail piece: one jit shape only
            piece = [np.pad(a, (0, _PIECE - (hi - lo)),
                            constant_values=np.nan)
                     if a.ndim and i >= n_header else a
                     for i, a in enumerate(piece)]
        return [jnp.asarray(a) for a in piece]

    offsets = list(range(0, n, _PIECE))

    if device_output:
        # device-resident results: accumulate per-piece outputs, one concat
        outs = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(prep, offsets[0])
            for i, lo in enumerate(offsets):
                piece = fut.result()
                if i + 1 < len(offsets):
                    fut = pool.submit(prep, offsets[i + 1])
                outs.append(fn(*piece, dsig_dev))
        co_re, co_im, du_re, du_im = (
            jnp.concatenate(parts)[:n] for parts in zip(*outs))
        return lax.complex(co_re, co_im), lax.complex(du_re, du_im)

    wind_co = np.empty(n, dtype=ctype)
    wind_dual = np.empty(n, dtype=ctype)

    def fetch(outs, lo, hi):
        co_re, co_im, du_re, du_im = outs
        m = hi - lo
        wind_co.real[lo:hi] = np.asarray(co_re)[:m]
        wind_co.imag[lo:hi] = np.asarray(co_im)[:m]
        wind_dual.real[lo:hi] = np.asarray(du_re)[:m]
        wind_dual.imag[lo:hi] = np.asarray(du_im)[:m]

    with ThreadPoolExecutor(max_workers=1) as prep_pool, \
            ThreadPoolExecutor(max_workers=1) as fetch_pool:
        fut = prep_pool.submit(prep, offsets[0])
        fetch_futs = []
        for i, lo in enumerate(offsets):
            piece = fut.result()
            if i + 1 < len(offsets):
                fut = prep_pool.submit(prep, offsets[i + 1])
            if i >= 2:  # bound in-flight results: device residency O(piece)
                fetch_futs[i - 2].result()
            fetch_futs.append(fetch_pool.submit(
                fetch, fn(*piece, dsig_dev), lo, min(lo + _PIECE, n)))
        for f in fetch_futs:
            f.result()
    return wind_co, wind_dual


def invert_pixels(tables: InversionTables, inc, s0_co_db, s0_cr_db, dsig_cr,
                  ancillary_wind, dsig_co=0.1, chunk_size=8192, mode="auto",
                  device_output=False, piece_size=None):
    """Invert flat pixel arrays against prepared tables.

    All inputs are 1-D arrays of the same length (sigma0 already in dB);
    ``ancillary_wind`` is complex (antenna convention). Returns
    (wind_co, wind_dual) complex arrays — numpy by default, or
    device-resident jax arrays with ``device_output=True`` (skips the
    device->host copy for pipelines that keep working on device).

    mode: 'exact' (XLA full-grid argmin), 'triton' (the band-bucketed
    Pallas kernel, f32 tables, GPU), 'triton_interpret' (the same kernel
    in interpreter mode, for CPU testing), or 'auto' (see
    :func:`resolve_mode`).
    """
    np_dtype = np.dtype(jnp.dtype(tables.dtype).name)
    source = _PreparedSource(np_dtype, inc, s0_co_db, s0_cr_db, dsig_cr,
                             ancillary_wind)
    return _invert_source(tables, source, dsig_co=dsig_co,
                          chunk_size=chunk_size, mode=mode,
                          device_output=device_output, piece_size=piece_size)


# ------------------------------------------------------------- public facade

def _to_numpy(x):
    if isinstance(x, DimArray):
        return np.asarray(x.data)
    return np.asarray(x)


def _raw_data(x):
    """Underlying data object WITHOUT materializing lazy/chunked arrays.

    Scalars and array-likes without an ``ndim`` (python floats, lists)
    are coerced to numpy so the piece slicer can subscript them.
    """
    if x is None:
        return None
    data = x.data if isinstance(x, DimArray) else x
    # python scalars have no ndim; numpy scalars (np.float64) have
    # ndim == 0 but are not sliceable — coerce both to 0-d ndarrays
    if not hasattr(data, "ndim") or (
            getattr(data, "ndim") == 0 and not isinstance(data, np.ndarray)):
        data = np.asarray(data)
    return data


_any_valid_dev = None


def _any_valid(x):
    """True when ``x`` holds at least one non-NaN value.

    Memory discipline: jax arrays reduce ON DEVICE (no d2h of the data);
    numpy arrays — including scene-sized memmaps — and lazy/chunked
    inputs scan in row blocks with early exit, so the typical
    (mostly-valid) case touches O(block) and never allocates a
    full-scene boolean temporary. Chunked sources materialize one row
    block at a time through the first-axis-slicing protocol; only a
    truly all-NaN input reads every block — the price of making the
    'copol inversion requires valid ancillary_wind' check as strict for
    lazy inputs as for eager ones.
    """
    if x is None:
        return False
    data = _raw_data(x)
    if is_chunked(data):
        rest = 1
        for s in data.shape[1:]:
            rest *= int(s)
        step = max(1, (1 << 22) // max(1, rest))
        for r0 in range(0, int(data.shape[0]), step):
            if np.any(~np.isnan(np.asarray(data[r0:r0 + step]))):
                return True
        return False
    if isinstance(data, jax.Array):
        global _any_valid_dev
        if _any_valid_dev is None:
            _any_valid_dev = jax.jit(lambda t: jnp.any(~jnp.isnan(t)))
        return bool(_any_valid_dev(data))
    data = np.asarray(data)
    if data.ndim == 0:
        return bool(~np.isnan(data))
    rest = 1
    for s in data.shape[1:]:
        rest *= int(s)
    step = max(1, (1 << 22) // max(1, rest))
    for r0 in range(0, data.shape[0], step):
        if np.any(~np.isnan(data[r0:r0 + step])):
            return True
    return False


@xarray_io
@timing(logger.debug)
def invert_from_model(
    inc,
    sigma0,
    sigma0_dual=None,
    /,
    ancillary_wind=None,
    dsig_co=0.1,
    dsig_cr=0.1,
    model=None,
    dtype=None,
    mode="auto",
    piece_size=None,
    device_db=None,
    **kwargs,
):
    """Invert sigma0 into wind speed (and direction) using GMF/LUT model(s).

    API-compatible with the reference ``invert_from_model``
    (windspeed.py:17-128): mono-pol (copol or crosspol) with a single
    model, or dual-pol with ``model=(model_co, model_cr)``. Returns complex
    wind (modulus = speed m/s, angle = direction in antenna convention) —
    a DimArray when inputs are DimArrays. Dual-pol returns
    ``(wind_co, wind_dual)`` where wind_dual takes copol where either
    speed < 5 m/s (windspeed.py:425-428).

    ``dtype``: computation precision; defaults to float64 on the CPU when
    x64 is enabled, float32 otherwise.

    ``inc`` may be the full scene array or broadcastable to it — a
    scalar, a ``(nx,)``/``(1, nx)`` per-sample vector, or a ``(ny, 1)``
    per-line vector (SAR incidence varies along range only). Vector
    incidence never ships a full-scene stream to the device: the flat
    stream is reconstructed on device, bit-identical to broadcasting on
    host and 4 B/px cheaper on the wire.

    Inputs may be lazy/chunked duck arrays (dask.array, zarr, h5py
    datasets, np.memmap — anything with ``shape`` and numpy-style
    first-axis slicing), including inside DataArrays/DimArrays: the scene
    is streamed through the device in ``piece_size``-pixel pieces
    (default 4M) and the host prep (f64 dB conversion, complex split,
    dtype cast — the reference's whole-scene prep, windspeed.py:126-130)
    runs per piece, so host memory stays O(piece) + O(outputs) no matter
    the scene size. This replaces the reference's dask chunk execution
    (windspeed.py:345-367).

    ``device_db``: where the dB conversion of linear sigma0 runs. The
    default (None = auto) ships linear f32 and converts on device in
    the kernel mode — fastest wire format, but on rare near-cost-tie
    pixels the retrieved wind can differ from ``mode="exact"`` by a few
    wspd grid steps (see ``_LazySource``). Pass ``False`` to keep the
    reference's host f64 dB prep in every mode.
    """
    if dtype is None:
        dtype = jnp.float64 if (jax.config.jax_enable_x64 and
                                jax.default_backend() == "cpu") else jnp.float32

    models = model if isinstance(model, tuple) else (model, None)
    models = tuple(get_model(m) if m is not None else None for m in models)

    template = next((v for v in (sigma0, inc) if isinstance(v, DimArray)), None)

    # raw (possibly lazy/chunked) data objects — the host prep (dtype
    # casts, dB conversion, complex split) runs per streamed piece inside
    # _LazySource, never on the whole scene at once
    raw_inc = _raw_data(inc)
    raw_s0 = _raw_data(sigma0)
    shape = tuple(np.shape(raw_s0))

    if sigma0_dual is None:
        # mono-pol: check pol compatibility when the input carries one
        pol = None
        if isinstance(sigma0, DimArray):
            pol_c = sigma0.coords.get("pol")
            if pol_c is not None and np.asarray(pol_c).size == 1:
                pol = str(np.asarray(pol_c).reshape(-1)[0])
        model_pol = models[0].pol
        if pol is None:
            warnings.warn(f"Unable to check sigma0 pol. Assuming {model_pol}")
        elif pol not in model_pol:
            raise ValueError(
                f"sigma0 pol is {pol}, and model {models[0].name} can only handle {model_pol}"
            )
        if models[0].iscopol:
            raw_s0_co, raw_s0_cr = raw_s0, None
            if not _any_valid(ancillary_wind):
                raise ValueError("copol inversion requires valid ancillary_wind")
        else:
            raw_s0_co, raw_s0_cr = None, raw_s0
            if _any_valid(ancillary_wind):
                warnings.warn(
                    "crosspol inversion is best without ancillary wind, "
                    "but using it as requested."
                )
            models = (None, models[0])
    else:
        raw_s0_co = raw_s0
        raw_s0_cr = _raw_data(sigma0_dual)

    tables = prepare_tables(
        models[0], models[1], dtype=dtype, **kwargs
    )

    np_dtype = np.dtype(jnp.dtype(dtype).name)
    source = _LazySource(
        shape, np_dtype, raw_inc,
        s0_co=raw_s0_co, s0_cr=raw_s0_cr,
        dsig_cr=_raw_data(dsig_cr), anc=_raw_data(ancillary_wind),
        device_db=device_db,
    )
    wind_co, wind_dual = _invert_source(
        tables, source, dsig_co=dsig_co, mode=mode, piece_size=piece_size,
    )
    wind_co = wind_co.reshape(shape)
    wind_dual = wind_dual.reshape(shape)

    def wrap(data, comment, model_names):
        if template is None:
            return data
        out = template.copy(data=data)
        out.attrs = {"comment": comment, "model": model_names}
        out.name = "windspeed_gmf"
        return out

    if sigma0_dual is None:
        if models[0] is not None:
            return wrap(
                wind_co,
                f"wind speed and direction inverted from model {models[0].name} "
                f"({models[0].pol})",
                models[0].name,
            )
        # mono crosspol: speed only
        out = np.abs(wind_dual)
        res = wrap(
            out,
            f"wind speed inverted from model {models[1].name} ({models[1].pol})",
            models[1].name,
        )
        if isinstance(res, DimArray):
            res.attrs["units"] = "m/s"
        return res

    # dual-pol merge (windspeed.py:425-428): take copol where either speed
    # < 5 m/s. In-place chunked over wind_dual — no third full-scene array.
    co_f, du_f = wind_co.reshape(-1), wind_dual.reshape(-1)
    for lo in range(0, co_f.shape[0], 1 << 22):
        hi = min(lo + (1 << 22), co_f.shape[0])
        co_c, du_c = co_f[lo:hi], du_f[lo:hi]
        take_co = (np.abs(co_c) < 5) | (np.abs(du_c) < 5)
        du_c[take_co] = co_c[take_co]
    merged = wind_dual
    co_out = wrap(
        wind_co,
        f"wind speed and direction inverted from model {models[0].name} "
        f"({models[0].pol})",
        models[0].name,
    )
    dual_out = wrap(
        merged,
        f"wind speed and direction inverted from model {models[0].name} "
        f"({models[0].pol}) and {models[1].name} ({models[1].pol})",
        f"{models[0].name} {models[1].name}",
    )
    return co_out, dual_out
