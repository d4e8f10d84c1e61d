"""Batch multi-scene inversion over a device mesh.

The reference has no multi-node backend (SURVEY §2.2: dask chunks only);
this is the device scale-out: scenes are treated as one concatenated
flat pixel stream — inversion is embarrassingly parallel per pixel, so
scenes need no alignment or padding relative to each other.

Memory discipline: scenes are never
materialized whole on host. Each scene becomes a lazy piece source
(first-axis slicing works for numpy, np.memmap, dask/zarr/h5py duck
arrays), the sources concatenate into one flat stream, and pieces of
``piece_size`` pixels flow through the device — host temporaries stay
O(piece) + O(outputs), the same discipline as the single-device
streamed path (``windspeed.inversion._invert_source``), which the
reference implements with dask (windspeed.py:345-367).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from xsarsea_tpu.parallel.inversion import sharded_invert_pixels
from xsarsea_tpu.windspeed.inversion import _flat_slice, _invert_source

__all__ = ["invert_scenes"]


class _SceneSource:
    """Flat [lo, hi) piece source over one already-dB scene dict.

    Streams the canonical 6 pixel streams (inc, s0_co_db, s0_cr_db,
    dsig_cr, anc_re, anc_im); every slice materializes O(piece) host
    bytes via :func:`_flat_slice` (lazy/chunked inputs included).
    ``dsig_cr`` may be a scalar or any shape broadcastable to the scene.
    """

    def __init__(self, scene, np_dtype):
        self.shape = tuple(int(s) for s in np.shape(scene["inc"]))
        self.np_dtype = np_dtype
        self.n = 1
        for s in self.shape:
            self.n *= s
        self._inc = scene["inc"]
        self._co = scene["sigma0_co_db"]
        self._cr = scene["sigma0_cr_db"]
        self._dsig = scene["dsig_cr"]
        self._anc = scene["ancillary_wind"]

    def piece(self, lo, hi):
        def sl(a):
            return np.ascontiguousarray(
                _flat_slice(a, self.shape, lo, hi), dtype=self.np_dtype)

        dsig = self._dsig
        if tuple(np.shape(dsig)) != self.shape:
            # broadcast view: _flat_slice's first-axis row slicing keeps
            # the materialized copy O(piece)
            dsig = np.broadcast_to(np.asarray(dsig), self.shape)
        anc = np.asarray(_flat_slice(self._anc, self.shape, lo, hi))
        return [
            sl(self._inc), sl(self._co), sl(self._cr), sl(dsig),
            np.ascontiguousarray(anc.real, dtype=self.np_dtype),
            np.ascontiguousarray(
                anc.imag if np.iscomplexobj(anc) else np.zeros_like(anc),
                dtype=self.np_dtype),
        ]


class _ConcatSource:
    """Concatenation of piece sources into one flat stream.

    A piece spanning a scene boundary concatenates the member pieces
    stream-wise; pieces inside one scene are zero-overhead delegation.
    """

    def __init__(self, sources):
        self.sources = sources
        self.np_dtype = sources[0].np_dtype
        self._bounds = np.concatenate(
            [[0], np.cumsum([s.n for s in sources])]).astype(np.int64)
        self.n = int(self._bounds[-1])

    def piece(self, lo, hi):
        i = int(np.searchsorted(self._bounds, lo, side="right")) - 1
        parts = []
        while lo < hi:
            s = self.sources[i]
            base = int(self._bounds[i])
            sub_hi = min(hi, base + s.n)
            parts.append(s.piece(lo - base, sub_hi - base))
            lo = sub_hi
            i += 1
        if len(parts) == 1:
            return parts[0]
        return [np.concatenate(cols) for cols in zip(*parts)]


def invert_scenes(tables, scenes, mesh=None, dsig_co=0.1, chunk_size=256,
                  mode="auto", piece_size=None):
    """Invert a batch of dual-pol scenes, streamed piece-by-piece.

    Parameters
    ----------
    tables : InversionTables
    scenes : sequence of dicts with keys ``inc``, ``sigma0_co_db``,
        ``sigma0_cr_db``, ``dsig_cr``, ``ancillary_wind`` — 2-D arrays of
        per-scene shape (shapes may differ between scenes; lazy/chunked
        duck arrays with first-axis slicing — np.memmap, dask, zarr —
        stream without ever materializing a whole scene on host).
    mesh : jax.sharding.Mesh with ('data', 'model') axes, or None for
        the single-device streamed path.
    mode : 'auto' (the default: see
        :func:`~xsarsea_tpu.windspeed.inversion.resolve_mode`), 'exact'
        (portable), or 'triton' / 'triton_interpret' for the per-device
        band-bucketed kernel (under a mesh this requires a 1-wide 'model'
        axis).
    piece_size : pixels per streamed piece (default 4M; under a mesh it
        rounds up to a whole number of data-shard lanes so every piece
        reuses one compiled program).

    Returns a list of ``(wind_co, wind_dual)`` complex arrays, one pair
    per scene, reshaped to each scene's shape. Host temporaries are
    O(piece) + O(outputs) regardless of total batch size.
    """
    np_dtype = np.dtype(jnp.dtype(tables.dtype).name)
    sources = [_SceneSource(s, np_dtype) for s in scenes]
    src = _ConcatSource(sources)
    n = src.n

    if mesh is None or int(np.prod(list(mesh.shape.values()))) == 1:
        co, dual = _invert_source(tables, src, dsig_co=dsig_co,
                                  chunk_size=chunk_size, mode=mode,
                                  piece_size=piece_size)
    else:
        piece = piece_size or (1 << 22)
        lane = int(mesh.shape["data"]) * chunk_size
        piece = max(lane, ((piece + lane - 1) // lane) * lane)
        ctype = np.complex128 if tables.dtype == jnp.float64 else np.complex64
        co = np.empty(n, dtype=ctype)
        dual = np.empty(n, dtype=ctype)
        for lo in range(0, n, piece):
            hi = min(lo + piece, n)
            streams = src.piece(lo, hi)
            if hi - lo < piece and n > piece:
                # pad the tail piece: ONE compiled shape for all pieces
                streams = [np.pad(a, (0, piece - (hi - lo)),
                                  constant_values=np.nan) for a in streams]
            anc = streams[4].astype(np.complex128)
            anc.imag = streams[5]
            pco, pdual = sharded_invert_pixels(
                tables, streams[0], streams[1], streams[2], streams[3], anc,
                mesh=mesh, dsig_co=dsig_co, chunk_size=chunk_size, mode=mode)
            co[lo:hi] = pco[:hi - lo]
            dual[lo:hi] = pdual[:hi - lo]

    out = []
    off = 0
    for s in sources:
        out.append((co[off:off + s.n].reshape(s.shape),
                    dual[off:off + s.n].reshape(s.shape)))
        off += s.n
    return out
