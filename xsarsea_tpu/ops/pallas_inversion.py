"""Pallas kernel (Triton route) for the copol + crosspol inversion argmin.

The plain XLA form of the inversion (``mode="exact"``) gathers, for every
pixel, the pixel's own nearest-incidence (wspd, phi) LUT slice (~360 KB
at the high-resolution grid) and reduces the Bayesian cost over it. This
kernel shares that slice between pixels instead:

1. Pixels are bucketed by their nearest-incidence LUT index (an exact,
   tie-rule-preserving nearest — see :func:`nearest_index_sorted`) into
   blocks of ``block`` pixels that all share ONE incidence slice
   (:func:`bucket_by_band`).
2. One program per block walks that slice in ``tile``-entry steps, in a
   loop inside the program (blocks run in no order on the GPU and carry
   nothing between each other), evaluating the cost for ``block x tile``
   (pixel, grid-entry) pairs per step with exactly the exact path's f32
   op sequence, and keeps a running (min, first step) per (pixel, lane).
   A step whose cost lower bound (from its precomputed LUT range and
   (u, v) box) cannot beat any pixel's best cost so far is skipped, and
   the sweep starts at the block's ancillary wind speed so that most
   steps are. Skipped steps cannot hold the minimum, so the result does
   not depend on the skipping. The final cross-lane reduction takes the
   lowest flat index among the lanes attaining the minimum: numpy's
   first-minimum tie rule over the (wspd-major, phi-minor) order.
3. The crosspol 1-D argmin runs as the epilogue, with the copol winner's
   wspd as its prior, for the same pixels.

The decode to wind values, the ±phi disambiguation and the NaN guards
stay in XLA (``windspeed/inversion.py``), shared with the exact path.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = [
    "band_argmin",
    "build_band_arrays",
    "bucket_by_band",
    "near_uniform_fit",
    "nearest_index_sorted",
    "nearest_index_near_uniform",
    "nearest_index_uniform",
]

_PAD_LUT = 1e19  # padded grid entries -> cost overflows to +inf, never chosen
_BIG_IDX = 2 ** 30


#: pixels per program (all share one incidence band), grid entries per
#: loop step (each wspd row is padded to whole steps, so a step never
#: straddles two rows and its (u, v) box stays one arc), and the Triton
#: launch parameters. Measured on an H100 at the high-resolution grid
#: (PERF.md, Findings): 32 x 32 with 4 warps beat every other block x step
#: from 16 x 16 to 128 x 128 and 2-8 warps; smaller steps bound the
#: costs more tightly and skip more, larger blocks skip less often.
BLOCK, TILE, NUM_WARPS, NUM_STAGES = 32, 32, 4, 2


def build_band_arrays(co_lut, co_u, co_v, tile, cr_lut=None, cr_wspd=None):
    """Tile-padded kernel operands (numpy, built once per table).

    Returns ``(lut (I, W*Pp), u_half (W*Pp,), v_half, l_box (I, 2, S),
    uv_box (4, S), cr_lut (Ic*Ec,), cr_w_half (Ec,))``, with each wspd
    row padded from P to Pp (a multiple of ``tile``) phi entries, S =
    W*Pp/tile steps and Ec the crosspol wspd count rounded up to a
    multiple of ``tile``. Padded LUT entries hold a huge dB value, so
    their cost overflows to +inf and never wins. u, v and the crosspol
    wspd are stored halved: halving is exact, so ``u/2 - ma/2`` rounds
    exactly like the exact path's ``(u - ma)/2``.

    ``l_box`` (per band: min, max of the LUT over each step's real
    entries) and ``uv_box`` (umin, umax, vmin, vmax, halved) bound every
    cost a step can produce; the kernel skips steps whose bound cannot
    beat the best cost found so far. The crosspol table is flat so the
    kernel can gather one row per pixel (a block shares its copol band,
    not necessarily its crosspol band).
    """
    lut = np.asarray(co_lut, np.float32)
    n_inc, n_w, n_p = lut.shape
    n_pp = -(-n_p // tile) * tile
    real = np.zeros((n_w, n_pp), bool)
    real[:, :n_p] = True
    lut_p = np.full((n_inc, n_w, n_pp), _PAD_LUT, np.float32)
    lut_p[:, :, :n_p] = lut
    u_h = np.zeros((n_w, n_pp), np.float32)
    v_h = np.zeros((n_w, n_pp), np.float32)
    u_h[:, :n_p] = np.asarray(co_u, np.float32) * 0.5
    v_h[:, :n_p] = np.asarray(co_v, np.float32) * 0.5
    steps = n_w * n_pp // tile
    real = real.reshape(steps, tile)

    def box(x, axis):
        big = np.float32(np.inf)
        return (np.min(np.where(real, x, big), axis=axis),
                np.max(np.where(real, x, -big), axis=axis))

    l_box = np.stack(box(lut_p.reshape(n_inc, steps, tile), -1), axis=1)
    uv_box = np.stack(box(u_h.reshape(steps, tile), -1)
                      + box(v_h.reshape(steps, tile), -1))
    out = (lut_p.reshape(n_inc, -1), u_h.reshape(-1), v_h.reshape(-1),
           l_box, uv_box)
    if cr_lut is None:
        return out + (np.zeros(tile, np.float32), np.zeros(tile, np.float32))
    cr = np.asarray(cr_lut, np.float32)
    ec = -(-cr.shape[1] // tile) * tile
    cr_f = np.full((cr.shape[0], ec), _PAD_LUT, np.float32)
    cr_f[:, :cr.shape[1]] = cr
    cr_wh = np.zeros(ec, np.float32)
    cr_wh[:cr.shape[1]] = np.asarray(cr_wspd, np.float32) * 0.5
    return out + (cr_f.reshape(-1), cr_wh)


def _div_rn(x, y):
    """IEEE round-to-nearest f32 division.

    Triton lowers ``/`` on f32 to the approximate ``div.full.f32``; the
    exact path's XLA division is correctly rounded, and the two must agree
    bit for bit for the argmin to pick the same node.
    """
    (q,) = plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;", args=[x, y], constraints="=f,f,f",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, x.dtype)])
    return q


def _first_argmin(m, a, block, tile):
    """Lowest flat index among the lanes attaining each pixel's minimum.

    ``m``/``a``: per (pixel, lane) running minimum and the step of its
    first attainment. NaN costs never win, so an all-NaN pixel returns 0
    (discarded by the NaN guards downstream, as the exact path's argmin
    of all-NaN is).
    """
    flat = a * tile + lax.broadcasted_iota(jnp.int32, (block, tile), 1)
    gmin = jnp.min(m, axis=1, keepdims=True)
    return jnp.min(jnp.where(m == gmin, flat, _BIG_IDX), axis=1)


# a step is skipped when its cost bound, shrunk by this factor, exceeds
# the pixel's best cost so far: the bound and the costs are both f32
# with a few ulps (~1e-6 relative) of rounding, so a skipped step can
# hold neither the minimum nor a tie with it
_BOUND_SLACK = 1.0 - 1e-5


def _band_argmin_kernel(band_ref, live_ref, k0_ref, dsig_ref, s0_ref, ma_ref,
                        mz_ref, s0cr_ref, dsigcr_ref, icr_ref, lut_ref, u_ref,
                        v_ref, lbox_ref, uvbox_ref, crlut_ref, crwh_ref,
                        wspd_ref, flat_ref, crbest_ref, *, block, tile,
                        n_steps, n_steps_cr, n_phi_pad, has_cr, interpret):
    div = jnp.divide if interpret else _div_rn

    # all-padding blocks (bucket tails) skip their work; their outputs
    # are never read
    @pl.when(live_ref[0] > 0)
    def _():
        band = band_ref[0]
        k0 = k0_ref[0]
        s0_v = s0_ref[...]
        ma_v = ma_ref[...]
        mz_v = mz_ref[...]
        s0, ma2, mz2 = s0_v[:, None], ma_v[:, None], mz_v[:, None]
        dsig_s = dsig_ref[0]
        dsig = jnp.broadcast_to(dsig_s, (block, tile))
        inv_dsig = 1.0 / dsig_s

        def cost(k):
            lut = lut_ref[band, pl.ds(k * tile, tile)][None, :]
            du = u_ref[pl.ds(k * tile, tile)][None, :] - ma2
            dv = v_ref[pl.ds(k * tile, tile)][None, :] - mz2
            q = div(lut - s0, dsig)
            # the exact path's order: (jwind_u + jwind_v) + jsig
            return (du * du + dv * dv) + q * q

        def bound(k):
            # per-pixel lower bound of the step's costs: distance of the
            # pixel to the step's LUT range and (u, v) box
            ds = jnp.maximum(jnp.maximum(lbox_ref[band, 0, k] - s0_v,
                                         s0_v - lbox_ref[band, 1, k]), 0.0)
            du = jnp.maximum(jnp.maximum(uvbox_ref[0, k] - ma_v,
                                         ma_v - uvbox_ref[1, k]), 0.0)
            dv = jnp.maximum(jnp.maximum(uvbox_ref[2, k] - mz_v,
                                         mz_v - uvbox_ref[3, k]), 0.0)
            q = ds * inv_dsig
            return (du * du + dv * dv) + q * q

        # visit steps from the anchor (the block's ancillary speed row)
        # upward, then from below it downward, so the best cost drops
        # early and most steps are skipped. Equal costs keep the lower
        # step, which with a lane's fixed offset is the lower flat index:
        # numpy's first-minimum rule holds in any visiting order.
        n_up = n_steps - k0

        def body(j, carry):
            k = jnp.where(j < n_up, k0 + j, k0 - 1 - (j - n_up))

            def visit(c):
                m, a, best = c
                jk = cost(k)
                better = (jk < m) | ((jk == m) & (k < a))
                return (jnp.where(better, jk, m), jnp.where(better, k, a),
                        jnp.minimum(best, jnp.min(jk, axis=1)))

            need = jnp.max(jnp.where(bound(k) * _BOUND_SLACK <= carry[2],
                                     1, 0))
            return lax.cond(need > 0, visit, lambda c: c, carry)

        m, a, _ = lax.fori_loop(0, n_steps, body, (
            jnp.full((block, tile), jnp.inf, jnp.float32),
            jnp.zeros((block, tile), jnp.int32),
            jnp.full((block,), jnp.inf, jnp.float32)))
        flat = _first_argmin(m, a, block, tile)
        flat_ref[...] = flat
        if not has_cr:
            return

        # crosspol 1-D argmin with the copol winner as prior; the prior
        # term only where a copol observation exists (exact path order:
        # jsig + where(has_co, jwind, 0))
        has_co = ~jnp.isnan(s0)
        wco2 = wspd_ref[flat // n_phi_pad][:, None] * 0.5
        s0cr = s0cr_ref[...][:, None]
        dsigcr = jnp.broadcast_to(dsigcr_ref[...][:, None], (block, tile))
        row = icr_ref[...][:, None] * (n_steps_cr * tile)
        lane = lax.broadcasted_iota(jnp.int32, (1, tile), 1)

        def cr_body(k, carry):
            m, a = carry
            lut = crlut_ref[row + (k * tile + lane)]
            q = div(lut - s0cr, dsigcr)
            dw = crwh_ref[pl.ds(k * tile, tile)][None, :] - wco2
            jk = q * q + jnp.where(has_co, dw * dw, 0.0)
            better = jk < m
            return jnp.where(better, jk, m), jnp.where(better, k, a)

        m, a = lax.fori_loop(0, n_steps_cr, cr_body, (
            jnp.full((block, tile), jnp.inf, jnp.float32),
            jnp.zeros((block, tile), jnp.int32)))
        crbest_ref[...] = _first_argmin(m, a, block, tile)


def band_argmin(operands, co_wspd, dsig_co, feats, icr, band_of_block, live,
                anchor, *, n_phi_pad, has_cr, block, tile, num_warps,
                num_stages, interpret=False):
    """Copol (and crosspol) argmin for band-bucketed pixel blocks.

    Parameters
    ----------
    operands : the tuple from :func:`build_band_arrays` as device arrays
        (crosspol ones are never read when ``has_cr`` is False).
    co_wspd : (W,) f32 copol wspd grid (the crosspol prior's decode).
    dsig_co : (1,) f32.
    feats : (n_slots, 5) f32 per slot — (s0_co_db, anc_re/2, mz/2,
        s0_cr_db, dsig_cr), with mz = |anc_im| for symmetric LUTs; NaN
        rows mark padding slots.
    icr : (n_slots,) i32 crosspol incidence row per slot.
    band_of_block, live, anchor : (n_blocks,) i32 — incidence band of
        each block, 0 for blocks holding no pixel, and the step the
        block's sweep starts from (any value gives the same result).

    Returns ``(flat_co, best_cr)``: (n_slots,) i32 copol grid index in
    the row-padded (wspd-major, phi-minor) order, ``iw * n_phi_pad +
    ip``, and crosspol wspd index per slot.
    """
    lut, u_h, v_h, l_box, uv_box, cr_lut, cr_w_half = operands
    n_blocks = band_of_block.shape[0]
    n_slots = n_blocks * block
    per_px = pl.BlockSpec((block,), lambda b: (b,))
    per_blk = pl.BlockSpec((1,), lambda b: (b,))

    def whole(a):
        return pl.BlockSpec(a.shape, lambda b: (0,) * a.ndim)

    ins = (band_of_block, live, anchor, dsig_co,
           *(feats[:, c] for c in range(5)), icr,
           lut, u_h, v_h, l_box, uv_box, cr_lut, cr_w_half, co_wspd)
    in_specs = ([per_blk] * 3 + [whole(dsig_co)] + [per_px] * 6
                + [whole(a) for a in ins[10:]])
    kernel = partial(_band_argmin_kernel, block=block, tile=tile,
                     n_steps=lut.shape[1] // tile,
                     n_steps_cr=cr_w_half.shape[0] // tile,
                     n_phi_pad=n_phi_pad, has_cr=has_cr, interpret=interpret)
    return pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=in_specs,
        out_specs=[per_px, per_px],
        out_shape=[jax.ShapeDtypeStruct((n_slots,), jnp.int32)] * 2,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="band_argmin",
    )(*ins)


def nearest_index_uniform(g0, step, n, values):
    """Gather-free nearest-index on a uniform grid (g0 + k*step, k<n).

    Candidate cell from a multiply + floor, then a 3-candidate
    first-minimum compare — same tie rule as :func:`nearest_index_sorted`.
    g0/step/n must be concrete Python numbers.
    """
    g0 = float(g0)
    step = float(step)
    # clip to [0, n-1] (not [1, n-2]) so 1- and 2-point grids stay valid:
    # with n=2, min>max clipping lets the dk=-1 candidate go to -1 and wrap
    k0 = jnp.clip(
        jnp.floor((values - g0) * jnp.asarray(1.0 / step, values.dtype)),
        0, n - 1,
    ).astype(jnp.int32)
    best_d = jnp.full_like(values, jnp.inf)
    best_k = jnp.zeros_like(k0)
    for dk in (-1, 0, 1):
        k = jnp.clip(k0 + dk, 0, n - 1)
        d = jnp.abs(values - (g0 + k.astype(values.dtype) *
                              jnp.asarray(step, values.dtype)))
        better = d < best_d
        best_d = jnp.where(better, d, best_d)
        best_k = jnp.where(better, k, best_k)
    return jnp.where(jnp.isnan(values), 0, best_k).astype(jnp.int32)


def near_uniform_fit(gnp):
    """(g0, step) endpoint fit of a grid, or None if not near-uniform.

    Near-uniform means every point sits within 0.4*step of the fit —
    loose enough to accept f32-cast linspace/arange coords (whose steps
    jitter at ulp scale; an EXACT-step check would send every f32 LUT
    axis to the binary search), tight enough that the true nearest index
    is always within +-1 of the fit's candidate cell.
    """
    gnp = np.asarray(gnp, dtype=np.float64)
    n = gnp.shape[0]
    if n < 2:
        return None
    step = (gnp[-1] - gnp[0]) / (n - 1)
    # negative steps are fine: descending grids use the same arithmetic
    # candidate (the old uniform path accepted them too)
    if step == 0 or not np.isfinite(step):
        return None
    ideal = gnp[0] + step * np.arange(n)
    if np.max(np.abs(gnp - ideal)) >= 0.4 * abs(step):
        return None
    return float(gnp[0]), float(step)


def nearest_index_near_uniform(grid, g0, step, values):
    """Nearest index on a near-uniform grid via candidate + local compare.

    The candidate cell comes from uniform-grid arithmetic (multiply +
    floor on the endpoint (g0, step) fit of ``near_uniform_fit``); the
    decision compares the TRUE grid values of the 3 candidate cells with
    a strict first-minimum update — so the result bit-matches
    ``np.argmin(|grid - v|)`` on the actual grid (including the
    lower-index tie rule the reference relies on, windspeed.py:212), for
    any grid whose points deviate from the fit by < 0.4*step. The 3
    candidates come from one row gather of a packed (n, 3) neighbour
    table.
    """
    n = grid.shape[0]
    ar = jnp.arange(n)
    packed = jnp.stack([grid[jnp.clip(ar - 1, 0, n - 1)], grid,
                        grid[jnp.clip(ar + 1, 0, n - 1)]], axis=1)
    k0 = jnp.clip(
        jnp.floor((values - g0) * jnp.asarray(1.0 / step, values.dtype)),
        0, n - 1,
    ).astype(jnp.int32)
    rows = packed[k0]  # (..., 3)
    best_d = jnp.full_like(values, jnp.inf)
    best_k = jnp.zeros_like(k0)
    for lane, dk in enumerate((-1, 0, 1)):
        k = jnp.clip(k0 + dk, 0, n - 1)
        d = jnp.abs(rows[..., lane] - values)
        better = d < best_d
        best_d = jnp.where(better, d, best_d)
        best_k = jnp.where(better, k, best_k)
    return jnp.where(jnp.isnan(values), 0, best_k).astype(jnp.int32)


def nearest_index_sorted(grid, values):
    """Exact nearest-index on a sorted grid, matching np.argmin(|grid - v|).

    Ties (equidistant neighbours) resolve to the lower index — numpy's
    first-minimum rule, which the reference relies on (windspeed.py:212).

    Near-uniform grids (the common case: LUT axes are f32/f64 casts of
    linspace/arange coords — note an f32 cast jitters the steps at ulp
    scale, so EXACT uniformity must not be required) take the
    candidate-plus-local-compare path of
    :func:`nearest_index_near_uniform`, which still compares true grid
    values; genuinely non-uniform grids binary-search.
    """
    grid = jnp.asarray(grid)
    n = grid.shape[0]

    def asc(g):
        i1 = jnp.clip(jnp.searchsorted(g, values), 1, n - 1)
        d_left = values - g[i1 - 1]
        d_right = g[i1] - values
        return jnp.where(d_left <= d_right, i1 - 1, i1)

    def desc(g):
        # binary-search on the reversed (ascending) grid; ties must still
        # resolve to the LOWER ORIGINAL index = higher reversed index
        rev = g[::-1]
        i1 = jnp.clip(jnp.searchsorted(rev, values), 1, n - 1)
        d_left = values - rev[i1 - 1]
        d_right = rev[i1] - values
        idx_rev = jnp.where(d_left < d_right, i1 - 1, i1)
        return (n - 1) - idx_rev

    if not isinstance(grid, jax.core.Tracer):
        gnp = np.asarray(grid, dtype=np.float64)
        fit = near_uniform_fit(gnp)
        if fit is not None:
            return nearest_index_near_uniform(grid, fit[0], fit[1], values)
        idx = desc(grid) if (n >= 2 and gnp[0] > gnp[-1]) else asc(grid)
    else:
        # traced grid: the sort order is unknown at trace time, and
        # running searchsorted on a descending array silently returns
        # garbage — evaluate BOTH orderings and select per the traced
        # order bit (one extra binary search; every in-package caller
        # closes over a concrete grid and never reaches this path)
        idx = jnp.where(grid[0] > grid[-1], desc(grid), asc(grid))
    # NaN values -> index 0 (result discarded by NaN guards downstream).
    # +-inf -> index 0 too: every |g[k] - inf| is inf, so np.argmin's
    # first-minimum rule picks 0, as the near-uniform path and the exact
    # mode's argmin do; the raw binary search would return n-1 for +inf
    # (ascending grids) or for -inf (descending).
    return jnp.where(jnp.isnan(values) | jnp.isinf(values), 0,
                     idx).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_bands", "block"))
def bucket_by_band(band, n_bands, block):
    """Group pixel indices by band into block-aligned buckets.

    Returns ``(perm, band_of_block)`` where ``perm`` has static length
    ``(ceil(N/block) + n_bands) * block`` (-1 marks padding slots) and
    lists pixel indices ordered band-by-band, each band padded to a
    multiple of ``block``; ``band_of_block[b]`` is the (single) band of
    block ``b``. The order within a band is unspecified: no pixel's
    result depends on its slot.

    Everything per-pixel here is a sort, a cumsum, or one scatter:
    per-band segment starts come from a ``searchsorted`` over the sorted
    keys and are spread back to pixel resolution by a telescoped
    sparse-add + cumsum, not by per-pixel gathers from per-band tables.
    """
    n = band.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    key_bits = max(int(np.ceil(np.log2(max(n_bands + 1, 2)))), 1)
    idx_bits = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    if key_bits + idx_bits <= 32:
        # the pixel index fits beside the key in one u32: sort the packed
        # (band << idx_bits | idx) alone. Keys are unique, so the order
        # is that of a stable pair sort.
        packed = ((band.astype(jnp.uint32) << idx_bits)
                  | iota.astype(jnp.uint32))
        (packed,) = lax.sort((packed,), is_stable=False, num_keys=1)
        ks = (packed >> idx_bits).astype(jnp.int32)
        order = (packed & jnp.uint32((1 << idx_bits) - 1)).astype(jnp.int32)
    else:
        ks, order = lax.sort((band.astype(jnp.int32), iota),
                             is_stable=False, num_keys=1)
    # lb[b] = first slot of band b in the sorted keys; counts via diff
    lb_ext = jnp.searchsorted(
        ks, jnp.arange(n_bands + 1, dtype=jnp.int32)).astype(jnp.int32)
    lb = lb_ext[:-1]
    counts = jnp.diff(lb_ext)
    pad_counts = ((counts + block - 1) // block) * block
    pad_offsets = (jnp.cumsum(pad_counts) - pad_counts).astype(jnp.int32)

    # dest[i] = pad_offsets[b_i] + (i - lb[b_i]) for the i-th sorted pixel
    delta = pad_offsets - lb
    ddelta = jnp.diff(delta, prepend=jnp.int32(0))
    sparse = jnp.zeros((n,), jnp.int32).at[lb].add(ddelta, mode="drop")
    dest = iota + jnp.cumsum(sparse)

    n_padded = ((n + block - 1) // block + n_bands) * block
    perm = jnp.full((n_padded,), -1, dtype=jnp.int32).at[dest].set(
        order, mode="drop", unique_indices=True
    )

    n_blocks = n_padded // block
    starts = pad_offsets // block
    inc = jnp.ones((n_bands,), jnp.int32).at[0].set(0)
    band_of_block = jnp.cumsum(
        jnp.zeros((n_blocks,), jnp.int32).at[starts].add(inc, mode="drop")
    )
    return perm, band_of_block
