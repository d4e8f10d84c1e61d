"""Pallas inversion kernel: CPU interpreter-mode equivalence tests.

The kernel compiles only for the GPU (Triton route); here it runs in
interpret mode against the plain XLA ``exact`` path. ``-m gpu`` tests
compile it for the card and skip without one.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xsarsea_tpu.models import get_model
from xsarsea_tpu.ops.pallas_inversion import (
    bucket_by_band,
    nearest_index_sorted,
)
from xsarsea_tpu.windspeed.inversion import InversionTables, invert_pixels

from _parity import assert_equal_modulo_pi_ties


def test_nearest_index_matches_argmin():
    grid = np.linspace(16.0, 66.0, 51)
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.uniform(10, 70, 500),
        grid[:5] + 0.5,          # exact midpoints: tie -> lower index
        np.array([np.nan, 15.0, 67.0]),
    ])
    got = np.asarray(nearest_index_sorted(jnp.asarray(grid), jnp.asarray(vals)))
    for v, g in zip(vals, got):
        if np.isnan(v):
            assert g == 0
        else:
            assert g == np.argmin(np.abs(grid - v)), (v, g)


def test_nearest_index_traced_grid_descending():
    """A TRACED grid argument (e.g. the grid passed through jit as an
    operand) must still handle descending order (review finding: the
    concrete-only detection left searchsorted running on a descending
    array, returning garbage indices)."""
    import jax

    asc = np.sort(np.concatenate([np.linspace(16.0, 66.0, 37),
                                  [20.1, 33.7, 50.2]]))  # non-uniform
    desc = asc[::-1].copy()
    rng = np.random.default_rng(5)
    vals = np.concatenate([rng.uniform(10, 70, 300), [np.nan]])

    f = jax.jit(lambda g, v: nearest_index_sorted(g, v))
    for grid in (asc, desc):
        got = np.asarray(f(jnp.asarray(grid), jnp.asarray(vals)))
        for v, g in zip(vals, got):
            if np.isnan(v):
                assert g == 0
            else:
                assert g == np.argmin(np.abs(grid - v)), (grid[0], v, g)


def test_bucket_by_band_structure():
    rng = np.random.default_rng(1)
    n, n_bands, block = 1000, 7, 64
    band = jnp.asarray(rng.integers(0, n_bands, size=n), dtype=jnp.int32)
    perm, band_of_block = bucket_by_band(band, n_bands=n_bands, block=block)
    perm = np.asarray(perm)
    bob = np.asarray(band_of_block)
    band_np = np.asarray(band)

    # every real pixel appears exactly once
    real = perm[perm >= 0]
    assert sorted(real.tolist()) == list(range(n))
    # every pixel lies in a block of its own band
    for b in range(len(bob)):
        blk = perm[b * block:(b + 1) * block]
        for p in blk[blk >= 0]:
            assert band_np[p] == bob[b]


@pytest.mark.parametrize("seed,kwargs", [
    # two LUT resolutions -> small-grid (32) and large-grid (128) tiles
    (0, dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)),
    (1, dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)),
    (0, dict(inc_step=1.0, wspd_step=0.2, phi_step=2.5)),
])
def test_pallas_matches_exact_mode(seed, kwargs):
    """Interpreter-mode kernel == exact XLA path, bit for bit, on
    GMF-consistent pixels with NaN pixels (same f32 tables)."""
    lut_co = get_model("gmf_cmod5n").to_lut(units="dB", **kwargs)
    lut_cr = get_model("gmf_s1_v2").to_lut(units="dB", **kwargs)
    tables = InversionTables(lut_co, lut_cr, dtype=jnp.float32)

    rng = np.random.default_rng(seed)
    n = 300
    inc = rng.uniform(17.0, 60.0, n)
    speed = rng.uniform(1.0, 28.0, n)
    direc = rng.uniform(-np.pi, np.pi, n)
    s0_co_db = 10 * np.log10(
        np.asarray(get_model("gmf_cmod5n")(inc, speed, np.abs(np.rad2deg(direc)),
                                           broadcast=True)) + 1e-15)
    s0_cr_db = 10 * np.log10(
        np.asarray(get_model("gmf_s1_v2")(inc, speed, broadcast=True)) + 1e-15)
    anc = (speed + rng.normal(0, 2, n)).clip(0.3) * np.exp(1j * direc)
    dsig_cr = rng.uniform(0.1, 1.0, n)
    # NaN pixels
    inc[0] = np.nan
    s0_co_db[1] = np.nan
    anc[2] = np.nan
    s0_cr_db[3] = np.nan

    co_e, dual_e = invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr, anc,
                                 mode="exact")
    co_p, dual_p = invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr, anc,
                                 mode="triton_interpret")

    # same cost arithmetic and tie rule: identical outputs, NaNs included
    np.testing.assert_array_equal(co_p, co_e)
    np.testing.assert_array_equal(dual_p, dual_e)


def test_pallas_nonuniform_incidence_grid():
    """NcLut-style non-uniform incidence axes route through the sorted
    nearest-index path; kernels must still match the exact mode."""
    kwargs = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    lut_co = get_model("gmf_cmod5n").to_lut(units="dB", **kwargs)
    lut_cr = get_model("gmf_s1_v2").to_lut(units="dB", **kwargs)

    def warp_inc(lut):
        # monotone non-uniform warp of the incidence coordinate
        inc = np.asarray(lut.coords["incidence"], np.float64)
        t = (inc - inc[0]) / (inc[-1] - inc[0])
        warped = inc[0] + (inc[-1] - inc[0]) * (t + 0.15 * t * (1 - t))
        coords = dict(lut.coords)
        coords["incidence"] = warped
        from xsarsea_tpu.dimarray import DimArray

        return DimArray(lut.data, dims=lut.dims, coords=coords,
                        attrs=lut.attrs)

    tables = InversionTables(warp_inc(lut_co), warp_inc(lut_cr),
                             dtype=jnp.float32)

    rng = np.random.default_rng(9)
    n = 300
    inc = rng.uniform(17.0, 60.0, n)
    s0_co_db = rng.uniform(-30.0, 0.0, n)
    s0_cr_db = rng.uniform(-40.0, -20.0, n)
    anc = rng.uniform(1, 25, n) * np.exp(1j * rng.uniform(-np.pi, np.pi, n))
    dsig_cr = rng.uniform(0.1, 1.0, n)
    inc[0] = np.nan

    co_e, dual_e = invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr, anc,
                                 mode="exact")
    co_p, dual_p = invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr, anc,
                                 mode="triton_interpret")
    for got, ref in ((co_p, co_e), (dual_p, dual_e)):
        assert_equal_modulo_pi_ties(got, ref)


def test_pallas_differing_crosspol_incidence_grid():
    """When the crosspol LUT has a DIFFERENT incidence axis than copol,
    the kernel gathers each pixel's own crosspol row — result still
    equals exact."""
    kwargs = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    lut_co = get_model("gmf_cmod5n").to_lut(units="dB", **kwargs)
    lut_cr = get_model("gmf_s1_v2").to_lut(units="dB", inc_step=0.7,
                                           wspd_step=0.5, phi_step=5.0)
    assert not np.array_equal(np.asarray(lut_co.coords["incidence"]),
                              np.asarray(lut_cr.coords["incidence"]))
    tables = InversionTables(lut_co, lut_cr, dtype=jnp.float32)

    rng = np.random.default_rng(13)
    n = 300
    inc = rng.uniform(17.0, 60.0, n)
    s0_co_db = rng.uniform(-30.0, 0.0, n)
    s0_cr_db = rng.uniform(-40.0, -20.0, n)
    anc = rng.uniform(1, 25, n) * np.exp(1j * rng.uniform(-np.pi, np.pi, n))
    dsig_cr = rng.uniform(0.1, 1.0, n)
    s0_cr_db[3] = np.nan

    co_e, dual_e = invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr,
                                 anc, mode="exact")
    co_p, dual_p = invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr,
                                 anc, mode="triton_interpret")
    for got, ref in ((co_p, co_e), (dual_p, dual_e)):
        m = ~np.isnan(np.abs(ref))
        np.testing.assert_array_equal(np.isnan(np.abs(got)), ~m)
        np.testing.assert_array_equal(got[m], ref[m])


def test_near_uniform_fit_accepts_f32_cast_grids():
    """f32-cast linspace/arange coords (ulp step jitter) MUST take the
    near-uniform path, not the binary search."""
    from xsarsea_tpu.ops.pallas_inversion import near_uniform_fit

    g64 = np.arange(16.0, 66.0 + 0.1, 0.1)
    g32 = g64.astype(np.float32).astype(np.float64)
    assert near_uniform_fit(g64) is not None
    assert near_uniform_fit(g32) is not None, "f32 ulp jitter rejected"
    # genuinely non-uniform grid is rejected
    bent = g64.copy()
    bent[10] += 0.06  # > 0.4 * step
    assert near_uniform_fit(bent) is None
    assert near_uniform_fit(np.array([3.0])) is None
    assert near_uniform_fit(np.array([1.0, 1.0])) is None


def test_nearest_index_true_grid_compare():
    """nearest_index_sorted matches np.argmin(|grid - v|) on the TRUE
    grid values — first-minimum tie rule included — on both the
    near-uniform fast path and the binary-search fallback."""
    from xsarsea_tpu.ops.pallas_inversion import nearest_index_sorted

    rng = np.random.default_rng(11)
    for grid in (
        np.arange(16.0, 66.0 + 0.1, 0.1).astype(np.float32),  # fast path
        np.sort(rng.uniform(16.0, 66.0, 73)).astype(np.float32),  # search
        np.arange(66.0, 15.9, -0.1).astype(np.float32),  # descending fast
        np.sort(rng.uniform(16.0, 66.0, 73))[::-1].copy().astype(
            np.float32),  # descending binary search
    ):
        vals = rng.uniform(14.0, 68.0, 4096).astype(np.float32)
        # exact midpoints (engineered ties -> lower index must win)
        mids = ((grid[:-1] + grid[1:]) / 2).astype(np.float32)
        vals = np.concatenate([vals, mids, grid.copy(), [np.nan]])
        got = np.asarray(nearest_index_sorted(jnp.asarray(grid),
                                              jnp.asarray(vals)))
        exp = np.argmin(np.abs(grid[None, :] - vals[:, None]), axis=1)
        exp[np.isnan(vals)] = 0
        np.testing.assert_array_equal(got, exp)


def test_pallas_phi_disambiguation_degenerate_ancillary():
    """Ancillary direction exactly 180 deg (plain real NEGATIVE
    ancillary_wind, e.g. quantized direction data) makes the reference's
    d1<=d2 angular comparison an exact fp tie broken only by
    wrap-rounding noise. The kernel path must reach the same
    disambiguation as the exact path — an algebraic shortcut (keep iff
    anc_im*sin(phi) >= 0) flips ~15% of such pixels to the conjugate
    wind."""
    lut_co = get_model("gmf_cmod5n").to_lut(
        units="dB", inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    tables = InversionTables(lut_co, None, dtype=jnp.float32)

    rng = np.random.default_rng(3)
    n = 2048
    inc = rng.uniform(17.0, 60.0, n)
    speed = rng.uniform(1.0, 28.0, n)
    direc = rng.uniform(0.0, 360.0, n)
    s0_co_db = 10 * np.log10(
        np.asarray(get_model("gmf_cmod5n")(inc, speed, direc,
                                           broadcast=True)) + 1e-15)
    # direction exactly 180 deg: anc_im == +0.0; sprinkle -0.0 and
    # exactly-0-deg pixels too (all make anc_im*sin(phi) == +-0.0)
    anc = -(speed + rng.normal(0, 2, n)).clip(0.3) + 0.0j
    anc[::7] = np.conj(anc[::7])      # imag = -0.0
    anc[::11] = -anc[::11]            # direction exactly 0 deg

    nanv = np.full(n, np.nan)
    co_e, _ = invert_pixels(tables, inc, s0_co_db, nanv, nanv, anc,
                            mode="exact")
    co_p, _ = invert_pixels(tables, inc, s0_co_db, nanv, nanv, anc,
                            mode="triton_interpret")
    assert_equal_modulo_pi_ties(co_p, co_e)
    # the imaginary sign (the disambiguation outcome) must agree
    # wherever the solution phi is not itself a degenerate pi-tie
    m = ~np.isnan(np.abs(co_e)) & (np.abs(np.asarray(co_e).imag) > 1e-4)
    np.testing.assert_array_equal(np.sign(np.asarray(co_p)[m].imag),
                                  np.sign(np.asarray(co_e)[m].imag))


def test_pallas_copol_only_tables():
    """Copol-only tables (has_cr=False) compile a kernel without the
    crosspol epilogue; it must match the exact path and keep the
    canonical 7-operand call signature (crosspol operands are never-read
    dummies)."""
    kwargs = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    lut_co = get_model("gmf_cmod5n").to_lut(units="dB", **kwargs)
    tables = InversionTables(lut_co, None, dtype=jnp.float32)
    assert not tables.has_cr

    rng = np.random.default_rng(7)
    n = 300
    inc = rng.uniform(17.0, 50.0, n)
    speed = rng.uniform(1.0, 28.0, n)
    direc = rng.uniform(-np.pi, np.pi, n)
    s0_co_db = 10 * np.log10(
        np.asarray(get_model("gmf_cmod5n")(inc, speed,
                                           np.abs(np.rad2deg(direc)),
                                           broadcast=True)) + 1e-15)
    anc = (speed + rng.normal(0, 2, n)).clip(0.3) * np.exp(1j * direc)
    nanv = np.full(n, np.nan)
    s0_co_db[1] = np.nan  # NaN sigma0 pixel must stay NaN

    co_e, dual_e = invert_pixels(tables, inc, s0_co_db, nanv, nanv, anc,
                                 mode="exact")
    co_p, dual_p = invert_pixels(tables, inc, s0_co_db, nanv, nanv, anc,
                                 mode="triton_interpret")
    assert np.isnan(np.abs(np.asarray(dual_p))).all()
    assert_equal_modulo_pi_ties(co_p, co_e)


def _kernel_scene(tables, n, seed):
    """GMF-consistent pixels over the tables' incidence span."""
    rng = np.random.default_rng(seed)
    inc = rng.uniform(18.0, 47.0, n)
    speed = rng.uniform(1.0, 28.0, n)
    direc = rng.uniform(-np.pi, np.pi, n)
    s0_co_db = 10 * np.log10(np.asarray(get_model("gmf_cmod5n")(
        inc, speed, np.abs(np.rad2deg(direc)), broadcast=True)) + 1e-15)
    s0_cr_db = 10 * np.log10(np.asarray(get_model("gmf_s1_v2")(
        inc, speed, broadcast=True)) + 1e-15)
    anc = (speed + rng.normal(0, 2, n)).clip(0.3) * np.exp(1j * direc)
    return inc, s0_co_db, s0_cr_db, rng.uniform(0.1, 1.0, n), anc


@pytest.mark.parametrize("n", [1, 63, 131])
def test_kernel_pads_partial_blocks(n):
    """Pixel counts that are not a multiple of the block (and bands that
    hold a single pixel) are padded to whole blocks; padding slots never
    leak into the results."""
    kwargs = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    tables = InversionTables(
        get_model("gmf_cmod5n").to_lut(units="dB", **kwargs),
        get_model("gmf_s1_v2").to_lut(units="dB", **kwargs),
        dtype=jnp.float32)
    args = _kernel_scene(tables, n, seed=n)
    co_e, dual_e = invert_pixels(tables, *args, mode="exact")
    co_p, dual_p = invert_pixels(tables, *args, mode="triton_interpret")
    np.testing.assert_array_equal(co_p, co_e)
    np.testing.assert_array_equal(dual_p, dual_e)


@pytest.mark.parametrize("anchor", [0, 1])
def test_kernel_exact_ties_take_first_minimum(anchor):
    """Engineered exact cost ties (duplicated LUT entries) resolve to the
    lowest (wspd-major, phi-minor) flat index across steps, whichever
    step the sweep starts from, like np.argmin; the crosspol epilogue
    likewise."""
    from xsarsea_tpu.ops.pallas_inversion import (BLOCK as block,
                                                  TILE as tile, band_argmin,
                                                  build_band_arrays)

    n_inc, n_w, n_p = 2, 2, 32   # one 32-entry step per wspd row
    assert tile == n_p
    lut = np.full((n_inc, n_w, n_p), -20.0, np.float32)
    u = np.zeros((n_w, n_p), np.float32)
    v = np.zeros((n_w, n_p), np.float32)
    # band 0: minimum at flat 5 and again at 37 (second step)
    lut[0].reshape(-1)[[5, 37]] = -10.0
    # band 1: three-way tie at flats 40, 41, 63
    lut[1].reshape(-1)[[40, 41, 63]] = -10.0
    cr = np.full((n_inc, 40), -30.0, np.float32)
    cr[:, [7, 8, 39]] = -25.0
    cr_w = np.arange(40, dtype=np.float32)
    ops = tuple(jnp.asarray(a) for a in build_band_arrays(lut, u, v, tile,
                                                          cr, cr_w))
    feats = np.zeros((2 * block, 5), np.float32)
    # s0 co matches the tied entries exactly; every other pixel has no
    # copol observation, so no crosspol prior and the cr costs tie too
    feats[:, 0] = np.where(np.arange(2 * block) % 2, np.nan, -10.0)
    feats[:, 3] = -25.0    # s0 cr: exact match at the tied entries
    feats[:, 4] = 1.0      # dsig cr
    band_of_block = jnp.asarray([0, 1], jnp.int32)
    flat, cr_best = band_argmin(
        ops, jnp.zeros(n_w, jnp.float32), jnp.asarray([0.1], jnp.float32),
        jnp.asarray(feats), jnp.repeat(band_of_block, block), band_of_block,
        jnp.ones(2, jnp.int32), jnp.full(2, anchor, jnp.int32),
        n_phi_pad=n_p, has_cr=True, block=block, tile=tile, num_warps=4,
        num_stages=2, interpret=True)
    flat, cr_best = np.asarray(flat), np.asarray(cr_best)
    has_co = ~np.isnan(feats[:, 0])
    np.testing.assert_array_equal(flat[:block][has_co[:block]], 5)
    np.testing.assert_array_equal(flat[block:][has_co[block:]], 40)
    np.testing.assert_array_equal(cr_best[~has_co], 7)


def test_kernel_phi_360_lut():
    """A 0..360 phi LUT (asymmetric in phi; still run through the
    symmetric-LUT path by the reference's span rule) through the kernel
    equals the exact path."""
    from xsarsea_tpu.dimarray import DimArray

    inc_dim = np.arange(18.0, 47.0 + 1e-9, 1.0)
    wspd_dim = np.arange(0.2, 30.0 + 1e-9, 0.4)
    phi_dim = np.arange(0.0, 360.0 + 1e-9, 5.0)

    def s0_db(inc, wspd, phi_deg):
        pr = np.deg2rad(phi_deg)
        return (-25.0 + 16.0 * np.log10(wspd + 1.0) - 0.2 * (inc - 30.0)
                + 1.5 * np.cos(pr) + 0.8 * np.sin(pr))

    lut = DimArray(s0_db(inc_dim[:, None, None], wspd_dim[None, :, None],
                         phi_dim[None, None, :]),
                   dims=("incidence", "wspd", "phi"),
                   coords={"incidence": inc_dim, "wspd": wspd_dim,
                           "phi": phi_dim}, attrs={"units": "dB"})
    tables = InversionTables(lut_co_db=lut, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    n = 400
    inc = rng.uniform(18.0, 47.0, n)
    speed = rng.uniform(1.0, 25.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    s0 = s0_db(inc, speed, phi) + rng.normal(0, 0.1, n)
    anc = speed * np.exp(1j * np.deg2rad(phi)) + rng.normal(0, 1.0, n)
    nanv = np.full(n, np.nan)
    co_e, _ = invert_pixels(tables, inc, s0, nanv, nanv, anc, mode="exact")
    co_p, _ = invert_pixels(tables, inc, s0, nanv, nanv, anc,
                            mode="triton_interpret")
    np.testing.assert_array_equal(co_p, co_e)


def test_kernel_config_and_operand_layout():
    """The kernel's block/step constants, the row-padded operand layout
    and the per-step bounds the sweep skips by."""
    from xsarsea_tpu.ops import pallas_inversion as K
    from xsarsea_tpu.ops.pallas_inversion import build_band_arrays

    for v in (K.BLOCK, K.TILE):   # Triton block shapes are powers of 2
        assert v & (v - 1) == 0
    # the high-resolution 181-phi rows pad by at most 6%
    assert (-(-181 // K.TILE) * K.TILE) / 181 < 1.07

    rng = np.random.default_rng(0)
    lut = rng.uniform(-30, 0, (3, 5, 7)).astype(np.float32)
    u = rng.normal(size=(5, 7)).astype(np.float32)
    v = rng.normal(size=(5, 7)).astype(np.float32)
    cr = rng.uniform(-40, -20, (3, 9)).astype(np.float32)
    cr_w = np.arange(9, dtype=np.float32)
    lut_f, u_h, v_h, l_box, uv_box, cr_f, cr_wh = build_band_arrays(
        lut, u, v, 8, cr, cr_w)
    # each 7-phi row padded to one 8-entry step
    assert lut_f.shape == (3, 40) and u_h.shape == (40,)
    rows = lut_f.reshape(3, 5, 8)
    np.testing.assert_array_equal(rows[..., :7], lut)
    assert (rows[..., 7] >= 1e19).all()   # padding never wins
    np.testing.assert_array_equal(u_h.reshape(5, 8)[:, :7] * 2, u)
    # bounds over the real entries of each step
    np.testing.assert_array_equal(l_box[:, 0], lut.min(axis=2))
    np.testing.assert_array_equal(l_box[:, 1], lut.max(axis=2))
    np.testing.assert_array_equal(uv_box[0], (u * 0.5).min(axis=1))
    np.testing.assert_array_equal(uv_box[3], (v * 0.5).max(axis=1))
    assert cr_f.shape == (3 * 16,) and cr_wh.shape == (16,)
    np.testing.assert_array_equal(cr_f.reshape(3, 16)[:, :9], cr)
    np.testing.assert_array_equal(cr_wh[:9] * 2, cr_w)


def test_resolve_mode_maps_platform_to_path():
    """'auto' picks the kernel on a GPU when a copol table exists, the
    exact path elsewhere; never an interpret mode; unknown names raise."""
    from xsarsea_tpu.windspeed.inversion import resolve_mode

    kwargs = dict(inc_step=1.0, wspd_step=1.0, phi_step=10.0)
    lut_co = get_model("gmf_cmod5n").to_lut(units="dB", **kwargs)
    lut_cr = get_model("gmf_s1_v2").to_lut(units="dB", **kwargs)
    dual = InversionTables(lut_co, lut_cr, dtype=jnp.float32)
    cross = InversionTables(None, lut_cr, dtype=jnp.float32)
    assert resolve_mode("auto", dual, "gpu") == "triton"
    assert resolve_mode("auto", dual, "cpu") == "exact"
    assert resolve_mode("auto", cross, "gpu") == "exact"
    assert resolve_mode("auto", dual) == "exact"  # the CPU test backend
    assert resolve_mode("triton_interpret", dual, "gpu") == "triton_interpret"
    for retired in ("pallas", "pallas_fast", "pallas_interpret"):
        with pytest.raises(ValueError, match="unknown inversion mode"):
            resolve_mode(retired, dual)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu_matches_exact(gpu):
    """The Triton-compiled kernel at the high-resolution grid widths picks
    the same nodes as the exact path on the card, except at near-ties
    (FMA contraction may round the two costs differently)."""
    tables = InversionTables(
        get_model("gmf_cmod5n").to_lut(units="dB"),
        get_model("gmf_s1_v2").to_lut(units="dB"), dtype=jnp.float32)
    args = _kernel_scene(tables, 4096, seed=2)
    co_e, dual_e = invert_pixels(tables, *args, mode="exact")
    co_p, dual_p = invert_pixels(tables, *args, mode="triton")
    for got, ref in ((co_p, co_e), (dual_p, dual_e)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        m = ~np.isnan(ref)
        assert np.mean(got[m] != ref[m]) < 1e-3
