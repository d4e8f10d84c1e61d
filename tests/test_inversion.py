"""Wind inversion parity vs the plain float64 reference
(tests/inversion_reference.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from xsarsea_tpu.models import get_model
from xsarsea_tpu.windspeed import invert_from_model, prepare_tables
from xsarsea_tpu.windspeed.inversion import invert_pixels
from xsarsea_tpu.dimarray import DimArray
from reference_runner import (
    ref_invert,
    ref_invert_mono_copol,
    ref_invert_mono_crosspol,
)


def synthetic_scene(ny=18, nx=25, seed=0, with_nans=True):
    """Synthetic dual-pol scene: sigma0 generated by the forward GMFs."""
    rng = np.random.default_rng(seed)
    inc = np.linspace(18.0, 45.0, nx)[None, :].repeat(ny, axis=0)
    true_speed = rng.uniform(1.0, 28.0, size=(ny, nx))
    true_dir = rng.uniform(-180.0, 180.0, size=(ny, nx))  # antenna convention

    co = get_model("gmf_cmod5n")
    cr = get_model("gmf_s1_v2")
    s0_co = np.asarray(co(inc, true_speed, np.abs(true_dir)))
    s0_cr = np.asarray(cr(inc, true_speed))
    # multiplicative speckle-ish noise
    s0_co = s0_co * rng.uniform(0.9, 1.1, s0_co.shape)
    s0_cr = s0_cr * rng.uniform(0.9, 1.1, s0_cr.shape)

    anc_speed = np.clip(true_speed + rng.normal(0, 1.5, true_speed.shape), 0.3, None)
    anc_dir = np.deg2rad(true_dir + rng.normal(0, 20.0, true_dir.shape))
    anc = anc_speed * np.exp(1j * anc_dir)

    dsig_cr = rng.uniform(0.05, 1.5, size=(ny, nx))

    if with_nans:
        inc[0, 0] = np.nan          # guard 1
        anc[1, 2] = np.nan          # guard 2
        s0_co[2, 3] = np.nan        # crosspol-only pixel
        s0_cr[3, 4] = np.nan        # copol-only pixel
        dsig_cr[4, 5] = np.nan      # invalid crosspol weight
        s0_co[5, 6] = np.nan
        anc[5, 6] = np.nan          # fully ancillary-less pixel
    return inc, s0_co, s0_cr, dsig_cr, anc


def reduced_luts():
    """Shared reduced-resolution LUTs (keeps the python oracle fast)."""
    kwargs = dict(inc_step=0.4, wspd_step=0.4, phi_step=2.5)
    lut_co = get_model("gmf_cmod5n").to_lut(units="dB", **kwargs)
    lut_cr = get_model("gmf_s1_v2").to_lut(units="dB", **kwargs)
    return lut_co, lut_cr, kwargs


def assert_complex_match(mine, ref, atol=1e-9):
    mine, ref = np.asarray(mine), np.asarray(ref)
    nan_mine = np.isnan(np.abs(mine))
    nan_ref = np.isnan(np.abs(ref))
    np.testing.assert_array_equal(nan_mine, nan_ref)
    m = ~nan_ref
    np.testing.assert_allclose(np.abs(mine[m]), np.abs(ref[m]), atol=atol)
    # compare directions via complex difference (avoids ±pi wrap issues)
    np.testing.assert_allclose(mine[m].real, ref[m].real, atol=atol)
    np.testing.assert_allclose(mine[m].imag, ref[m].imag, atol=atol)


def test_dualpol_parity_with_reference():
    inc, s0_co, s0_cr, dsig_cr, anc = synthetic_scene()
    lut_co, lut_cr, kwargs = reduced_luts()

    ref_co, ref_dual_raw = ref_invert(inc, s0_co, s0_cr, dsig_cr, anc, lut_co, lut_cr)
    # reference applies the <5 m/s merge after inversion (windspeed.py:425-428)
    ref_dual = np.where(
        (np.abs(ref_co) < 5) | (np.abs(ref_dual_raw) < 5), ref_co, ref_dual_raw
    )

    got_co, got_dual = invert_from_model(
        inc, s0_co, s0_cr, ancillary_wind=anc, dsig_cr=dsig_cr,
        model=("gmf_cmod5n", "gmf_s1_v2"), dtype=jnp.float64, **kwargs,
    )
    assert_complex_match(got_co, ref_co)
    assert_complex_match(got_dual, ref_dual)


def test_monopol_copol_parity():
    inc, s0_co, _, _, anc = synthetic_scene(seed=3)
    lut_co, _, kwargs = reduced_luts()

    ref_co = ref_invert_mono_copol(inc, s0_co, anc, lut_co)
    got = invert_from_model(
        inc, s0_co, ancillary_wind=anc, model="gmf_cmod5n",
        dtype=jnp.float64, **kwargs,
    )
    assert_complex_match(got, ref_co)


def test_monopol_crosspol_parity():
    inc, _, s0_cr, dsig_cr, _ = synthetic_scene(seed=4)
    _, lut_cr, kwargs = reduced_luts()

    ref_speed = ref_invert_mono_crosspol(inc, s0_cr, dsig_cr, lut_cr)
    got = invert_from_model(
        inc, s0_cr, dsig_cr=dsig_cr, model="gmf_s1_v2",
        dtype=jnp.float64, **kwargs,
    )
    got, ref_speed = np.asarray(got), np.asarray(ref_speed)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref_speed))
    m = ~np.isnan(ref_speed)
    np.testing.assert_allclose(got[m], ref_speed[m], atol=1e-9)


def test_float32_rms_below_tolerance():
    """f32 path < 1e-3 m/s RMS vs the f64 reference."""
    inc, s0_co, s0_cr, dsig_cr, anc = synthetic_scene(ny=24, nx=32, seed=7)
    lut_co, lut_cr, kwargs = reduced_luts()
    ref_co, ref_dual_raw = ref_invert(inc, s0_co, s0_cr, dsig_cr, anc, lut_co, lut_cr)
    ref_dual = np.where(
        (np.abs(ref_co) < 5) | (np.abs(ref_dual_raw) < 5), ref_co, ref_dual_raw
    )

    got_co, got_dual = invert_from_model(
        inc, s0_co, s0_cr, ancillary_wind=anc, dsig_cr=dsig_cr,
        model=("gmf_cmod5n", "gmf_s1_v2"), dtype=jnp.float32, **kwargs,
    )
    for got, ref in ((got_co, ref_co), (got_dual, ref_dual)):
        speed_got, speed_ref = np.abs(np.asarray(got)), np.abs(ref)
        m = ~np.isnan(speed_ref)
        assert np.isnan(speed_got[~m]).all()
        rms = np.sqrt(np.mean((speed_got[m] - speed_ref[m]) ** 2))
        assert rms < 1e-3, f"f32 RMS {rms}"


def test_dimarray_inputs_return_dimarray():
    inc, s0_co, s0_cr, dsig_cr, anc = synthetic_scene(ny=8, nx=10, with_nans=False)
    _, _, kwargs = reduced_luts()
    dims = ("line", "sample")
    coords = {"line": np.arange(8), "sample": np.arange(10)}
    da = lambda x: DimArray(x, dims=dims, coords=coords)

    co, dual = invert_from_model(
        da(inc), da(s0_co), da(s0_cr), ancillary_wind=da(anc),
        dsig_cr=da(dsig_cr), model=("gmf_cmod5n", "gmf_s1_v2"),
        dtype=jnp.float64, **kwargs,
    )
    assert isinstance(co, DimArray) and isinstance(dual, DimArray)
    assert co.dims == dims
    assert "gmf_cmod5n" in dual.attrs["model"]


def test_pol_mismatch_raises():
    inc, s0_co, _, _, anc = synthetic_scene(ny=4, nx=5, with_nans=False)
    _, _, kwargs = reduced_luts()
    s0 = DimArray(s0_co, dims=("line", "sample"),
                  coords={"pol": np.array(["VH"])})
    with pytest.raises(ValueError, match="pol"):
        invert_from_model(inc, s0, ancillary_wind=anc, model="gmf_cmod5n",
                          dtype=jnp.float64, **kwargs)


def test_copol_model_in_crosspol_slot_raises():
    """A phi-dependent (copol) model as model_cr fails with a clear
    message, not a shape-unpack crash in the kernel builders."""
    _, _, kwargs = reduced_luts()
    with pytest.raises(ValueError, match="copol.*crosspol model"):
        prepare_tables("gmf_cmod5n", "gmf_cmod5n", dtype=jnp.float64,
                       **kwargs)


def test_crosspol_model_in_copol_slot_raises():
    """The mirrored mistake — a phi-independent (crosspol) model as
    model_co — also fails with a clear message, not KeyError('phi')."""
    _, _, kwargs = reduced_luts()
    with pytest.raises(ValueError, match="crosspol.*copol model"):
        prepare_tables("gmf_s1_v2", "gmf_s1_v2", dtype=jnp.float64,
                       **kwargs)


def test_prepare_tables_list_kwargs_hashable():
    """list/ndarray-valued kwargs (Model.to_lut accepts them) must not
    crash the lru_cache key (review finding: TypeError unhashable)."""
    t = prepare_tables("gmf_cmod5n", None, dtype=jnp.float64,
                       inc_step=1.0, wspd_step=1.0, phi_step=10.0,
                       inc_range=[18.0, 46.0],
                       wspd_range=np.array([0.5, 30.0]))
    assert t.has_co and not t.has_cr
    # identical kwargs (list vs tuple-normalized) hit the same cache entry
    t2 = prepare_tables("gmf_cmod5n", None, dtype=jnp.float64,
                        inc_step=1.0, wspd_step=1.0, phi_step=10.0,
                        inc_range=[18.0, 46.0],
                        wspd_range=np.array([0.5, 30.0]))
    assert t2 is t


def test_invert_pixels_direct():
    """Low-level API: flat pixels against prepared tables."""
    _, _, kwargs = reduced_luts()
    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float64, **kwargs)
    inc = np.array([25.0, 35.0])
    s0_co_db = 10 * np.log10([0.08, 0.02])
    s0_cr_db = 10 * np.log10([3e-4, 1e-4])
    anc = np.array([10 * np.exp(0.5j), 8 * np.exp(-2j)], dtype=np.complex128)
    co, dual = invert_pixels(tables, inc, s0_co_db, s0_cr_db,
                             np.array([0.2, 0.2]), anc)
    assert co.shape == (2,) and dual.shape == (2,)
    assert np.isfinite(np.abs(co)).all() and np.isfinite(np.abs(dual)).all()


def test_phi_360_lut_characterization():
    """Characterize the reference's phi_180 rule on a 0-360 deg phi LUT.

    The reference detects a symmetric LUT with
    ``(180 - (phi[-1] - phi[0])) < 2`` (windspeed.py:152-156) — which is
    also TRUE for a full 0..360 span (180 - 360 = -180 < 2), so a 360-phi
    model runs through the symmetric-LUT path (|m_azi| prior folding and
    +/-phi disambiguation) even when the LUT is deliberately asymmetric
    in phi. We replicate that rule faithfully (inversion.py phi_180);
    this test pins both the rule and end-to-end parity against the
    reference oracle on such a LUT.
    """
    from xsarsea_tpu.windspeed.inversion import InversionTables

    rng = np.random.default_rng(11)
    inc_dim = np.arange(18.0, 46.0 + 1e-9, 1.0)
    wspd_dim = np.arange(0.2, 30.0 + 1e-9, 0.4)
    phi_dim = np.arange(0.0, 360.0 + 1e-9, 5.0)   # full 0..360 span

    def s0_db(inc, wspd, phi_deg):
        # deliberately asymmetric in phi (sin term breaks phi -> -phi)
        pr = np.deg2rad(phi_deg)
        return (-25.0 + 16.0 * np.log10(wspd + 1.0) - 0.2 * (inc - 30.0)
                + 1.5 * np.cos(pr) + 0.8 * np.sin(pr))

    lut_db = s0_db(inc_dim[:, None, None], wspd_dim[None, :, None],
                   phi_dim[None, None, :])
    lut = DimArray(lut_db, dims=("incidence", "wspd", "phi"),
                   coords={"incidence": inc_dim, "wspd": wspd_dim,
                           "phi": phi_dim},
                   attrs={"units": "dB"})

    tables = InversionTables(lut_co_db=lut, dtype=jnp.float64)
    assert tables.phi_180 is True  # the quirk: 360-span LUT treated as symmetric

    ny, nx = 12, 17
    inc = np.linspace(19.0, 44.0, nx)[None, :].repeat(ny, axis=0)
    speed = rng.uniform(1.0, 25.0, (ny, nx))
    phi = rng.uniform(0.0, 360.0, (ny, nx))
    s0_lin = 10.0 ** (s0_db(inc, speed, phi) / 10.0)
    s0_lin *= rng.uniform(0.95, 1.05, s0_lin.shape)
    anc = speed * np.exp(1j * np.deg2rad(phi)) + rng.normal(0, 1.0, (ny, nx))

    ref_co = ref_invert_mono_copol(inc, s0_lin, anc, lut)

    s0_co_db = 10.0 * np.log10(s0_lin + 1e-15)
    nanv = np.full(ny * nx, np.nan)
    got_co, _ = invert_pixels(
        tables, inc.reshape(-1), s0_co_db.reshape(-1), nanv, nanv,
        anc.reshape(-1), mode="exact")
    assert_complex_match(got_co.reshape(ny, nx), ref_co)


def test_streaming_pieces_match_single_shot():
    """The double-buffered piece-streaming path (large inputs) returns
    bit-identical results to the single-transfer path, including the
    NaN-padded tail piece."""
    import xsarsea_tpu.windspeed.inversion as inv

    _, _, kwargs = reduced_luts()
    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float64,
                            **kwargs)
    inc, s0_co, s0_cr, dsig_cr, anc = synthetic_scene(ny=30, nx=47)
    flat = lambda a: np.asarray(a, dtype=np.complex128 if a.dtype.kind == "c"
                                else np.float64).reshape(-1)
    s0_co_db = 10 * np.log10(s0_co + 1e-15)
    s0_cr_db = 10 * np.log10(s0_cr + 1e-15)
    args = (flat(inc), flat(s0_co_db), flat(s0_cr_db), flat(dsig_cr),
            flat(anc))

    co_ref, dual_ref = inv.invert_pixels(tables, *args, mode="exact")

    # shrink the piece size so 1410 pixels stream as 5 pieces + padded tail
    co_s, dual_s = inv.invert_pixels(tables, *args, mode="exact",
                                     piece_size=256)
    np.testing.assert_array_equal(np.isnan(np.abs(co_s)),
                                  np.isnan(np.abs(co_ref)))
    m = ~np.isnan(np.abs(co_ref))
    np.testing.assert_allclose(co_s[m], co_ref[m], atol=0)
    m2 = ~np.isnan(np.abs(dual_ref))
    np.testing.assert_allclose(dual_s[m2], dual_ref[m2], atol=0)


def test_cmod7_lut_through_inversion(tmp_path):
    """CMOD7 plumbing: a (synthesized) CMOD7 KNMI binary table
    registered, normalized (linear->dB, low->requested grid) and inverted,
    with parity against the reference oracle on the same LUT."""
    from xsarsea_tpu.models.cmod7 import register_cmod7

    # physical table: cmod5n evaluated on the CMOD7 native grid
    m_, n_, p_ = 250, 73, 51
    wspd = np.arange(0.2, 50.0 + 0.2, 0.2)
    phi = np.arange(0.0, 180.0 + 2.5, 2.5)
    inc = np.arange(16.0, 66.0 + 1.0, 1.0)
    gmf = get_model("gmf_cmod5n")
    vals = np.asarray(gmf(inc, wspd, phi).data)          # (inc, wspd, phi)
    table = np.ascontiguousarray(vals.transpose(1, 2, 0))  # (wspd, phi, inc)
    flat = np.concatenate([
        np.array([0.0], np.float32),
        table.astype(np.float32).reshape(-1, order="F"),
        np.array([0.0], np.float32)])
    d = tmp_path / "cmod7"
    d.mkdir()
    flat.astype("<f4").tofile(d / "gmf_cmod7_vv.dat_little_endian")
    register_cmod7(str(d))

    kwargs = dict(inc_step=1.0, wspd_step=0.4, phi_step=5.0)
    lut_db = get_model("gmf_cmod7").to_lut(units="dB", **kwargs)
    assert lut_db.attrs["units"] == "dB"

    inc2, s0_co, _, _, anc = synthetic_scene(ny=10, nx=14, seed=12)
    ref_co = ref_invert_mono_copol(inc2, s0_co, anc, lut_db)
    got = invert_from_model(inc2, s0_co, ancillary_wind=anc,
                            model="gmf_cmod7", dtype=jnp.float64, **kwargs)
    assert_complex_match(got, ref_co)


def test_public_api_pallas_fast_mode():
    """mode= flows through invert_from_model to the kernel pipeline, and
    the retired mode names ('pallas', 'pallas_fast', ...) raise
    instead of silently running another path."""
    inc, s0_co, s0_cr, dsig_cr, anc = synthetic_scene(ny=8, nx=10,
                                                      with_nans=False)
    kwargs = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    common = dict(ancillary_wind=anc, dsig_cr=dsig_cr, dtype=jnp.float32,
                  model=("gmf_cmod5n", "gmf_s1_v2"), device_db=False)
    got_k = invert_from_model(inc, s0_co, s0_cr, mode="triton_interpret",
                              **common, **kwargs)
    got_e = invert_from_model(inc, s0_co, s0_cr, mode="exact",
                              **common, **kwargs)
    for a, b in zip(got_k, got_e):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for retired in ("pallas", "pallas_fast_interpret"):
        with pytest.raises(ValueError, match="unknown inversion mode"):
            invert_from_model(inc, s0_co, s0_cr, mode=retired, **common,
                              **kwargs)


def test_public_api_device_db_false_cross_mode_bit_parity():
    """``device_db=False`` keeps host f64 dB prep in the kernel mode,
    making the public API bit-identical across modes (the auto default
    ships linear f32 + device dB, which may flip near-cost-tie argmins)."""
    inc, s0_co, s0_cr, dsig_cr, anc = synthetic_scene(ny=16, nx=20)
    kwargs = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    common = dict(ancillary_wind=anc, dsig_cr=dsig_cr, dtype=jnp.float32,
                  model=("gmf_cmod5n", "gmf_s1_v2"))
    got_e = invert_from_model(inc, s0_co, s0_cr, mode="exact",
                              **common, **kwargs)
    got_p = invert_from_model(inc, s0_co, s0_cr, mode="triton_interpret",
                              device_db=False, **common, **kwargs)
    for a, b in zip(got_p, got_e):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
