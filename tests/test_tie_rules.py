"""Stress tests for numpy-first-minimum tie semantics and bucketing.

The inversion's correctness claim is BIT-parity with the reference's
np.argmin, whose tie rule (first minimum in row-major order) only shows
up when costs tie exactly. These tests engineer guaranteed ties
(duplicated LUT rows/columns) and property-test the bucketing primitive
against a plain numpy reference.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from xsarsea_tpu.dimarray import DimArray
from xsarsea_tpu.windspeed.inversion import InversionTables, invert_pixels
from reference_runner import ref_invert
from _parity import assert_equal_modulo_pi_ties


def _tied_luts():
    """LUTs with duplicated wspd rows and phi columns -> exact cost ties."""
    rng = np.random.default_rng(3)
    inc = np.linspace(18.0, 46.0, 8)
    wspd = np.round(np.linspace(1.0, 30.0, 24), 3)
    phi = np.linspace(0.0, 180.0, 13)
    co = rng.uniform(-30.0, -5.0, (8, 24, 13))
    co[:, 7, :] = co[:, 6, :]        # duplicated wspd rows
    co[:, 15, :] = co[:, 14, :]
    co[:, :, 5] = co[:, :, 4]        # duplicated phi columns
    cr = rng.uniform(-40.0, -20.0, (8, 24))
    cr[:, 11] = cr[:, 10]            # duplicated crosspol wspd entries
    lut_co = DimArray(co, dims=("incidence", "wspd", "phi"),
                      coords={"incidence": inc, "wspd": wspd, "phi": phi},
                      attrs={"units": "dB"})
    lut_cr = DimArray(cr, dims=("incidence", "wspd"),
                      coords={"incidence": inc, "wspd": wspd},
                      attrs={"units": "dB"})
    return lut_co, lut_cr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tied_costs_vs_reference_only_degenerate_flips(seed):
    """On tie-engineered inputs, any cell where we disagree with the
    reference must itself be a degenerate (float-level) cost tie.

    Sigma0 drawn from LUT cells makes the cost surface full of exact and
    near-exact ties. True exact ties must resolve identically (first
    minimum). Near-ties within ~1e-12 can legitimately flip because the
    reference re-derives dB from linear with a +1e-15 clip and uses
    |w*e^(i*phi)| (1-ulp different from w) in the crosspol prior — so for
    every disagreeing pixel we recompute both candidates' costs and
    assert they are numerically indistinguishable.
    """
    lut_co, lut_cr = _tied_luts()
    tables = InversionTables(lut_co, lut_cr, dtype=jnp.float64)

    rng = np.random.default_rng(seed)
    n = 500
    inc = rng.uniform(17.0, 47.0, n)
    s0_co_db = np.asarray(lut_co.data).reshape(-1)[
        rng.integers(0, lut_co.size, n)]
    s0_cr_db = np.asarray(lut_cr.data).reshape(-1)[
        rng.integers(0, lut_cr.size, n)]
    anc = np.where(rng.random(n) < 0.3, 0.0 + 0.0j,
                   rng.uniform(1, 20, n) * np.exp(
                       1j * rng.uniform(-np.pi, np.pi, n)))
    dsig_cr = np.full(n, 0.2)
    s0_co_lin = 10 ** (s0_co_db / 10.0)
    s0_cr_lin = 10 ** (s0_cr_db / 10.0)
    # identical dB inputs on both sides (the reference clips + re-logs)
    s0_co_db = 10 * np.log10(s0_co_lin + 1e-15)
    s0_cr_db = 10 * np.log10(s0_cr_lin + 1e-15)

    ref_co, ref_dual = ref_invert(inc, s0_co_lin, s0_cr_lin, dsig_cr,
                                  anc, lut_co, lut_cr)
    co, dual = invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr, anc,
                             mode="exact")

    inc_dim = np.asarray(lut_co.coords["incidence"])
    wspd = np.asarray(lut_co.coords["wspd"])
    phi = np.deg2rad(np.asarray(lut_co.coords["phi"]))
    u = wspd[:, None] * np.cos(phi)[None, :]
    v = wspd[:, None] * np.sin(phi)[None, :]

    def copol_cost(i, w_val, phi_rad):
        ii = np.argmin(np.abs(inc_dim - inc[i]))
        iw = np.argmin(np.abs(wspd - w_val))
        ip = np.argmin(np.abs(phi - abs(phi_rad)))
        jsig = ((np.asarray(lut_co.data)[ii, iw, ip] - s0_co_db[i]) / 0.1) ** 2
        ma, mz = anc[i].real, abs(anc[i].imag)
        return jsig + ((u[iw, ip] - ma) / 2) ** 2 + ((v[iw, ip] - mz) / 2) ** 2

    co_np, ref_np = np.asarray(co), np.asarray(ref_co)
    m = ~np.isnan(np.abs(ref_np))
    np.testing.assert_array_equal(np.isnan(np.abs(co_np)), ~m)
    mism = np.where(m & (np.abs(co_np - ref_np) > 1e-9))[0]
    # disagreements are rare and every one is a degenerate tie
    assert len(mism) < 0.02 * n, f"{len(mism)} copol mismatches"
    for i in mism:
        j_ours = copol_cost(i, abs(co_np[i]), np.angle(co_np[i]))
        j_ref = copol_cost(i, abs(ref_np[i]), np.angle(ref_np[i]))
        assert abs(j_ours - j_ref) <= 1e-9 * max(1.0, abs(j_ref)), (
            f"pixel {i}: non-tie disagreement {j_ours} vs {j_ref}")


def test_tied_costs_pallas_matches_exact():
    """The kernel reproduces the same tie decisions as exact mode (f32)
    on the engineered-tie LUTs."""
    lut_co, lut_cr = _tied_luts()
    tables = InversionTables(lut_co, lut_cr, dtype=jnp.float32)
    rng = np.random.default_rng(7)
    n = 400
    inc = rng.uniform(17.0, 47.0, n)
    s0_co_db = np.asarray(lut_co.data, np.float32).reshape(-1)[
        rng.integers(0, lut_co.size, n)].astype(np.float64)
    s0_cr_db = np.asarray(lut_cr.data, np.float32).reshape(-1)[
        rng.integers(0, lut_cr.size, n)].astype(np.float64)
    anc = rng.uniform(1, 20, n) * np.exp(1j * rng.uniform(-np.pi, np.pi, n))
    dsig_cr = np.full(n, 0.2)

    co_e, dual_e = invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr,
                                 anc, mode="exact")
    co_p, dual_p = invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr,
                                 anc, mode="triton_interpret")
    for got, ref in ((co_p, co_e), (dual_p, dual_e)):
        assert_equal_modulo_pi_ties(got, ref)


# ------------------------------------------------------- bucketing property

def _bucket_reference(band, n_bands, block):
    """Plain-numpy reference for bucket_by_band's contract."""
    n = len(band)
    order = np.argsort(band, kind="stable")
    perm = []
    band_of_block = []
    for b in range(n_bands):
        members = order[band[order] == b]
        if len(members) == 0:
            continue
        padded = ((len(members) + block - 1) // block) * block
        chunk = np.full(padded, -1, np.int64)
        chunk[:len(members)] = members
        perm.append(chunk)
        band_of_block += [b] * (padded // block)
    perm = np.concatenate(perm) if perm else np.zeros(0, np.int64)
    return perm, np.asarray(band_of_block)


@pytest.mark.parametrize("seed", range(8))
def test_bucket_by_band_property(seed):
    from xsarsea_tpu.ops.pallas_inversion import bucket_by_band

    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5000))
    n_bands = int(rng.integers(1, 60))
    block = int(rng.choice([8, 32, 128]))
    band = rng.integers(0, n_bands, n).astype(np.int32)

    perm, bob = bucket_by_band(jnp.asarray(band), n_bands=n_bands,
                               block=block)
    perm, bob = np.asarray(perm), np.asarray(bob)
    ref_perm, ref_bob = _bucket_reference(band, n_bands, block)

    # the occupied-slot PATTERN and each band's pixel SET match the
    # reference; the within-band order is unspecified (the sort is
    # unstable because no per-pixel result depends on its slot)
    np.testing.assert_array_equal(perm[:len(ref_perm)] >= 0, ref_perm >= 0)
    for b in range(n_bands):
        sel = np.repeat(ref_bob == b, block)
        sl, rl = perm[:len(ref_perm)][sel], ref_perm[sel]
        np.testing.assert_array_equal(np.sort(sl[sl >= 0]), np.sort(rl[rl >= 0]))
    assert (perm[len(ref_perm):] == -1).all()
    np.testing.assert_array_equal(bob[:len(ref_bob)], ref_bob)
    # every pixel appears exactly once
    got = np.sort(perm[perm >= 0])
    np.testing.assert_array_equal(got, np.arange(n))
    # block purity: non-padding slots of block b belong to band bob[b]
    for b in range(len(perm) // block):
        sl = perm[b * block:(b + 1) * block]
        members = sl[sl >= 0]
        if len(members):
            assert (band[members] == bob[b]).all()
