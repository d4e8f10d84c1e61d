"""GMF parity vs the reference physics + registration contract tests."""

import numpy as np
import pytest

from xsarsea_tpu.models import GmfModel, available_models, get_model
from reference_runner import ref_gmf_grid, load_ref_gmfs

COPOL_GMFS = ["gmf_cmod5", "gmf_cmod5n", "gmf_cmod5n_pr_zhangA", "gmf_cmod5n_pr_mouche1",
              "gmf_cmodifr2"]
XPOL_GMFS = ["gmf_rs2_v2", "gmf_s1_v2", "gmf_rcm_noaa", "gmf_s1_v3_ew_rec",
             "gmf_rs2_v3", "gmf_rcm_v3", "gmf_rcm_v4", "gmf_rs2_v4"]

INC = np.linspace(16.0, 66.0, 11)
WSPD_CO = np.linspace(0.2, 50.0, 13)
WSPD_CR = np.linspace(3.0, 80.0, 13)
PHI = np.linspace(0.0, 360.0, 17)


@pytest.mark.parametrize("name", COPOL_GMFS)
def test_copol_gmf_matches_reference(name):
    model = get_model(name)
    got = model(INC, WSPD_CO, PHI)
    expected = ref_gmf_grid(name, INC, WSPD_CO, PHI)
    np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("name", XPOL_GMFS)
def test_xpol_gmf_matches_reference(name):
    model = get_model(name)
    got = model(INC, WSPD_CR)
    expected = ref_gmf_grid(name, INC, WSPD_CR)
    np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-10, atol=0)


def test_scalar_call_returns_scalar():
    model = get_model("gmf_cmod5n")
    res = model(35.0, 15.0, 90.0)
    assert np.isscalar(res)
    ref = load_ref_gmfs()["gmf_cmod5n"](35.0, 15.0, 90.0)
    np.testing.assert_allclose(res, ref, rtol=1e-10)


def test_broadcast_2d_call():
    model = get_model("gmf_cmod5n")
    inc = np.full((4, 5), 35.0) + np.arange(5)
    wspd = np.full((4, 5), 10.0)
    phi = np.full((4, 5), 45.0)
    res = np.asarray(model(inc, wspd, phi))
    assert res.shape == (4, 5)
    ref00 = load_ref_gmfs()["gmf_cmod5n"](35.0, 10.0, 45.0)
    np.testing.assert_allclose(res[0, 0], ref00, rtol=1e-10)


def test_phi_range_detection():
    # cmod5 family is even in phi -> symmetric LUT over [0, 180]
    assert get_model("gmf_cmod5n").phi_range == [0.0, 180.0]
    # crosspol GMFs ignore phi entirely
    assert get_model("gmf_rs2_v2").phi_range is None


def test_phi_range_detection_asymmetric():
    """An asymmetric user GMF must be classified [0, 360] (review
    finding: a probe min() over a set containing phi=0 — whose
    difference is identically zero — classified EVERYTHING as 180;
    the reference has the same flaw, gmfs.py:146-155)."""
    import jax.numpy as jnp

    from xsarsea_tpu.models.base import Model

    @GmfModel.register(wspd_range=[0.2, 50.0], pol="VV", units="linear",
                       defer=False)
    def gmf_asym_test(inc, wspd, phi):
        return 1e-3 * wspd * (1.0 + 0.1 * jnp.sin(jnp.deg2rad(phi)))

    try:
        assert get_model("gmf_asym_test").phi_range == [0.0, 360.0]
    finally:
        Model._available_models.pop("gmf_asym_test", None)


def test_registration_contract_and_golden_values():
    """Users register plain jnp-traceable functions; golden values from the
    reference docstring (gmfs.py:60-64)."""

    @GmfModel.register(inc_range=[17.0, 50.0], wspd_range=[3.0, 80.0], pol="VH",
                       units="linear", defer=False)
    def gmf_dummy(inc, wspd, phi=None):
        a = 0.00013106836021008122 - 4.530598283705591e-06 * inc + 4.429277425062766e-08 * inc ** 2
        b = 1.3925444179360706 + 0.004157838450541205 * inc + 3.4735809771069953e-05 * inc ** 2
        return a * wspd ** b

    model = get_model("gmf_dummy")
    res = np.asarray(model(np.arange(20, 22), np.arange(10, 12)))
    golden = np.array([[0.00179606, 0.00207004], [0.0017344, 0.00200004]])
    np.testing.assert_allclose(res, golden, atol=1e-8)
    assert model.inc_range == [17.0, 50.0]
    assert "gmf_dummy" in available_models().index


def test_float32_accuracy_vs_float64():
    """The f32 path must stay within small relative error of f64."""
    import jax.numpy as jnp

    model = get_model("gmf_cmod5n")
    f64 = np.asarray(model(INC, WSPD_CO, PHI))
    inc32 = jnp.asarray(INC, dtype=jnp.float32)
    wspd32 = jnp.asarray(WSPD_CO, dtype=jnp.float32)
    phi32 = jnp.asarray(PHI, dtype=jnp.float32)
    f32 = np.asarray(model._jit_grid(inc32, wspd32, phi32), dtype=np.float64)
    rel = np.abs(f32 - f64) / np.maximum(np.abs(f64), 1e-12)
    assert np.nanmax(rel) < 5e-4
