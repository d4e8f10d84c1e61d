"""Shared parity assertion for kernel-vs-exact complex wind comparisons."""
import numpy as np


def assert_equal_modulo_pi_ties(got, ref, mask=None):
    """Bit-equality, except the phi = +-180 deg degenerate tie.

    When the copol argmin lands exactly on the phi=180 grid point, +phi
    and -phi are the same physical direction and the reference's d1<=d2
    angular comparison is an exact floating-point tie — the sign of the
    (~wspd*sin(pi_fp) ~ 1e-5) imaginary part is rounding noise. The
    kernel path's postprocess replicates _disambiguate_phi's exact
    op sequence, so these pixels normally agree bit-for-bit too; the
    conjugate is still accepted there because the two paths may reach
    the solution through different (tie-flipped) argmin routes whose
    phi signs are both valid. Everything else must be bit-equal.
    """
    got, ref = np.asarray(got), np.asarray(ref)
    if mask is None:
        mask = ~np.isnan(np.abs(ref))
    np.testing.assert_array_equal(np.isnan(np.abs(got)), ~mask)
    g, r = got[mask], ref[mask]
    tie = (g == np.conj(r)) & (np.abs(r.imag) < 1e-4)
    np.testing.assert_array_equal(np.where(tie, r, g), r)
