"""Wire-format tests: stream skipping + on-device dB conversion.

The streamed public-API path (_LazySource -> _invert_source) ships only
the streams that exist: missing sigma0/ancillary streams are synthesized
as NaN on device and a scalar dsig_cr ships as one 0-d scalar — both
bit-identical to shipping the full arrays. On the f32 kernel path the
sigma0 streams additionally ship LINEAR with the 10*log10(x+1e-15)
conversion fused into the jitted pipeline (reference host prep:
windspeed.py:126-130); that moves the conversion from host f64 to
device f32, which may differ at f32-ulp scale in dB — asserted here to
change at most ~one grid step on a vanishing fraction of pixels. The
exact/f64 path always keeps host prep (bit parity with the reference is
covered by test_inversion.py).
"""
import numpy as np
import jax.numpy as jnp

from xsarsea_tpu.windspeed.inversion import (
    _invert_source,
    _LazySource,
    invert_pixels,
    prepare_tables,
)


KW = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)


def _scene(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(18.0, 47.0, n)
    wspd = rng.uniform(0.5, 45.0, n)
    phi = rng.uniform(0.0, 360.0, n)
    s0_co = 10 ** (
        (-25.0 + 16.0 * np.log10(wspd + 1.0) - 0.2 * (inc - 30.0)) / 10.0
    ) * rng.uniform(0.8, 1.2, n)
    s0_cr = 10 ** ((-35.0 + 0.6 * wspd - 0.1 * (inc - 30.0)) / 10.0)
    anc = (wspd + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(
        1j * np.deg2rad(phi))
    return inc, s0_co, s0_cr, anc


def _db(x):
    return 10.0 * np.log10(np.asarray(x, np.float64) + 1e-15)


def test_stream_skip_bit_identical_to_full_streams():
    """Missing streams + scalar dsig == explicit NaN/full streams (exact)."""
    inc, _, s0_cr, _ = _scene()
    tables = prepare_tables(None, "gmf_s1_v2", dtype=jnp.float64, **KW)

    # mono crosspol: no copol stream, no ancillary, scalar dsig
    src = _LazySource((inc.shape[0],), np.dtype(np.float64), inc,
                      s0_cr=s0_cr, dsig_cr=0.1, device_db=False)
    assert src.spec == (False, False, True, True, False, "full")
    co_s, dual_s = _invert_source(tables, src, mode="exact")

    nanv = np.full_like(inc, np.nan)
    co_f, dual_f = invert_pixels(tables, inc, nanv, _db(s0_cr),
                                 np.full_like(inc, 0.1),
                                 nanv + 0j, mode="exact")
    np.testing.assert_array_equal(dual_s, dual_f)
    np.testing.assert_array_equal(co_s, co_f)


def test_scalar_dsig_multi_piece_padding():
    """0-d dsig scalar survives tail-piece padding (multi-piece stream)."""
    inc, s0_co, s0_cr, anc = _scene(n=2500)
    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float64,
                            **KW)
    mk = lambda: _LazySource((2500,), np.dtype(np.float64), inc,
                             s0_co=s0_co, s0_cr=s0_cr, dsig_cr=0.1,
                             anc=anc, device_db=False)
    one = _invert_source(tables, mk(), mode="exact")
    many = _invert_source(tables, mk(), mode="exact", piece_size=1000)
    for a, b in zip(many, one):
        np.testing.assert_array_equal(a, b)


def test_device_db_auto_and_close_to_host_prep():
    """f32 kernel path auto-enables device dB; results ~host-prep."""
    inc, s0_co, s0_cr, anc = _scene(n=2048, seed=3)
    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float32,
                            **KW)
    f32 = np.dtype(np.float32)

    src_dev = _LazySource((2048,), f32, inc, s0_co=s0_co, s0_cr=s0_cr,
                          dsig_cr=0.1, anc=anc)
    assert src_dev.device_db is None
    co_d, dual_d = _invert_source(tables, src_dev, mode="triton_interpret")
    # auto-resolution is per call (shallow copy): the caller's source is
    # NOT stamped, so reusing it with mode='exact' keeps host dB prep
    assert src_dev.device_db is None
    # linear f32 on the wire when resolved for the kernel path
    src_lin = _LazySource((2048,), f32, inc, s0_co=s0_co, s0_cr=s0_cr,
                          dsig_cr=0.1, anc=anc, device_db=True)
    np.testing.assert_allclose(src_lin.piece(0, 8)[1],
                               s0_co[:8].astype(np.float32), rtol=0)

    src_host = _LazySource((2048,), f32, inc, s0_co=s0_co, s0_cr=s0_cr,
                           dsig_cr=0.1, anc=anc, device_db=False)
    co_h, dual_h = _invert_source(tables, src_host, mode="triton_interpret")
    assert src_host.device_db is False  # explicit choice respected

    for got, ref in ((co_d, co_h), (dual_d, dual_h)):
        sg, sr = np.abs(got), np.abs(ref)
        np.testing.assert_array_equal(np.isnan(sg), np.isnan(sr))
        m = ~np.isnan(sr)
        # f32-ulp dB differences flip at most one grid step, rarely
        assert np.max(np.abs(sg[m] - sr[m])) <= 0.5 + 1e-6
        assert np.mean(sg[m] != sr[m]) < 0.01


def test_exact_mode_keeps_host_prep():
    """The f64 exact path must not auto-enable device dB (ref parity)."""
    inc, s0_co, _, anc = _scene(n=512, seed=5)
    tables = prepare_tables("gmf_cmod5n", None, dtype=jnp.float64, **KW)
    src = _LazySource((512,), np.dtype(np.float64), inc, s0_co=s0_co,
                      dsig_cr=0.1, anc=anc)
    _invert_source(tables, src, mode="exact")
    assert not src.device_db  # unresolved (None) streams host-converted dB
    # dB (host-converted) on the wire
    piece = src.piece(0, 8)
    np.testing.assert_array_equal(piece[1], _db(s0_co[:8]))


def test_vector_incidence_bit_identical_and_small_on_wire():
    """Broadcastable inc (sample/line vector, scalar) ships the small
    vector + (lo, div) instead of a full-scene stream, and the device
    reconstruction is bit-identical to a host broadcast."""
    import pytest

    ny, nx = 40, 64
    rng = np.random.default_rng(11)
    inc_vec = np.linspace(18.0, 47.0, nx)
    wspd = rng.uniform(0.5, 45.0, (ny, nx))
    phi = rng.uniform(0.0, 360.0, (ny, nx))
    inc_full = np.broadcast_to(inc_vec, (ny, nx))
    s0_co = 10 ** ((-25.0 + 16.0 * np.log10(wspd + 1.0)
                    - 0.2 * (inc_full - 30.0)) / 10.0)
    s0_cr = 10 ** ((-35.0 + 0.6 * wspd - 0.1 * (inc_full - 30.0)) / 10.0)
    anc = wspd * np.exp(1j * np.deg2rad(phi))
    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float64,
                            **KW)
    f64 = np.dtype(np.float64)

    def run(inc_arg, **kw):
        src = _LazySource((ny, nx), f64, inc_arg, s0_co=s0_co, s0_cr=s0_cr,
                          dsig_cr=0.1, anc=anc, device_db=False)
        return src, _invert_source(tables, src, mode="exact", **kw)

    src_f, ref = run(np.ascontiguousarray(inc_full))
    assert src_f.spec[-1] == "full"

    for shape in ((nx,), (1, nx)):
        src_v, got = run(inc_vec.reshape(shape))
        assert src_v.spec[-1] == "sample"
        p = src_v.piece(0, 128)
        assert p[0].shape == (nx,) and tuple(p[1]) == (0, nx)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)

    # line vector: rebuild sigma0 so truth varies by line instead
    inc_line = np.linspace(18.0, 47.0, ny).reshape(ny, 1)
    inc_lf = np.broadcast_to(inc_line, (ny, nx))
    s0l = 10 ** ((-25.0 + 16.0 * np.log10(wspd + 1.0)
                  - 0.2 * (inc_lf - 30.0)) / 10.0)
    src_l = _LazySource((ny, nx), f64, inc_line, s0_co=s0l, s0_cr=s0_cr,
                        dsig_cr=0.1, anc=anc, device_db=False)
    assert src_l.spec[-1] == "line"
    got_l = _invert_source(tables, src_l, mode="exact")
    src_lr = _LazySource((ny, nx), f64, np.ascontiguousarray(inc_lf),
                         s0_co=s0l, s0_cr=s0_cr, dsig_cr=0.1, anc=anc,
                         device_db=False)
    ref_l = _invert_source(tables, src_lr, mode="exact")
    for a, b in zip(got_l, ref_l):
        np.testing.assert_array_equal(a, b)

    # scalar inc + multi-piece streaming (lo offsets exercise the gather)
    src_s = _LazySource((ny, nx), f64, np.float64(35.0), s0_co=s0_co,
                        s0_cr=s0_cr, dsig_cr=0.1, anc=anc, device_db=False)
    assert src_s.spec[-1] == "sample" and src_s._inc_div == 1
    got_s = _invert_source(tables, src_s, mode="exact", piece_size=512)
    src_sr = _LazySource((ny, nx), f64, np.full((ny, nx), 35.0),
                         s0_co=s0_co, s0_cr=s0_cr, dsig_cr=0.1, anc=anc,
                         device_db=False)
    ref_s = _invert_source(tables, src_sr, mode="exact")
    for a, b in zip(got_s, ref_s):
        np.testing.assert_array_equal(a, b)

    # non-broadcastable shapes are rejected with a clear error
    with pytest.raises(ValueError, match="broadcastable"):
        _LazySource((ny, nx), f64, np.zeros(ny), s0_co=s0_co,
                    dsig_cr=0.1, anc=anc)

    # multi-piece sample-vector streaming (piece boundary != row boundary)
    src_mp = _LazySource((ny, nx), f64, inc_vec, s0_co=s0_co, s0_cr=s0_cr,
                         dsig_cr=0.1, anc=anc, device_db=False)
    got_mp = _invert_source(tables, src_mp, mode="exact", piece_size=1000)
    for a, b in zip(got_mp, ref):
        np.testing.assert_array_equal(a, b)

    # the reconstruct wrapper composes with the kernel pipeline too
    t32 = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float32, **KW)
    f32 = np.dtype(np.float32)
    sv = _LazySource((ny, nx), f32, inc_vec, s0_co=s0_co, s0_cr=s0_cr,
                     dsig_cr=0.1, anc=anc)
    sf = _LazySource((ny, nx), f32, np.ascontiguousarray(inc_full),
                     s0_co=s0_co, s0_cr=s0_cr, dsig_cr=0.1, anc=anc)
    got_p = _invert_source(t32, sv, mode="triton_interpret")
    ref_p = _invert_source(t32, sf, mode="triton_interpret")
    for a, b in zip(got_p, ref_p):
        np.testing.assert_array_equal(a, b)


def test_source_reuse_across_modes_keeps_each_wire_format():
    """One source inverted kernel-then-exact: exact still bit-matches a
    fresh exact run (the kernel call must not pin device_db=True)."""
    inc, s0_co, s0_cr, anc = _scene(n=1024, seed=7)
    t32 = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float32, **KW)
    f32 = np.dtype(np.float32)

    src = _LazySource((1024,), f32, inc, s0_co=s0_co, s0_cr=s0_cr,
                      dsig_cr=0.1, anc=anc)
    _invert_source(t32, src, mode="triton_interpret")  # would auto device_db
    co_reused, dual_reused = _invert_source(t32, src, mode="exact")
    fresh = _LazySource((1024,), f32, inc, s0_co=s0_co, s0_cr=s0_cr,
                        dsig_cr=0.1, anc=anc)
    co_fresh, dual_fresh = _invert_source(t32, fresh, mode="exact")
    np.testing.assert_array_equal(co_reused, co_fresh)
    np.testing.assert_array_equal(dual_reused, dual_fresh)
