"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xsarsea_tpu.models import get_model
from xsarsea_tpu.parallel import make_mesh, sharded_invert_pixels
from xsarsea_tpu.windspeed import prepare_tables
from xsarsea_tpu.windspeed.inversion import invert_pixels


def make_pixels(n=700, seed=0):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(19.0, 45.0, n)
    speed = rng.uniform(1.5, 25.0, n)
    direc = rng.uniform(-np.pi, np.pi, n)
    co_fn = get_model("gmf_cmod5n")._gmf_fn
    cr_fn = get_model("gmf_s1_v2")._gmf_fn
    s0_co_db = 10 * np.log10(
        np.asarray(co_fn(inc, speed, np.abs(np.rad2deg(direc)))) + 1e-15)
    s0_cr_db = 10 * np.log10(np.asarray(cr_fn(inc, speed)) + 1e-15)
    anc = (speed + rng.normal(0, 2, n)).clip(0.3) * np.exp(1j * direc)
    dsig_cr = rng.uniform(0.1, 1.0, n)
    inc[0] = np.nan
    s0_co_db[1] = np.nan
    anc[2] = np.nan
    return inc, s0_co_db, s0_cr_db, dsig_cr, anc


@pytest.fixture(scope="module")
def tables():
    kwargs = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    return prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float64, **kwargs)


def test_devices_available():
    assert len(jax.devices()) >= 8


@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2), (2, 4)])
def test_sharded_inversion_matches_single_device(tables, n_data, n_model):
    inc, s0_co_db, s0_cr_db, dsig_cr, anc = make_pixels()
    mesh = make_mesh(n_data=n_data, n_model=n_model)

    co_ref, dual_ref = invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr,
                                     anc, mode="exact")
    co_sh, dual_sh = sharded_invert_pixels(tables, inc, s0_co_db, s0_cr_db,
                                           dsig_cr, anc, mesh=mesh)

    for got, ref in ((co_sh, co_ref), (dual_sh, dual_ref)):
        nan_g, nan_r = np.isnan(np.abs(got)), np.isnan(np.abs(ref))
        np.testing.assert_array_equal(nan_g, nan_r)
        m = ~nan_r
        np.testing.assert_allclose(got[m].real, ref[m].real, atol=1e-9)
        np.testing.assert_allclose(got[m].imag, ref[m].imag, atol=1e-9)


def test_sharded_crosspol_only_inversion(tables):
    """Crosspol-only tables through the sharded exact path (review
    finding: pad_tables_for_model_axis crashed on tables without a copol
    grid). Must match the single-device crosspol-only result."""
    inc, s0_co_db, s0_cr_db, dsig_cr, anc = make_pixels(n=300, seed=3)
    t_cr = prepare_tables(None, "gmf_s1_v2", dtype=jnp.float64,
                          inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    mesh = make_mesh(n_data=4, n_model=2)
    nanv = np.full_like(inc, np.nan)
    co_ref, dual_ref = invert_pixels(t_cr, inc, nanv, s0_cr_db, dsig_cr,
                                     nanv + 0j, mode="exact")
    co_sh, dual_sh = sharded_invert_pixels(t_cr, inc, nanv, s0_cr_db,
                                           dsig_cr, nanv + 0j, mesh=mesh)
    np.testing.assert_array_equal(co_sh, co_ref)
    np.testing.assert_array_equal(dual_sh, dual_ref)


def test_sharded_exact_program_cached(tables):
    """Repeat sharded_invert_pixels calls reuse ONE compiled program
    (review finding: fresh closures forced a retrace per call)."""
    inc, s0_co_db, s0_cr_db, dsig_cr, anc = make_pixels(n=256, seed=4)
    mesh = make_mesh(n_data=4, n_model=2)
    sharded_invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr, anc,
                          mesh=mesh, chunk_size=64)
    cache = tables.__dict__["_invert_fn_cache"]
    # the key for THIS (mesh, chunk_size) config (other tests in this
    # module may have populated keys for other configs already)
    fn_keys = [k for k in cache
               if k[0] == "sharded_exact" and k[1] == mesh and k[2] == 64]
    assert len(fn_keys) == 1
    jitted = cache[fn_keys[0]]
    n_before = jitted._cache_size()
    sharded_invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr,
                          anc, mesh=mesh, chunk_size=64)
    assert jitted._cache_size() == n_before  # no retrace on the 2nd call


def test_sharded_conv_halo_exchange():
    """Spatially-sharded convolution: XLA SPMD inserts the halo exchange."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from xsarsea_tpu.ops.conv2d import r2_reduce

    mesh = make_mesh(n_data=8, n_model=1)
    rng = np.random.default_rng(0)
    img = rng.uniform(0.1, 1.0, size=(256, 96))

    ref = np.asarray(r2_reduce(jnp.asarray(img)))

    sharding = NamedSharding(mesh, P("data", None))
    img_sh = jax.device_put(jnp.asarray(img), sharding)
    out = jax.jit(r2_reduce)(img_sh)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12, atol=1e-13)


def test_invert_scenes_batch(tables):
    """Multi-scene batch: matches per-scene single-device inversion."""
    from xsarsea_tpu.parallel import invert_scenes

    mesh = make_mesh(n_data=4, n_model=2)
    scenes = []
    for seed, (h, w) in enumerate([(20, 30), (16, 25)]):
        inc, s0_co, s0_cr, dsig_cr, anc = make_pixels(h * w, seed=seed)
        scenes.append(dict(
            inc=inc.reshape(h, w), sigma0_co_db=s0_co.reshape(h, w),
            sigma0_cr_db=s0_cr.reshape(h, w), dsig_cr=dsig_cr.reshape(h, w),
            ancillary_wind=anc.reshape(h, w)))

    outs = invert_scenes(tables, scenes, mesh, chunk_size=64)
    assert len(outs) == 2
    for scene, (co, dual) in zip(scenes, outs):
        n = scene["inc"].size
        co_ref, dual_ref = invert_pixels(
            tables, scene["inc"].reshape(-1), scene["sigma0_co_db"].reshape(-1),
            scene["sigma0_cr_db"].reshape(-1), scene["dsig_cr"].reshape(-1),
            scene["ancillary_wind"].reshape(-1), mode="exact")
        assert co.shape == scene["inc"].shape
        m = ~np.isnan(np.abs(co_ref))
        np.testing.assert_allclose(co.reshape(-1)[m], co_ref[m], atol=1e-9)
        np.testing.assert_allclose(dual.reshape(-1)[m], dual_ref[m], atol=1e-9)


def test_sharded_streaks_histogram_matches_single_device():
    """Full gradients pipeline (local_gradients -> windows -> histogram)
    spatially sharded over the mesh == the single-device Gradients2D
    result (reference map_overlap analog, gradients.py:649-667)."""
    from xsarsea_tpu.dimarray import DimArray
    from xsarsea_tpu.gradients import Gradients2D, streaks_histogram_core
    from xsarsea_tpu.parallel import sharded_streaks_histogram

    rng = np.random.default_rng(3)
    ny, nx = 512, 384
    y, x = np.mgrid[0:ny, 0:nx]
    img = np.abs(1.0 + 0.5 * np.sin(0.35 * (x + 0.6 * y))
                 + 0.1 * rng.normal(size=(ny, nx))) + 0.01

    da = DimArray(img, dims=("line", "sample"),
                  coords={"line": np.arange(ny, dtype=float),
                          "sample": np.arange(nx, dtype=float)})
    g = Gradients2D(da, window_size=128, window_step=1)
    ref = g.histogram  # single-device DimDataset
    ref_w = np.asarray(ref["weight"].data)
    ref_r = np.asarray(ref["used_ratio"].data)

    # the class's own window geometry, in lg pixels
    lg_line = np.asarray(g.local_gradients["G2_abs"].coords["line"])
    lg_sample = np.asarray(g.local_gradients["G2_abs"].coords["sample"])
    at = g.windows_at
    cl = np.abs(lg_line[None, :] - np.asarray(at["line"])[:, None]).argmin(1)
    cs = np.abs(lg_sample[None, :] - np.asarray(at["sample"])[:, None]).argmin(1)
    win = int(np.mean([128 / (lg_line[1] - lg_line[0]),
                       128 / (lg_sample[1] - lg_sample[0])]))
    bins = np.linspace(-np.pi / 2, np.pi / 2, 73)
    bins = (bins[1:] + bins[:-1]) / 2

    # the jit-able core reproduces the class pipeline exactly
    w_core, r_core = streaks_histogram_core(
        jnp.asarray(img), jnp.asarray(cl.astype(np.int32)),
        jnp.asarray(cs.astype(np.int32)), win, jnp.asarray(bins))
    np.testing.assert_allclose(
        np.asarray(w_core).reshape(ref_w.shape), ref_w, rtol=1e-12, atol=1e-13)

    # sharded over the 8-device mesh: halo exchange + window gathers by SPMD
    mesh = make_mesh(n_data=8, n_model=1)
    w_sh, r_sh = sharded_streaks_histogram(img, cl, cs, win, bins, mesh)
    np.testing.assert_allclose(w_sh, ref_w, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(r_sh, ref_r, rtol=1e-10, atol=1e-12)


def test_sharded_pallas_inversion_matches_single_device(tables):
    """Data-parallel kernel path over the mesh == single-device kernel
    path — pure SPMD, no collectives."""
    inc, s0_co_db, s0_cr_db, dsig_cr, anc = make_pixels(900, seed=3)
    # f32 tables for the kernel path
    kwargs = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    t32 = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float32,
                         **kwargs)
    mesh = make_mesh(n_data=8, n_model=1)

    co_ref, dual_ref = invert_pixels(t32, inc, s0_co_db, s0_cr_db, dsig_cr,
                                     anc, mode="triton_interpret")
    co_sh, dual_sh = sharded_invert_pixels(
        t32, inc, s0_co_db, s0_cr_db, dsig_cr, anc, mesh=mesh,
        mode="triton_interpret")

    for got, ref in ((co_sh, co_ref), (dual_sh, dual_ref)):
        nan_g, nan_r = np.isnan(np.abs(got)), np.isnan(np.abs(ref))
        np.testing.assert_array_equal(nan_g, nan_r)
        m = ~nan_r
        np.testing.assert_array_equal(got[m], ref[m])


def test_sharded_pallas_requires_data_only_mesh(tables):
    inc, s0_co_db, s0_cr_db, dsig_cr, anc = make_pixels(64)
    mesh = make_mesh(n_data=4, n_model=2)
    with pytest.raises(ValueError, match="model=1"):
        sharded_invert_pixels(tables, inc, s0_co_db, s0_cr_db, dsig_cr, anc,
                              mesh=mesh, mode="triton_interpret")


def test_invert_scenes_pallas_mode():
    """Multi-scene batch through the kernel's data-parallel path."""
    from xsarsea_tpu.parallel import invert_scenes

    kwargs = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    t32 = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float32,
                         **kwargs)
    mesh = make_mesh(n_data=8, n_model=1)
    scenes = []
    for seed, (h, w) in enumerate([(12, 20), (10, 16)]):
        inc, s0_co, s0_cr, dsig_cr, anc = make_pixels(h * w, seed=seed)
        scenes.append(dict(
            inc=inc.reshape(h, w), sigma0_co_db=s0_co.reshape(h, w),
            sigma0_cr_db=s0_cr.reshape(h, w), dsig_cr=dsig_cr.reshape(h, w),
            ancillary_wind=anc.reshape(h, w)))

    outs = invert_scenes(t32, scenes, mesh, mode="triton_interpret")
    for scene, (co, dual) in zip(scenes, outs):
        co_ref, dual_ref = invert_pixels(
            t32, scene["inc"].reshape(-1), scene["sigma0_co_db"].reshape(-1),
            scene["sigma0_cr_db"].reshape(-1), scene["dsig_cr"].reshape(-1),
            scene["ancillary_wind"].reshape(-1), mode="triton_interpret")
        m = ~np.isnan(np.abs(co_ref))
        np.testing.assert_array_equal(co.reshape(-1)[m], co_ref[m])
        np.testing.assert_array_equal(dual.reshape(-1)[m], dual_ref[m])


def test_sharded_unknown_mode_raises(tables):
    """Typos must not silently fall through to the exact path."""
    from xsarsea_tpu.parallel import make_mesh, sharded_invert_pixels

    mesh = make_mesh(n_data=2, n_model=1)
    n = 64
    rng = np.random.default_rng(0)
    args = (rng.uniform(18, 45, n), rng.uniform(-25, -5, n),
            rng.uniform(-35, -20, n), np.full(n, 0.2),
            (rng.uniform(3, 20, n) * np.exp(1j * rng.uniform(-3, 3, n))))
    with pytest.raises(ValueError, match="unknown inversion mode"):
        sharded_invert_pixels(tables, *args, mesh=mesh, mode="palas_fast")


def test_make_mesh_too_few_devices_raises():
    from xsarsea_tpu.parallel import make_mesh

    with pytest.raises(ValueError, match="mesh axes must be >= 1"):
        make_mesh(n_model=100)  # more model shards than devices


def test_sharded_streaks_fn_cached():
    """The jitted SPMD streaks program is reused across calls (review
    finding: a fresh jit(partial(...)) per call retraced every time)."""
    from xsarsea_tpu.parallel import make_mesh
    from xsarsea_tpu.parallel.gradients import _get_fn

    mesh = make_mesh(n_data=2, n_model=1)
    assert _get_fn(40, mesh) is _get_fn(40, mesh)
    assert _get_fn(40, mesh) is not _get_fn(20, mesh)


def test_invert_scenes_streams_lazy_scenes(tables):
    """invert_scenes never materializes a whole scene on host (VERDICT
    r4 #3): lazy duck-array scene members are sliced in O(piece) pieces
    through the mesh path, with multi-piece streaming and a padded tail,
    and the result matches the eager batch."""
    from test_streaming import LazyRows

    from xsarsea_tpu.parallel import invert_scenes

    mesh = make_mesh(n_data=4, n_model=2)
    eager, lazy = [], []
    for seed, (h, w) in enumerate([(40, 50), (30, 44)]):
        inc, s0_co, s0_cr, dsig_cr, anc = (
            a.reshape(h, w) for a in make_pixels(h * w, seed=seed))
        eager.append(dict(inc=inc, sigma0_co_db=s0_co, sigma0_cr_db=s0_cr,
                          dsig_cr=dsig_cr, ancillary_wind=anc))
        lazy.append(dict(
            inc=LazyRows(lambda a, b, x=inc: x[a:b], inc.shape),
            sigma0_co_db=LazyRows(lambda a, b, x=s0_co: x[a:b], s0_co.shape),
            sigma0_cr_db=LazyRows(lambda a, b, x=s0_cr: x[a:b], s0_cr.shape),
            dsig_cr=0.25,  # scalar: broadcast per piece, never O(scene)
            ancillary_wind=LazyRows(lambda a, b, x=anc: x[a:b], anc.shape,
                                    dtype=np.complex128),
        ))
        eager[-1]["dsig_cr"] = np.full((h, w), 0.25)

    piece = 1024  # 3320 px total -> 4 pieces, the last spanning a boundary
    ref = invert_scenes(tables, eager, mesh, chunk_size=64)
    got = invert_scenes(tables, lazy, mesh, chunk_size=64, piece_size=piece)

    for (co_r, dual_r), (co_g, dual_g) in zip(ref, got):
        np.testing.assert_array_equal(co_g, co_r)
        np.testing.assert_array_equal(dual_g, dual_r)

    # no scene member was ever materialized beyond one piece (+ partial
    # rows at both ends of the flat range)
    for scene, (h, w) in zip(lazy, [(40, 50), (30, 44)]):
        for name, arr in scene.items():
            if isinstance(arr, LazyRows):
                assert 0 < arr.max_request <= piece + 2 * w, (
                    f"{name}: materialized {arr.max_request} at once")


def test_invert_scenes_single_device_streamed(tables):
    """mesh=None routes through the single-device streamed source path
    and matches the mesh path bit-for-bit (mode='exact' both sides)."""
    from xsarsea_tpu.parallel import invert_scenes

    scenes = []
    for seed, (h, w) in enumerate([(18, 22), (12, 31)]):
        inc, s0_co, s0_cr, dsig_cr, anc = (
            a.reshape(h, w) for a in make_pixels(h * w, seed=seed))
        scenes.append(dict(inc=inc, sigma0_co_db=s0_co, sigma0_cr_db=s0_cr,
                           dsig_cr=dsig_cr, ancillary_wind=anc))

    mesh = make_mesh(n_data=8, n_model=1)
    ref = invert_scenes(tables, scenes, mesh, chunk_size=64, mode="exact")
    got = invert_scenes(tables, scenes, None, chunk_size=64, mode="exact")
    for (co_r, dual_r), (co_g, dual_g) in zip(ref, got):
        np.testing.assert_array_equal(co_g, co_r)
        np.testing.assert_array_equal(dual_g, dual_r)
