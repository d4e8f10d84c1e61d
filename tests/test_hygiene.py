"""Hygiene regression tests: packaged config, LUT cache isolation,
netCDF4-convention reads, small-grid nearest-index, window_step guards.

These pin the fixes from the round-1 review (stale caches keyed by id(),
mutable to_lut cache hits, reference-written netCDF4 LUT interop,
degenerate 2-point grids, zero-stride window steps).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from xsarsea_tpu.dimarray import DimArray
from xsarsea_tpu.models import get_model
from xsarsea_tpu.utils import get_test_file, load_config


# ---------------------------------------------------------------- config/L0

def test_packaged_config_exists_and_loads():
    import xsarsea_tpu

    pkg_cfg = os.path.join(os.path.dirname(xsarsea_tpu.__file__), "config.yml")
    assert os.path.isfile(pkg_cfg), "packaged config.yml must ship with the wheel"
    cfg = load_config()
    assert "data_dir" in cfg


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_python(code, **env):
    """Run ``code`` in a fresh CPU-only interpreter from the checkout."""
    full = {k: v for k, v in os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}
    full.update(JAX_PLATFORMS="cpu", PYTHONPATH=_REPO, **env)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=full,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_import_needs_no_optional_packages():
    """The package and the inversion, detrend and streaks entry points
    import with PyYAML, pandas, matplotlib and holoviews unavailable."""
    code = (
        "import sys\n"
        "for m in ('yaml', 'pandas', 'matplotlib', 'holoviews'):\n"
        "    sys.modules[m] = None  # import raises ImportError\n"
        "import xsarsea_tpu\n"
        "from xsarsea_tpu.windspeed import invert_from_model\n"
        "from xsarsea_tpu import sigma0_detrend\n"
        "from xsarsea_tpu.gradients import Gradients\n"
        "print('ok')\n")
    assert _run_python(code) == "ok"


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compilation_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, where set, is left to JAX; otherwise the
    cache sits at <checkout>/.jax_cache."""
    env = {}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    got = _run_python("import jax, xsarsea_tpu; "
                      "print(jax.config.jax_compilation_cache_dir)", **env)
    want = env.get("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(_REPO, ".jax_cache"))
    assert got == want


def test_get_test_file_local_short_circuit(tmp_path, monkeypatch):
    # a file already under data_dir is returned without any network access
    fname = "already_here.nc"
    (tmp_path / fname).write_bytes(b"x")
    monkeypatch.setattr(
        "xsarsea_tpu.utils.load_config", lambda: {"data_dir": str(tmp_path)})
    # re-bind the name used inside get_test_file's module
    import xsarsea_tpu.utils as u

    monkeypatch.setattr(u, "load_config", lambda: {"data_dir": str(tmp_path)})
    assert u.get_test_file(fname) == str(tmp_path / fname)


def test_get_test_file_file_url_and_unzip(tmp_path, monkeypatch):
    # protocol-flexible fetch: a file:// test_data_url works offline
    # through the urllib fallback, and the zip is extracted to data_dir
    import zipfile

    import xsarsea_tpu.utils as u

    src = tmp_path / "server"
    src.mkdir()
    with zipfile.ZipFile(src / "fix.zip", "w") as zf:
        zf.writestr("fix/a.txt", "payload")
    data = tmp_path / "data"
    data.mkdir()
    monkeypatch.setattr(u, "load_config", lambda: {
        "data_dir": str(data), "test_data_url": src.as_uri()})
    with pytest.warns(UserWarning, match="Downloading"):
        out = u.get_test_file("fix")
    assert out == str(data / "fix")
    assert (data / "fix" / "a.txt").read_text() == "payload"


def test_get_test_file_fsspec_filecache(tmp_path, monkeypatch):
    # when fsspec is importable, the download goes through
    # fsspec.open("filecache::<url>") with cache_storage under data_dir
    # (reference utils.py:83-95 semantics)
    import contextlib
    import sys
    import types
    import zipfile

    import xsarsea_tpu.utils as u

    blob = tmp_path / "fix.zip"
    with zipfile.ZipFile(blob, "w") as zf:
        zf.writestr("fix/b.txt", "cached")
    seen = {}

    def fake_open(url, **kw):
        seen["url"], seen["kw"] = url, kw
        return contextlib.closing(open(blob, "rb"))

    monkeypatch.setitem(sys.modules, "fsspec",
                        types.SimpleNamespace(open=fake_open))
    data = tmp_path / "data2"
    data.mkdir()
    monkeypatch.setattr(u, "load_config", lambda: {"data_dir": str(data)})
    with pytest.warns(UserWarning, match="Downloading"):
        out = u.get_test_file("fix")
    assert out == str(data / "fix")
    assert (data / "fix" / "b.txt").read_text() == "cached"
    assert seen["url"].startswith("filecache::https://")
    assert seen["kw"]["filecache"]["cache_storage"] == str(
        data / "fsspec_cache")


def test_get_test_file_missing_raises(tmp_path, monkeypatch):
    import xsarsea_tpu.utils as u

    monkeypatch.setattr(u, "load_config", lambda: {"data_dir": str(tmp_path)})
    # no download is attempted: fsspec unavailable, urllib failing
    monkeypatch.setitem(sys.modules, "fsspec", None)
    monkeypatch.setattr(
        "urllib.request.urlretrieve",
        lambda *a, **k: (_ for _ in ()).throw(OSError("no network")))
    with pytest.raises(RuntimeError, match="not found locally"):
        u.get_test_file("nope.zip")


# ------------------------------------------------------------ to_lut caching

def test_to_lut_cache_returns_fresh_container():
    m = get_model("gmf_cmod5n")
    a = m.to_lut(units="dB")
    a.attrs["units"] = "corrupted"
    b = m.to_lut(units="dB")
    assert b.attrs["units"] == "dB"
    assert a is not b


def test_to_lut_accepts_list_valued_kwargs():
    # list-valued kwargs must not blow up the cache key's hashability
    m = get_model("gmf_cmod5n")
    lut = m.to_lut(units="dB", inc_range=[16.0, 66.0])
    assert lut.dims == ("incidence", "wspd", "phi")
    # second call hits the cache with the same (normalized) key
    lut2 = m.to_lut(units="dB", inc_range=[16.0, 66.0])
    np.testing.assert_array_equal(np.asarray(lut.data), np.asarray(lut2.data))


# ------------------------------------------------- invert-fn cache lifetime

def test_invert_fn_cache_lives_on_tables_instance():
    from xsarsea_tpu.windspeed.inversion import (
        InversionTables, _get_invert_fn)

    inc = np.linspace(16.0, 66.0, 6)
    wspd = np.linspace(0.2, 50.0, 8)
    phi = np.linspace(0.0, 180.0, 5)
    lut = DimArray(
        np.random.default_rng(0).uniform(-30, 0, (6, 8, 5)),
        dims=("incidence", "wspd", "phi"),
        coords={"incidence": inc, "wspd": wspd, "phi": phi},
        attrs={"units": "dB"})
    t1 = InversionTables(lut_co_db=lut)
    f1 = _get_invert_fn(t1, 256, mode="exact")
    assert _get_invert_fn(t1, 256, mode="exact") is f1
    t2 = InversionTables(lut_co_db=lut)
    assert _get_invert_fn(t2, 256, mode="exact") is not f1
    assert "_invert_fn_cache" in t1.__dict__  # per-instance, GC'd with it


# ------------------------------------------------------- nearest index small

def test_nearest_index_uniform_two_point_grid():
    from xsarsea_tpu.ops.pallas_inversion import nearest_index_uniform

    # grid {0, 1}: below-range values must snap to index 0, not wrap to -1
    vals = jnp.asarray([-5.0, -0.2, 0.0, 0.49, 0.51, 1.0, 7.0])
    got = np.asarray(nearest_index_uniform(0.0, 1.0, 2, vals))
    np.testing.assert_array_equal(got, [0, 0, 0, 0, 1, 1, 1])


def test_nearest_index_uniform_matches_argmin_random():
    from xsarsea_tpu.ops.pallas_inversion import nearest_index_uniform

    rng = np.random.default_rng(1)
    for n in (2, 3, 4, 17):
        g0, step = 16.0, 0.5
        grid = g0 + step * np.arange(n)
        vals = rng.uniform(g0 - 2, grid[-1] + 2, 257)
        want = np.argmin(np.abs(grid[None, :] - vals[:, None]), axis=1)
        got = np.asarray(nearest_index_uniform(g0, step, n, jnp.asarray(vals)))
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ window_step validity

def test_window_step_zero_stride_raises():
    from xsarsea_tpu.gradients import Gradients2D

    rng = np.random.default_rng(0)
    img = DimArray(
        rng.uniform(0.1, 1.0, (64, 64)), dims=("line", "sample"),
        coords={"line": np.arange(64.0), "sample": np.arange(64.0)})
    g = Gradients2D(img, window_size=16, window_step=1e-3)
    with pytest.raises(ValueError, match="window_step"):
        _ = g.windows_at


# ------------------------------------------- reference netCDF4 LUT interop

def test_read_netcdf4_convention_lut(tmp_path):
    """Read an nc_lut_*.nc written with netCDF4-over-HDF5 conventions
    (dimension scales attached the way xarray/netCDF4 write them —
    reference models.py:232-262 writes its LUTs through xarray)."""
    h5py = pytest.importorskip("h5py")
    from xsarsea_tpu.io.lut_io import read_lut, read_lut_attrs
    from xsarsea_tpu.models.nc_lut import NcLutModel

    # grids chosen so the declared (range, step) attrs regenerate them
    # exactly — the model layer then normalizes without interpolation
    inc = np.linspace(17.0, 50.0, 12)       # step 3.0
    wspd = np.linspace(2.0, 40.0, 20)       # step 2.0
    phi = np.linspace(0.0, 180.0, 9)        # step 22.5
    data = np.random.default_rng(2).uniform(-35.0, 0.0, (12, 20, 9))

    path = tmp_path / "nc_lut_test_model_vv.nc"
    with h5py.File(path, "w") as f:
        for name, c in (("incidence", inc), ("wspd", wspd), ("phi", phi)):
            ds = f.create_dataset(name, data=c)
            ds.make_scale(name)
            # netCDF4 marks coordinate variables with these attrs
            ds.attrs["_Netcdf4Coordinates"] = np.array([0], dtype=np.int32)
        v = f.create_dataset("sigma0_model", data=data)
        for i, name in enumerate(("incidence", "wspd", "phi")):
            v.dims[i].attach_scale(f[name])
        f.attrs["units"] = np.bytes_("dB")
        f.attrs["pol"] = np.bytes_("VV")
        f.attrs["model"] = np.bytes_("test_model")
        f.attrs["resolution"] = np.bytes_("high")
        f.attrs["inc_range"] = np.array([17.0, 50.0])
        f.attrs["wspd_range"] = np.array([2.0, 40.0])
        f.attrs["phi_range"] = np.array([0.0, 180.0])
        f.attrs["inc_step"] = 3.0
        f.attrs["wspd_step"] = 2.0
        f.attrs["phi_step"] = 22.5

    attrs = read_lut_attrs(path)
    assert attrs["units"] == "dB" and attrs["pol"] == "VV"

    lut = read_lut(path)
    assert lut.dims == ("incidence", "wspd", "phi")
    np.testing.assert_allclose(np.asarray(lut.coords["incidence"]), inc)
    np.testing.assert_allclose(np.asarray(lut.data), data)

    # and the model layer on top of it registers + evaluates
    m = NcLutModel(str(path))
    out = m.to_lut(units="dB", resolution=None)
    assert out.dims == ("incidence", "wspd", "phi")
    np.testing.assert_allclose(np.asarray(out.data), data)


# ------------------------------------------------------- profiling utilities

def test_timing_logs_time_and_memory(caplog):
    import logging

    from xsarsea_tpu.utils import timing

    records = []

    @timing(logger=records.append)
    def work(x):
        return jnp.asarray(x) * 2

    out = work(np.arange(8.0))
    np.testing.assert_allclose(np.asarray(out), np.arange(8.0) * 2)
    assert len(records) == 1
    assert "timing work" in records[0] and "mem:" in records[0]


def test_device_memory_stats_shape():
    from xsarsea_tpu.utils import device_memory_stats

    stats = device_memory_stats()
    assert isinstance(stats, dict)  # {} on CPU is fine
    for v in stats.values():
        assert "bytes_in_use" in v


def test_trace_context(tmp_path):
    from xsarsea_tpu.utils import trace

    with trace(tmp_path / "trace"):
        jnp.arange(16.0).sum().block_until_ready()
    # a trace run produces a plugins/profile dir when the profiler works;
    # on backends without profiler support the context must still no-op
    # cleanly (no exception) — both outcomes pass


def test_to_lut_cached_buffer_is_frozen():
    """In-place mutation of a returned LUT raises instead of silently
    corrupting the cache (the payload is shared zero-copy)."""
    m = get_model("gmf_cmod5n")
    lut = m.to_lut(units="dB")
    data = np.asarray(lut.data)
    if isinstance(lut.data, np.ndarray):
        with pytest.raises(ValueError):
            data[0, 0, 0] = 999.0
    # either way the cache stays clean
    lut2 = m.to_lut(units="dB")
    assert not np.any(np.asarray(lut2.data) == 999.0)
