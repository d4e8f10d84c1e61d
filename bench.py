"""Headline benchmark: dual-pol Bayesian wind inversion throughput.

Synthetic Sentinel-1-EW-like dual-pol scene (VV via CMOD5n + VH via
gmf_s1_v2, high-resolution LUTs, ancillary prior) inverted through the
path ``resolve_mode`` picks for the device (the band-bucketed kernel on
a GPU). Needs an accelerator: without one it exits non-zero.

Prints ONE JSON line naming the device (platform, device_kind, count).

Budget discipline: the whole run targets ``BENCH_BUDGET_S`` seconds
(default 460) measured from process start. The headline is measured
FIRST among the expensive sections; every later section is skipped when
the remaining budget is smaller than its cost estimate (recorded under
``skipped_sections``), and a SIGTERM from an external timeout emits the
JSON line with everything measured so far.
"""

import json
import os
import signal
import sys
import time

import numpy as np

T_START = time.time()
DEADLINE = T_START + float(os.environ.get("BENCH_BUDGET_S", "460"))

RESULTS = {}
SKIPPED = []
_EMITTED = False


def _remaining():
    return DEADLINE - time.time()


def emit():
    """Print the single JSON result line from whatever has been measured.

    Idempotent: the signal handler and the normal end-of-run path share
    it, and only the first call prints.
    """
    global _EMITTED
    if _EMITTED:
        return
    _EMITTED = True
    r = dict(RESULTS)
    mpx_s = r.pop("headline_mpx_s", None)
    backend = r.get("device", {}).get("kind", "unknown")
    parity = r.get("kernel_vs_exact_max_dev_m_s")
    parity_str = (f"kernel vs exact max dev {parity:g} m/s, "
                  if parity is not None else "")
    rms = r.get("rms_vs_truth_noisy_m_s")
    rms_str = (f"RMS vs truth on noisy synthetic scene {rms:.3f} m/s "
               "[not a parity metric], " if rms is not None else "")
    e2e = r.get("e2e_from_host_mpx_s")
    e2e_str = f"from-host e2e {e2e:.2f} Mpx/s, " if e2e is not None else ""
    out = {
        "metric": "dual-pol inversion throughput, device-resident inputs "
                  f"({backend}, mode={r.pop('mode', '?')}, {parity_str}"
                  f"{rms_str}{e2e_str}"
                  f"wall {time.time() - T_START:.0f}s)",
        "value": round(mpx_s, 3) if mpx_s is not None else None,
        "unit": "Mpx/s/chip",
        **r,
    }
    if SKIPPED:
        out["skipped_sections"] = SKIPPED
    print(json.dumps(out), flush=True)


def _on_term(signum, frame):
    # external timeout: salvage the record, then die promptly. stderr
    # note so a human reading the driver tail sees what happened.
    print(f"bench: signal {signum} after {time.time() - T_START:.0f}s — "
          "emitting partial record", file=sys.stderr, flush=True)
    SKIPPED.append(f"interrupted_by_signal_{signum}")
    emit()
    os._exit(0)


def section(name, est_cost_s, fn, *, required=False):
    """Run one measurement section under the wall-clock budget.

    Skips (recording why) when the remaining budget is below the cost
    estimate — unless ``required`` (the headline must always run). A
    section failure records the exception instead of killing the run.
    """
    if not required and _remaining() < est_cost_s:
        SKIPPED.append(f"{name} (budget: {_remaining():.0f}s left, "
                       f"needs ~{est_cost_s:.0f}s)")
        print(f"bench: SKIP {name} ({_remaining():.0f}s left)",
              file=sys.stderr, flush=True)
        return None
    t0 = time.time()
    try:
        out = fn()
        print(f"bench: {name} done in {time.time() - t0:.1f}s "
              f"({_remaining():.0f}s left)", file=sys.stderr, flush=True)
        return out
    except Exception as e:  # noqa: BLE001 — one section must not kill the record
        SKIPPED.append(f"{name} ({type(e).__name__}: {e})")
        print(f"bench: FAIL {name}: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return None


def _synthetic_tile(ny, nx, seed):
    """Shared synthetic streak scene (ONE source: the streaks and
    gradients-class rates must stay comparable — two drifting copies of
    this block would silently decouple them)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:256, 0:256]
    tile = 1.0 + 0.5 * np.sin(0.35 * (x + 0.6 * y))
    return np.abs(np.tile(tile, (ny // 256, nx // 256))
                  + 0.1 * rng.normal(size=(ny, nx))).astype(np.float32) + 0.01


def bench_detrend():
    """sigma0_detrend rate: public API end-to-end, numpy in -> numpy out,
    including both transfers."""
    from xsarsea_tpu import sigma0_detrend

    ny, nx = 4096, 2048
    rng = np.random.default_rng(3)
    inc2d = np.tile(np.linspace(18.0, 47.0, nx), (ny, 1))
    s0 = rng.uniform(1e-3, 0.2, (ny, nx))
    sigma0_detrend(s0, inc2d)  # compile + warm
    best = 0.0
    for _ in range(3):
        t0 = time.time()
        out = sigma0_detrend(s0, inc2d)  # numpy out: materialized
        best = max(best, ny * nx / (time.time() - t0) / 1e6)
    assert np.isfinite(out).all()
    return best


def bench_streaks():
    """Wind-streak histogram pipeline rate.

    One jitted streaks_histogram_core pass (R2 -> Scharr local gradients
    -> windowed 72-bin histograms) on an EW-chip-sized tile; reported as
    input megapixels per second, steady state, device-resident.
    """
    import jax
    import jax.numpy as jnp

    from xsarsea_tpu.gradients import hist_bin_form, streaks_histogram_core

    ny, nx = 4096, 4096
    img = _synthetic_tile(ny, nx, seed=1)

    win = 40  # 160-px windows in lg pixels (factor-4 reduced grid)
    step = win
    n_lg = ny // 4
    centers = np.arange(win // 2, n_lg - win // 2, step, dtype=np.int32)
    bins = np.linspace(-np.pi / 2, np.pi / 2, 73)
    bins = ((bins[1:] + bins[:-1]) / 2).astype(np.float32)

    from functools import partial

    fn = jax.jit(partial(streaks_histogram_core, window=win,
                         bin_form=hist_bin_form()))
    img_d = jnp.asarray(img)
    cl = jnp.asarray(centers)
    bins_d = jnp.asarray(bins)
    out = fn(img_d, centers_l=cl, centers_s=cl, angles_bins=bins_d)
    jax.block_until_ready(out)
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        out = fn(img_d, centers_l=cl, centers_s=cl, angles_bins=bins_d)
    jax.block_until_ready(out)
    return ny * nx * reps / (time.time() - t0) / 1e6


def bench_gradients_class():
    """Full multiscale Gradients class rate (the user-facing fan-out).

    2 pols x 2 downscale factors x 2 window sizes on a 2048^2-per-pol
    scene, including class construction, windows_at alignment and
    stacking per rep — not just the single-scale fused core. Reported as
    input megapixels (base image x pols) per second, steady state,
    device-resident input.
    """
    import jax
    import jax.numpy as jnp

    from xsarsea_tpu.dimarray import DimArray
    from xsarsea_tpu.gradients import Gradients

    ny = nx = 2048
    base = _synthetic_tile(ny, nx, seed=2)
    img = np.stack([base, 0.2 * base])
    img_d = jax.block_until_ready(jnp.asarray(img))
    da = DimArray(img_d, dims=("pol", "line", "sample"),
                  coords={"pol": np.array(["VV", "VH"]),
                          "line": np.arange(ny) * 10.0,
                          "sample": np.arange(nx) * 10.0})

    def run():
        g = Gradients(da, windows_sizes=[1600, 3200],
                      downscales_factors=[1, 2])
        h = g.histogram
        jax.block_until_ready(h["weight"].data)
        return h

    run()  # compile
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        run()
    return img.size * reps / (time.time() - t0) / 1e6


def _register_synthetic_cmod7():
    """Register a CMOD7 model from a synthesized KNMI binary table.

    The real KNMI file cannot be fetched here (zero egress); the table is
    cmod5n evaluated on CMOD7's native grid (250 wspd x 73 phi x 51 inc,
    reference cmod7.py:31-44), written in the packed Fortran-ordered
    binary format and loaded through the production reader + native codec
    — so the bench exercises the full CMOD7 loader/normalizer path at the
    high-resolution grid.
    """
    import tempfile
    from pathlib import Path

    from xsarsea_tpu.models import available_models, get_model
    from xsarsea_tpu.models.cmod7 import register_cmod7

    if "gmf_cmod7" in available_models().index:
        return
    wspd = np.arange(0.2, 50.0 + 0.2, 0.2)
    phi = np.arange(0.0, 180.0 + 2.5, 2.5)
    inc = np.arange(16.0, 66.0 + 1.0, 1.0)
    vals = np.asarray(get_model("gmf_cmod5n")(inc, wspd, phi).data)
    table = np.ascontiguousarray(vals.transpose(1, 2, 0))  # (wspd, phi, inc)
    flat = np.concatenate([
        np.array([0.0], np.float32),
        table.astype(np.float32).reshape(-1, order="F"),
        np.array([0.0], np.float32)])
    d = Path(tempfile.mkdtemp(prefix="cmod7_bench_")) / "cmod7"
    d.mkdir()
    flat.astype("<f4").tofile(d / "gmf_cmod7_vv.dat_little_endian")
    register_cmod7(str(d))


def _ensure_native_lutio(timeout_s=120):
    """Build the native LUT codec in-place when absent (the
    bench must exercise the production decoder, not the
    pure-Python fallback). Returns True when the native module imports."""
    import importlib
    import subprocess
    from pathlib import Path

    try:
        importlib.import_module("xsarsea_tpu._lutio")
        return True
    except ImportError:
        pass
    try:
        subprocess.run(
            [sys.executable, "setup.py", "build_ext", "--inplace"],
            cwd=Path(__file__).parent, capture_output=True,
            timeout=timeout_s, check=True)
        # the package dir may already sit in the FileFinder mtime cache
        # (scanned this very second): without invalidation the fresh .so
        # is invisible and the bench would silently time the fallback
        importlib.invalidate_caches()
        importlib.import_module("xsarsea_tpu._lutio")
        return True
    except Exception:  # noqa: BLE001 — toolchain absent: fallback is used
        return False


def main():
    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench: needs an accelerator, JAX found only the CPU",
              file=sys.stderr)
        return 2
    RESULTS["device"] = {"platform": dev.platform,
                         "kind": dev.device_kind,
                         "count": len(jax.devices())}
    RESULTS["xla_flags"] = os.environ.get("XLA_FLAGS", "")
    try:
        _main_body()
    except Exception as e:  # noqa: BLE001 — salvage whatever was measured
        SKIPPED.append(f"crashed: {type(e).__name__}: {e}")
        import traceback

        traceback.print_exc()
    finally:
        emit()
    return 0


def _main_body():
    import jax
    import jax.numpy as jnp

    RESULTS["native_lutio"] = _ensure_native_lutio()

    from xsarsea_tpu.models import get_model
    from xsarsea_tpu.windspeed.inversion import (_get_invert_fn,
                                                 _invert_source, _LazySource,
                                                 invert_pixels,
                                                 prepare_tables,
                                                 resolve_mode)

    m_co = get_model("gmf_cmod5n")
    m_cr = get_model("gmf_s1_v2")
    tables = prepare_tables(m_co, m_cr, dtype=jnp.float32)
    mode = resolve_mode("auto", tables)
    RESULTS["mode"] = mode

    d = section("detrend", 40, bench_detrend)
    if d is not None:
        RESULTS["detrend_mpx_s"] = round(d, 1)

    n = 1 << 23  # 8.4 Mpx
    nxv = 4096  # scene width for the 2-D / vector-incidence shapes
    rng = np.random.default_rng(0)
    inc = rng.uniform(18.0, 47.0, n)
    wspd = rng.uniform(0.5, 45.0, n)
    phi = rng.uniform(0.0, 360.0, n)

    # forward-model the scene (not timed)
    s0_co_db = 10 * np.log10(
        np.asarray(m_co(inc, wspd, phi, broadcast=True)) + 1e-15)
    s0_cr_db = 10 * np.log10(
        np.asarray(m_cr(inc, wspd, broadcast=True)) + 1e-15)
    anc = (wspd + rng.normal(0, 1.5, n)).clip(0.2) * np.exp(
        1j * np.deg2rad(phi))
    dsig_cr = np.full(n, 0.1)

    # ---- HEADLINE (always runs): steady-state inversion rate with
    # device-resident inputs
    reps = 3
    dev = [jnp.asarray(np.ascontiguousarray(a, np.float32)) for a in
           (inc, s0_co_db, s0_cr_db, dsig_cr, anc.real, anc.imag)]
    dev.append(jnp.asarray(0.1, jnp.float32))

    def rate(fn):
        jax.block_until_ready(fn(*dev))
        t0 = time.time()
        for _ in range(reps):
            out = fn(*dev)
        jax.block_until_ready(out)
        return n * reps / (time.time() - t0) / 1e6

    def headline():
        RESULTS["headline_mpx_s"] = rate(_get_invert_fn(tables, 8192,
                                                        mode=mode))
        # RMS vs truth for the metric string (1M-px subsample)
        ns = min(n, 1 << 20)
        co, dual = invert_pixels(tables, inc[:ns], s0_co_db[:ns],
                                 s0_cr_db[:ns], dsig_cr[:ns], anc[:ns],
                                 mode=mode)
        RESULTS["rms_vs_truth_noisy_m_s"] = round(float(
            np.sqrt(np.nanmean((np.abs(dual) - wspd[:ns]) ** 2))), 3)

    section("headline", 0, headline, required=True)

    # ---- CMOD7 high-res-LUT variant: same grid shapes
    def cmod7():
        _register_synthetic_cmod7()
        tables7 = prepare_tables(get_model("gmf_cmod7"), m_cr,
                                 dtype=jnp.float32,
                                 inc_step=0.1, wspd_step=0.1, phi_step=1.0)
        RESULTS["cmod7_mpx_s"] = round(
            rate(_get_invert_fn(tables7, 8192, mode=mode)), 3)
        # drop the extra closure (it pins a duplicate set of LUT
        # operands on device) before the remaining sections
        tables7.__dict__.pop("_invert_fn_cache", None)

    section("cmod7", 45, cmod7)

    # ---- copol-only VV inversion: no crosspol table, so the pipeline
    # compiles without the crosspol stage; the call signature is unchanged
    def copol():
        tables_co = prepare_tables(m_co, None, dtype=jnp.float32)
        RESULTS["copol_mpx_s"] = round(
            rate(_get_invert_fn(tables_co, 8192, mode=mode)), 3)
        tables_co.__dict__.pop("_invert_fn_cache", None)

    section("copol", 45, copol)

    # ---- parity ON THIS DEVICE: the timed path vs the exact XLA path on
    # a 64k-px subsample (expected: identical but for near-ties)
    def parity():
        ns = 1 << 16  # the exact path per-pixel-gathers ~360 KB of LUT
        sub = tuple(a[:ns] for a in (inc, s0_co_db, s0_cr_db, dsig_cr, anc))
        co_p, dual_p = invert_pixels(tables, *sub, mode=mode)
        co_x, dual_x = invert_pixels(tables, *sub, mode="exact")
        diffs = [np.nanmax(np.abs(np.nan_to_num(np.abs(a) - np.abs(b))))
                 for a, b in ((co_p, co_x), (dual_p, dual_x))]
        RESULTS["kernel_vs_exact_max_dev_m_s"] = float(max(diffs))

    section("parity", 70, parity)

    # ---- streaks + multiscale gradients
    s = section("streaks", 45, bench_streaks)
    if s is not None:
        RESULTS["streaks_mpx_s"] = round(s, 1)
    g = section("gradients_class", 80, bench_gradients_class)
    if g is not None:
        RESULTS["gradients_class_mpx_s"] = round(g, 1)

    # ---- end-to-end from host memory: the public streamed path with the
    # production wire format — LINEAR f32 sigma0 (dB conversion fused
    # into the device pipeline), scalar dsig_cr not streamed, vector
    # incidence (SAR incidence varies along range only: ships O(nx), not
    # O(n)) — 16 B/px. Device-resident outputs.
    s0_co_lin32 = np.power(10.0, s0_co_db / 10.0).astype(np.float32)
    s0_cr_lin32 = np.power(10.0, s0_cr_db / 10.0).astype(np.float32)
    nyv = n // nxv
    inc_vec = np.linspace(18.0, 47.0, nxv).astype(np.float32)

    def e2e_host():
        src = _LazySource(
            (nyv, nxv), np.dtype(np.float32), inc_vec,
            s0_co=s0_co_lin32.reshape(nyv, nxv),
            s0_cr=s0_cr_lin32.reshape(nyv, nxv),
            dsig_cr=0.1, anc=anc.reshape(nyv, nxv))
        best = 0.0
        for _ in range(2):
            t0 = time.time()
            co_d, dual_d = _invert_source(tables, src, mode=mode,
                                          device_output=True)
            jax.block_until_ready((co_d, dual_d))
            best = max(best, n / (time.time() - t0) / 1e6)
            del co_d, dual_d
        RESULTS["e2e_from_host_mpx_s"] = round(best, 2)

    section("e2e_from_host", 40, e2e_host)

    # ---- end-to-end from DISK through the public API: invert_from_model
    # on memmapped npy inputs, host outputs — the full user-shaped path
    # including piece streaming, device compute and the d2h result copy
    import shutil
    import tempfile

    scene_dir = tempfile.mkdtemp(prefix="bench_e2e_")
    np.save(os.path.join(scene_dir, "inc.npy"), inc)
    np.save(os.path.join(scene_dir, "s0_co.npy"), s0_co_lin32)
    np.save(os.path.join(scene_dir, "s0_cr.npy"), s0_cr_lin32)
    np.save(os.path.join(scene_dir, "anc.npy"), anc)

    def e2e_disk():
        from xsarsea_tpu.windspeed import invert_from_model

        mm = lambda k: np.load(os.path.join(scene_dir, k + ".npy"),
                               mmap_mode="r").reshape(nyv, nxv)
        best = 0.0
        for _ in range(2):
            t0 = time.time()
            co, dual = invert_from_model(
                mm("inc"), mm("s0_co"), mm("s0_cr"),
                ancillary_wind=mm("anc"), dsig_cr=0.1,
                model=("gmf_cmod5n", "gmf_s1_v2"), mode=mode)
            best = max(best, n / (time.time() - t0) / 1e6)
            del co, dual
        RESULTS["e2e_disk_mpx_s"] = round(best, 2)

    try:
        section("e2e_disk", 45, e2e_disk)
    finally:
        shutil.rmtree(scene_dir, ignore_errors=True)

    # ---- host prep rate of the streamed public-API path (piece slicing,
    # complex split, f32 cast; the dB conversion runs fused on device)
    def host_prep():
        src = _LazySource((n,), np.dtype(np.float32), inc,
                          s0_co=s0_co_lin32, s0_cr=s0_cr_lin32,
                          dsig_cr=0.1, anc=anc, device_db=True)
        t0 = time.time()
        for lo in range(0, n, 1 << 22):
            src.piece(lo, min(lo + (1 << 22), n))
        RESULTS["host_prep_mpx_s"] = round(n / (time.time() - t0) / 1e6, 1)

    section("host_prep", 10, host_prep)


if __name__ == "__main__":
    sys.exit(main())
