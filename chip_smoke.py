"""Smoke run of the main paths on an NVIDIA GPU, at full width.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the mesh paths: 4 cards vs 1 card

One card: a Sentinel-1 EW-sized dual-pol scene (10^8 px, incidence
19-47 deg along range, a smooth wind field with speckle, a NaN land
mask), generated on the card from ``--seed``, is inverted from host
memory by the public ``invert_from_model`` with the default
high-resolution LUTs (501 inc x 499 wspd x 181 phi), once through the
default path (the band-bucketed kernel) and once through the plain XLA
``exact`` path. Then the copol-only tables, ``sigma0_detrend`` on the same
scene, and the default multiscale ``Gradients(...).histogram`` on a
4096^2 image. Checks, each of which fails the run:

- inversion: on 4,096 pixels drawn across the scene, the grid nodes
  (copol and crosspol) equal the plain float64 numpy reference's
  (tests/inversion_reference.py) except at near-ties, where the
  reference's cost at our node is within 1e-4 of its own minimum
  (relative, or absolute below a cost of 1); RMS of |wind| vs the
  reference below 1e-3 m/s over the pixels that are not near-ties.
  Over the whole scene, on the same inputs, the kernel's nodes equal
  the exact path's, except at near-ties.
- copol-only: the same sample checks.
- detrend and streaks: equal to the same call on ``jax.devices("cpu")``
  in this process (detrend at rtol 1e-5; streaks: window totals at rtol
  1e-4, and at most 1e-3 of a window's weight in another angle bin —
  see ``compare_histograms``).

``--four-cards`` runs ``invert_scenes`` on a 4-wide data mesh,
``sharded_invert_pixels`` on (4, 1) and (2, 2) meshes and the
line-sharded streaks, each compared with the same call on one card:
the inversions must be equal; the streaks histograms as for the CPU
comparison above.

Prints the card's name and power limit, each phase's wall time and each
comparison; the last line is one JSON object. Exits non-zero without a
GPU or on any failed phase or comparison.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLE = 4096          # pixels compared with the float64 reference
NEAR_TIE = 1e-4        # relative cost gap that counts as a near-tie
RMS_LIMIT = 1e-3       # m/s, |wind| vs the float64 reference
ENL = 100.0            # speckle looks of the synthetic sigma0
SCENE_4 = (2048, 4096)  # --four-cards: each of the 4 scenes (8 Mpx)
PIXELS_4 = 1 << 22      # --four-cards: sharded_invert_pixels size


FAILED = []            # comparisons that failed; any makes the run fail


def check(ok, what):
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        FAILED.append(what)


def phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)
    return out


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ----------------------------------------------------------------- scene

def make_scene(ny, nx, seed):
    """Dual-pol EW-like scene, generated on the card in row bands.

    Returns host arrays: incidence (nx,) f32, sigma0 co/cr (ny, nx) f32
    (linear, NaN over land), ancillary wind (ny, nx) complex64.
    """
    import jax
    import jax.numpy as jnp

    from xsarsea_tpu.models import get_model

    co_fn = get_model("gmf_cmod5n")._gmf_fn
    cr_fn = get_model("gmf_s1_v2")._gmf_fn
    inc = np.linspace(19.0, 47.0, nx, dtype=np.float32)
    rows = max(1, (1 << 23) // nx)

    @jax.jit
    def band(r0, key):
        y = (r0 + jnp.arange(rows, dtype=jnp.float32))[:, None] / ny
        x = jnp.arange(nx, dtype=jnp.float32)[None, :] / nx
        wspd = (10.0 + 6.0 * jnp.sin(2 * jnp.pi * (1.3 * y + 0.2))
                * jnp.cos(jnp.pi * 1.7 * x)
                + 2.0 * jnp.sin(2 * jnp.pi * (3.0 * x + 2.0 * y)))
        wdir = 140.0 * x - 70.0 + 40.0 * jnp.sin(2 * jnp.pi * y)
        k = jax.random.split(key, 5)
        look = lambda kk: jax.random.gamma(kk, ENL, (rows, nx)) / ENL
        s0_co = co_fn(inc[None, :], wspd, jnp.abs(wdir)) * look(k[0])
        s0_cr = cr_fn(inc[None, :], wspd) * look(k[1])
        land = ((x - 0.82) / 0.12) ** 2 + ((y - 0.35) / 0.2) ** 2 < 1.0
        s0_co = jnp.where(land, jnp.nan, s0_co)
        s0_cr = jnp.where(land, jnp.nan, s0_cr)
        a_spd = jnp.clip(wspd + 1.5 * jax.random.normal(k[2], wspd.shape),
                         0.2)
        a_dir = jnp.deg2rad(wdir + 10.0 * jax.random.normal(k[3], wspd.shape))
        return s0_co, s0_cr, a_spd * jnp.cos(a_dir), a_spd * jnp.sin(a_dir)

    s0_co = np.empty((ny, nx), np.float32)
    s0_cr = np.empty((ny, nx), np.float32)
    anc = np.empty((ny, nx), np.complex64)
    key = jax.random.key(seed)
    for r0 in range(0, ny, rows):
        r1 = min(r0 + rows, ny)
        co, cr, are, aim = band(r0, jax.random.fold_in(key, r0))
        s0_co[r0:r1] = np.asarray(co)[:r1 - r0]
        s0_cr[r0:r1] = np.asarray(cr)[:r1 - r0]
        anc.real[r0:r1] = np.asarray(are)[:r1 - r0]
        anc.imag[r0:r1] = np.asarray(aim)[:r1 - r0]
    return inc, s0_co, s0_cr, anc


# ------------------------------------------------------------ comparisons

def merge(co, dual, got_co, got_dual):
    """The dual-pol merge of invert_from_model (windspeed.py:425-428):
    copol where either speed < 5 m/s. A speed on the 5.0 m/s grid node
    sits within rounding of the threshold (|5 e^{i phi}| is 5 +- 1 ulp,
    in f32 and in f64 alike): there the merge follows the decision the
    checked output made. Returns (merged, threshold-tie mask).
    """
    take = (np.abs(co) < 5) | (np.abs(dual) < 5)
    tie = ((np.abs(np.abs(co) - 5) < 1e-5) | (np.abs(np.abs(dual) - 5) < 1e-5)
           ) & ~np.isnan(co)
    took = (got_dual == got_co) | (np.isnan(got_dual) & np.isnan(got_co))
    take = np.where(tie, took, take)
    return np.where(take, co, dual), tie


def nearest(grid, values):
    return np.abs(grid[None, :] - values[:, None]).argmin(1)


def rel_gap(j, j_node):
    """Excess of a node's cost over the minimum, relative to the minimum
    (to 1 below 1: a cost is a sum of squared normalized residuals, and
    near zero its f32 rounding and the input's are absolute)."""
    jmin = j.min()
    return (j_node - jmin) / max(jmin, 1.0)


def copol_gaps(t, inc, s0_db, anc, winds):
    """Max near-tie gap of the copol node of each set of winds."""
    import inversion_reference as ref

    gap = np.zeros(len(inc))
    for n in range(len(inc)):
        j = ref.copol_cost(t, inc[n], s0_db[n], anc[n].real, anc[n].imag)
        for w in winds:
            iw = nearest(t["co_wspd"], np.abs(w[n:n + 1]))[0]
            ip = nearest(t["co_phir"], np.abs(np.angle(w[n:n + 1])))[0]
            gap[n] = max(gap[n], rel_gap(j, j[iw, ip]))
    return gap


def crosspol_gaps(t, inc, s0_db, dsig, wspd_co, dual, took_co):
    """Near-tie gap of the crosspol node behind each merged dual wind:
    its own node where the merge kept the dual wind, else the best node
    under 5 m/s (the merge then kept copol because dual < 5)."""
    import inversion_reference as ref

    gap = np.zeros(len(inc))
    for n in range(len(inc)):
        j = ref.crosspol_cost(t, inc[n], s0_db[n], dsig, wspd_co[n])
        if took_co[n]:
            gap[n] = rel_gap(j, j[t["cr_wspd"] < 5].min())
        else:
            gap[n] = rel_gap(j, j[nearest(t["cr_wspd"], np.abs(dual[n:n + 1]))[0]])
    return gap


def compare_with_reference(name, t, inc_px, s0_co, s0_cr, anc, dsig_cr,
                           got_co, got_dual):
    """Sample pixels vs the float64 reference: the same grid nodes but
    near-ties, and RMS of |wind| over the pixels that are not near-ties
    (a near-tie moves a node by one grid step, >= 0.1 m/s)."""
    import inversion_reference as ref

    inc_px = inc_px.astype(np.float64)
    anc = anc.astype(np.complex128)
    s0_co_db = ref.to_db(s0_co)
    s0_cr_db = ref.to_db(s0_cr) if s0_cr is not None \
        else np.full(len(inc_px), np.nan)
    r_co, r_dual = ref.invert(t, inc_px, s0_co_db, s0_cr_db,
                              np.full(len(inc_px), dsig_cr), anc)
    valid = ~np.isnan(r_co)
    check(np.array_equal(np.isnan(got_co), ~valid),
          f"{name} co: NaN pixels equal the reference's "
          f"({int((~valid).sum())} of {len(valid)})")
    co_tie = valid & (np.abs(got_co - r_co) > 1e-4)
    px = np.nonzero(co_tie)[0]
    gap = copol_gaps(t, inc_px[px], s0_co_db[px], anc[px], [got_co[px]])
    ties = co_tie.copy()
    outs = [("co", got_co, r_co)]
    if got_dual is not None:
        merged, m_tie = merge(r_co, r_dual, got_co, got_dual)
        check(np.array_equal(np.isnan(got_dual), np.isnan(merged)),
              f"{name} dual: NaN pixels equal the reference's")
        cr_tie = (~co_tie & ~m_tie & ~np.isnan(merged)
                  & (np.abs(got_dual - merged) > 1e-4))
        qx = np.nonzero(cr_tie)[0]
        took_co = got_dual[qx] == got_co[qx]
        gap = np.r_[gap, crosspol_gaps(
            t, inc_px[qx], s0_cr_db[qx], dsig_cr, np.abs(r_co[qx]),
            got_dual[qx], took_co)]
        ties |= cr_tie | m_tie
        outs.append(("dual", got_dual, merged))
        print(f"      {name}: {int(m_tie.sum())} sample pixels on the 5 m/s "
              f"merge threshold, {int(cr_tie.sum())} on another crosspol "
              "node", flush=True)
    print(f"      {name}: {int(co_tie.sum())} of {int(valid.sum())} sample "
          f"pixels on another copol node; near-ties in all "
          f"{int(ties.sum())} ({ties.sum() / max(valid.sum(), 1):.2e}), "
          f"max cost gap {gap.max(initial=0):.3e}", flush=True)
    check(bool(np.all(gap <= NEAR_TIE)),
          f"{name}: every node change is a near-tie (gap <= {NEAR_TIE:g})")
    for what, got, want in outs:
        m = ~np.isnan(want)
        d2 = (np.abs(got[m]) - np.abs(want[m])) ** 2
        rms = float(np.sqrt(np.mean(d2[~ties[m]])))
        print(f"      {name} {what}: RMS |wind| vs the reference over all "
              f"{int(m.sum())} valid sample pixels {np.sqrt(d2.mean()):.3e}"
              " m/s", flush=True)
        check(rms < RMS_LIMIT,
              f"{name} {what}: RMS |wind| vs float64 reference, near-ties "
              f"excluded, {rms:.3e} m/s")


def compare_paths(t, inc_vec, s0_co, s0_cr, anc, kernel, exact):
    """Whole scene, same inputs: kernel nodes == exact nodes but
    near-ties (the GPU compilers may round a cost differently)."""
    import inversion_reference as ref

    for what, a, b in (("co", kernel[0], exact[0]),
                       ("dual", kernel[1], exact[1])):
        check(np.array_equal(np.isnan(a), np.isnan(b)),
              f"kernel vs exact {what}: NaN pixels equal")
    nx = s0_co.shape[1]
    a, b = kernel[0].reshape(-1), exact[0].reshape(-1)
    da, db = kernel[1].reshape(-1), exact[1].reshape(-1)
    co_px = np.nonzero(~np.isnan(b) & (a != b))[0]
    cr_px = np.setdiff1d(np.nonzero(~np.isnan(db) & (da != db))[0], co_px)
    print(f"      kernel vs exact: {len(co_px)} of {b.size} pixels on "
          f"another copol node, {len(cr_px)} more on another crosspol "
          f"node ({(len(co_px) + len(cr_px)) / b.size:.2e})", flush=True)
    check(len(co_px) + len(cr_px) <= 1e-4 * b.size,
          "kernel vs exact: at most 1e-4 of the pixels differ")
    anc_f = anc.reshape(-1).astype(np.complex128)
    inc_f = lambda px: inc_vec[px % nx].astype(np.float64)
    gap = copol_gaps(t, inc_f(co_px), ref.to_db(s0_co.reshape(-1)[co_px]),
                     anc_f[co_px], [a[co_px], b[co_px]])
    s0_cr_db = ref.to_db(s0_cr.reshape(-1)[cr_px])
    for w, ww in ((da, a), (db, b)):
        gap = np.r_[gap, crosspol_gaps(
            t, inc_f(cr_px), s0_cr_db, 0.1, np.abs(b[cr_px]), w[cr_px],
            w[cr_px] == ww[cr_px])]
    check(bool(np.all(gap <= NEAR_TIE)),
          f"kernel vs exact: every difference is a near-tie (max gap "
          f"{gap.max(initial=0):.3e})")


# ---------------------------------------------------------------- phases

def one_card(args):
    import jax
    import jax.numpy as jnp

    from xsarsea_tpu import sigma0_detrend
    from xsarsea_tpu.models import get_model
    from xsarsea_tpu.windspeed import invert_from_model
    from xsarsea_tpu.windspeed.inversion import prepare_tables, resolve_mode
    import inversion_reference as ref

    ny, nx = args.lines, args.samples
    inc_vec, s0_co, s0_cr, anc = phase(
        f"scene ({ny}x{nx} px, generated on the card)", make_scene, ny, nx,
        args.seed)
    models = ("gmf_cmod5n", "gmf_s1_v2")

    def invert(mode, rows=None):
        # the exact path gets the kernel path's wire format (linear
        # sigma0, dB on the device): the same inputs, so the two differ
        # by their arithmetic alone
        sl = slice(None) if rows is None else slice(0, rows)
        return invert_from_model(
            inc_vec, s0_co[sl], s0_cr[sl], ancillary_wind=anc[sl],
            dsig_cr=0.1, model=models, mode=mode, device_db=True)

    mode = resolve_mode("auto", phase(
        "tables (high resolution, float32)", prepare_tables, *models,
        jnp.float32))
    print(f"      mode auto -> {mode}", flush=True)
    warm_rows = (1 << 23) // nx + 1   # two pieces: the streamed shape
    phase("dual-pol kernel: compile + warm-up (8 Mpx)", invert, mode,
          warm_rows)
    kernel = phase(f"dual-pol kernel invert_from_model ({ny * nx} px)",
                   invert, mode)
    phase("dual-pol exact: compile + warm-up (8 Mpx)", invert, "exact",
          warm_rows)
    exact = phase(f"dual-pol exact invert_from_model ({ny * nx} px)",
                  invert, "exact")

    t = ref.prepare(get_model(models[0]).to_lut(units="dB"),
                    get_model(models[1]).to_lut(units="dB"))
    rng = np.random.default_rng(args.seed)
    px = rng.choice(ny * nx, SAMPLE, replace=False)
    flat = lambda a: a.reshape(-1)[px]
    phase("compare: dual-pol sample vs float64 reference",
          compare_with_reference, "dual-pol", t, inc_vec[px % nx],
          flat(s0_co), flat(s0_cr), flat(anc), 0.1, flat(kernel[0]),
          flat(kernel[1]))
    phase("compare: exact sample vs float64 reference",
          compare_with_reference, "exact", t, inc_vec[px % nx], flat(s0_co),
          flat(s0_cr), flat(anc), 0.1, flat(exact[0]), flat(exact[1]))
    phase("compare: kernel vs exact, whole scene", compare_paths, t, inc_vec,
          s0_co, s0_cr, anc, kernel, exact)
    del exact

    def copol(rows=None):
        sl = slice(None) if rows is None else slice(0, rows)
        return invert_from_model(inc_vec, s0_co[sl], ancillary_wind=anc[sl],
                                 model=models[0], mode=mode)

    phase("copol-only kernel: compile + warm-up (8 Mpx)", copol, warm_rows)
    co_only = phase(f"copol-only kernel invert_from_model ({ny * nx} px)",
                    copol)
    t_co = ref.prepare(get_model(models[0]).to_lut(units="dB"))
    phase("compare: copol-only sample vs float64 reference",
          compare_with_reference, "copol-only", t_co, inc_vec[px % nx],
          flat(s0_co), None, flat(anc), 0.1, flat(co_only), None)
    del co_only, kernel

    inc2d = np.broadcast_to(inc_vec, (ny, nx))
    det = phase(f"detrend sigma0_detrend ({ny * nx} px)",
                lambda: np.asarray(sigma0_detrend(s0_co, inc2d)))
    cpu = jax.devices("cpu")[0]
    rows = slice(0, 64)
    with jax.default_device(cpu):
        det_cpu = np.asarray(sigma0_detrend(np.ascontiguousarray(s0_co[rows]),
                                            inc2d[rows]))
    ok = np.array_equal(np.isnan(det[rows]), np.isnan(det_cpu))
    m = ~np.isnan(det_cpu)
    rel = float(np.max(np.abs(det[rows][m] - det_cpu[m]) / np.abs(det_cpu[m])))
    check(ok and rel < 1e-5,
          f"detrend: first 64 lines equal the CPU run (max rel {rel:.2e})")
    del det

    h_gpu = phase("streaks Gradients 4096^2 x 2 pols: compile + run",
                  streaks_histogram, None)
    phase("streaks Gradients 4096^2 x 2 pols: steady", streaks_histogram,
          None)
    with jax.default_device(cpu):
        h_cpu = phase("streaks Gradients on the CPU (comparison)",
                      streaks_histogram, None)
    compare_histograms("streaks vs the CPU run", h_gpu, h_cpu)


def compare_histograms(name, got, want):
    """Two streaks histograms (weights, windows x angle bins) of the same
    image computed in different ways (another backend, another sharding).

    The window totals (the weights r*c summed) may differ only by
    summation order: rtol 1e-4. Per-bin equality cannot hold: a pixel
    whose gradient angle lies within rounding of a bin edge (atan2 and
    the stencils round differently) lands in the neighbouring bin. Such
    moves shift the circular cumulative histogram of a window by the
    moved weight, which must stay under 1e-3 of the window's weight (a
    few of its 1,600 pixels).
    """
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tot_g, tot_w = got.sum(-1), want.sum(-1)
    rel = float(np.max(np.abs(tot_g - tot_w) / np.maximum(tot_w, 1e-12)))
    check(np.allclose(tot_g, tot_w, rtol=1e-4, atol=0),
          f"{name}: window totals equal at rtol 1e-4 (max rel {rel:.2e})")
    norm = np.maximum(tot_w, 1e-12)[..., None]
    cdf = np.abs(np.cumsum(got - want, -1)) / norm
    cells = ~np.isclose(got, want, rtol=1e-4, atol=0)
    print(f"      {name}: {cells.mean():.2e} of the (window, bin) cells "
          "differ at rtol 1e-4", flush=True)
    check(float(cdf.max()) < 1e-3,
          f"{name}: weight moved between bins <= 1e-3 of a window "
          f"(max {cdf.max():.2e})")


def streaks_image(n=4096, seed=1):
    """Streak-like sigma0 tile with noise (the bench's synthetic tile)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:256, 0:256]
    tile = 1.0 + 0.5 * np.sin(0.35 * (x + 0.6 * y))
    return (np.abs(np.tile(tile, (n // 256, n // 256))
                   + 0.1 * rng.normal(size=(n, n))).astype(np.float32)
            + 0.01)


def streaks_histogram(_):
    """Default multiscale Gradients histogram weights (windows x bins)."""
    import jax

    from xsarsea_tpu.dimarray import DimArray
    from xsarsea_tpu.gradients import Gradients

    img = streaks_image()
    n = img.shape[0]
    da = DimArray(np.stack([img, 0.2 * img]), dims=("pol", "line", "sample"),
                  coords={"pol": np.array(["VV", "VH"]),
                          "line": np.arange(n) * 10.0,
                          "sample": np.arange(n) * 10.0})
    g = Gradients(da, windows_sizes=[1600, 3200], downscales_factors=[1, 2])
    return np.asarray(jax.block_until_ready(g.histogram["weight"].data),
                      np.float64)


def four_cards(args):
    import jax
    import jax.numpy as jnp

    from xsarsea_tpu.gradients import _angle_bin_centers
    from xsarsea_tpu.parallel import (invert_scenes, make_mesh,
                                      sharded_invert_pixels,
                                      sharded_streaks_histogram)
    from xsarsea_tpu.windspeed import prepare_tables
    from xsarsea_tpu.windspeed.inversion import resolve_mode

    devs = jax.devices()
    check(len(devs) == 4, f"four devices visible ({len(devs)})")
    tables = phase("tables (high resolution, float32)", prepare_tables,
                   "gmf_cmod5n", "gmf_s1_v2", jnp.float32)
    mode = resolve_mode("auto", tables)
    one = make_mesh(1, 1, devices=devs[:1])
    mesh4 = make_mesh(4, 1)

    def same(name, got, want):
        for g, w in zip(got, want):
            check(np.array_equal(g, w, equal_nan=True),
                  f"{name}: equal to the one-card result")

    # invert_scenes: 4 scenes of SCENE_4 pixels (dB inputs)
    ny, nx = SCENE_4
    inc_vec, s0_co, s0_cr, anc = phase(f"scenes (4 x {ny}x{nx} px)",
                                       make_scene, 4 * ny, nx, args.seed)
    with np.errstate(divide="ignore", invalid="ignore"):
        db = lambda a: 10 * np.log10(a + np.float32(1e-15))
    scenes = [dict(inc=np.broadcast_to(inc_vec, (ny, nx)),
                   sigma0_co_db=db(s0_co[i * ny:(i + 1) * ny]),
                   sigma0_cr_db=db(s0_cr[i * ny:(i + 1) * ny]),
                   dsig_cr=np.full((ny, nx), 0.1, np.float32),
                   ancillary_wind=anc[i * ny:(i + 1) * ny])
              for i in range(4)]
    want = phase("invert_scenes, one card", invert_scenes, tables, scenes,
                 one)
    phase("invert_scenes, 4-wide data mesh (compile + run)", invert_scenes,
          tables, scenes, mesh4)
    got = phase("invert_scenes, 4-wide data mesh", invert_scenes, tables,
                scenes, mesh4)
    for i, (g, w) in enumerate(zip(got, want)):
        same(f"invert_scenes scene {i}", g, w)

    # sharded_invert_pixels on (4, 1) with the data-parallel kernel path
    # and on (2, 2) with the exact path's phi-sharded LUT
    n = PIXELS_4
    rows = slice(0, n // nx)
    flat = lambda a: np.ascontiguousarray(a[rows].reshape(-1))
    pix = (np.tile(inc_vec, n // nx), db(flat(s0_co)), db(flat(s0_cr)),
           np.full(n, 0.1, np.float32), flat(anc))
    for shape, m in (((4, 1), mode), ((2, 2), "exact")):
        mesh = make_mesh(*shape)
        want = phase(f"sharded_invert_pixels mode={m}, one card",
                     sharded_invert_pixels, tables, *pix, one, 0.1, 256, m)
        got = phase(f"sharded_invert_pixels mode={m} on a {shape} mesh",
                    sharded_invert_pixels, tables, *pix, mesh, 0.1, 256, m)
        same(f"sharded_invert_pixels {shape}", got, want)

    # where the pixels run: the sharded kernel program's outputs
    fn = tables._invert_fn_cache.get(("sharded", mode, mesh4))
    if mode != "exact":
        k = 1 << 12
        outs = fn(*(jnp.asarray(a[:k], jnp.float32) for a in pix[:4]),
                  jnp.asarray(pix[4][:k].real), jnp.asarray(pix[4][:k].imag),
                  jnp.asarray(0.1, jnp.float32))
        shards = {sh.device.id: sh.data.shape[0]
                  for sh in outs[0].addressable_shards}
        check(sorted(shards) == sorted(d.id for d in devs)
              and set(shards.values()) == {k // 4},
              f"pixels land on all four devices ({shards})")

    img = streaks_image()
    win = 40
    centers = np.arange(win // 2, img.shape[0] // 4 - win // 2, win,
                        dtype=np.int32)
    bins = _angle_bin_centers(72).astype(np.float32)
    want = phase("line-sharded streaks, one card",
                 sharded_streaks_histogram, img, centers, centers, win, bins,
                 one)
    got = phase("line-sharded streaks, 4 cards", sharded_streaks_histogram,
                img, centers, centers, win, bins, mesh4)
    compare_histograms("line-sharded streaks vs one card", got[0], want[0])
    check(np.allclose(got[1], want[1], rtol=1e-4, atol=1e-6),
          "line-sharded streaks: used-pixel ratios equal at rtol 1e-4")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh paths, on 4 cards")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lines", type=int, default=10_000)
    ap.add_argument("--samples", type=int, default=10_000)
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    print(card_line(), flush=True)
    print(f"jax {jax.__version__}, devices: {jax.devices()}", flush=True)
    t0 = time.perf_counter()
    (four_cards if args.four_cards else one_card)(args)
    print(f"total: {time.perf_counter() - t0:.3f} s", flush=True)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} comparison(s) failed: {FAILED}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
