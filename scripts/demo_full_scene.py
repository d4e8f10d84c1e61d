"""Full-scene demo: invert 10^8 px end-to-end from disk (an EW scene).

Forward-models a Sentinel-1-EW-sized dual-pol scene (default 10^8 px)
band-by-band into on-disk ``np.memmap`` files, then runs the public
``invert_from_model`` on the memmap inputs. The streamed piece pipeline
keeps python-allocated host temporaries at O(piece) + outputs, no matter
the scene size — the round-2 eager path staged ~6 full-scene f64 copies
(~5 GB at this size) before the first transfer.

Run from the repository root: python scripts/demo_full_scene.py
     [--px 100000000] [--dir $TMPDIR/fullscene]
"""

import argparse
import os
import tempfile
import time
import tracemalloc

import numpy as np


def build_scene(d, n, nx=8192):
    """Forward-model the scene in 4M-px bands straight into memmaps."""
    import jax
    import jax.numpy as jnp

    from xsarsea_tpu.models import get_model

    ny = n // nx
    n = ny * nx
    shape = (ny, nx)
    os.makedirs(d, exist_ok=True)
    mm = {k: np.lib.format.open_memmap(
        os.path.join(d, f"{k}.npy"), mode="w+", dtype=dt, shape=shape)
        for k, dt in (("inc", np.float32), ("s0_co", np.float32),
                      ("s0_cr", np.float32), ("anc", np.complex64),
                      ("wspd", np.float32))}
    co_fn = jax.jit(get_model("gmf_cmod5n")._gmf_fn)
    cr_fn = jax.jit(get_model("gmf_s1_v2")._gmf_fn)
    rng = np.random.default_rng(0)
    rows = max(1, (1 << 22) // nx)
    inc_row = np.linspace(19.0, 47.0, nx, dtype=np.float32)
    for r0 in range(0, ny, rows):
        r1 = min(r0 + rows, ny)
        m = (r1 - r0, nx)
        wspd = rng.uniform(0.5, 45.0, m).astype(np.float32)
        phi = rng.uniform(-180.0, 180.0, m).astype(np.float32)
        inc = np.broadcast_to(inc_row, m) + rng.normal(0, 0.02, m)
        mm["inc"][r0:r1] = inc
        mm["wspd"][r0:r1] = wspd
        mm["s0_co"][r0:r1] = np.asarray(co_fn(inc, wspd, np.abs(phi)))
        mm["s0_cr"][r0:r1] = np.asarray(cr_fn(inc, wspd))
        mm["anc"][r0:r1] = ((wspd + rng.normal(0, 1.5, m)).clip(0.2)
                            * np.exp(1j * np.deg2rad(phi))).astype(np.complex64)
    for v in mm.values():
        v.flush()
    return shape


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--px", type=int, default=100_000_000)
    ap.add_argument("--dir",
                    default=os.path.join(tempfile.gettempdir(), "fullscene"))
    ap.add_argument("--skip-build", action="store_true")
    args = ap.parse_args()

    from xsarsea_tpu.windspeed import invert_from_model

    if not args.skip_build:
        t0 = time.time()
        shape = build_scene(args.dir, args.px)
        print(f"scene built: {shape} ({shape[0] * shape[1] / 1e6:.0f} Mpx) "
              f"in {time.time() - t0:.0f} s -> {args.dir}")

    mm = {k: np.load(os.path.join(args.dir, f"{k}.npy"), mmap_mode="r")
          for k in ("inc", "s0_co", "s0_cr", "anc", "wspd")}
    n = mm["inc"].size

    tracemalloc.start()
    t0 = time.time()
    wind_co, wind_dual = invert_from_model(
        mm["inc"], mm["s0_co"], mm["s0_cr"], ancillary_wind=mm["anc"],
        dsig_cr=0.1, model=("gmf_cmod5n", "gmf_s1_v2"))
    dt = time.time() - t0
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()

    outputs = wind_co.nbytes + wind_dual.nbytes
    rms = float(np.sqrt(np.nanmean(
        (np.abs(wind_dual[::97]) - mm["wspd"][::97]) ** 2)))
    print(f"inverted {n / 1e6:.0f} Mpx end-to-end (disk -> wind) in "
          f"{dt:.1f} s = {n / dt / 1e6:.2f} Mpx/s")
    print(f"python-allocated peak: {peak / 1e9:.2f} GB "
          f"(outputs {outputs / 1e9:.2f} GB -> temporaries "
          f"{(peak - outputs) / 1e9:.2f} GB)")
    print(f"dual-pol retrieval RMS vs truth: {rms:.3f} m/s")


if __name__ == "__main__":
    main()
