"""Multi-device scaling harness on a virtual CPU mesh.

Two measurements, runnable without accelerators (host-side CPU numbers,
not device times):

1. **Weak scaling** on a virtual CPU mesh: fixed pixels per device,
   1 -> N devices, data-parallel `sharded_invert_pixels` (exact mode).
   Per-step wall time should stay ~flat — the data axis is collective-free
   by construction, so any growth is host-side overhead, not communication.
   Each device count runs in a fresh subprocess (the virtual device count
   must be fixed before backend init).
2. **Bucket load balance** of `bucket_by_band` under data sharding: each
   device buckets its own pixel shard independently (shard_map), so the
   padded block count per shard IS its kernel-grid workload. Reported as
   max/mean block-count imbalance across shards for a realistic
   smooth-incidence EW scene and for a worst-case sorted-incidence layout.

The compiled sharded kernel path on real cards is checked by
``python chip_smoke.py --four-cards``.

Run from the repository root:
    python scripts/bench_scaling.py [--devices 1,2,4,8] [--px-per-device 262144]
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- child: weak run

def _weak_child(n_devices, px_per_device):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import time

    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from xsarsea_tpu.parallel import make_mesh, sharded_invert_pixels
    from xsarsea_tpu.windspeed import prepare_tables

    mesh = make_mesh(n_data=n_devices, n_model=1)
    kwargs = dict(inc_step=1.0, wspd_step=0.5, phi_step=5.0)
    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float32,
                            **kwargs)
    n = px_per_device * n_devices
    rng = np.random.default_rng(0)
    inc = rng.uniform(19.0, 45.0, n)
    s0_co_db = rng.uniform(-30.0, -5.0, n)
    s0_cr_db = rng.uniform(-40.0, -20.0, n)
    dsig_cr = np.full(n, 0.1)
    anc = rng.uniform(2.0, 20.0, n) * np.exp(
        1j * rng.uniform(-np.pi, np.pi, n))

    args = (tables, inc, s0_co_db, s0_cr_db, dsig_cr, anc)
    sharded_invert_pixels(*args, mesh=mesh, chunk_size=512)  # compile
    reps, best = 3, float("inf")
    for _ in range(reps):
        t0 = time.time()
        sharded_invert_pixels(*args, mesh=mesh, chunk_size=512)
        best = min(best, time.time() - t0)
    print(json.dumps({"devices": n_devices, "px": n, "step_s": round(best, 4),
                      "px_per_s_per_device": round(n / best / n_devices)}))


def weak_scaling(device_counts, px_per_device):
    rows = []
    for d in device_counts:
        env = dict(os.environ)
        env["_SCALING_CHILD"] = f"{d},{px_per_device}"
        env["JAX_PLATFORMS"] = "cpu"
        flags = [f for f in env.get("XLA_FLAGS", "").split()
                 if "xla_force_host_platform_device_count" not in f]
        flags.append(f"--xla_force_host_platform_device_count={d}")
        env["XLA_FLAGS"] = " ".join(flags)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)], env=env, cwd=REPO,
            capture_output=True, text=True, check=True)
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1]
        rows.append(json.loads(line))
        print(f"  weak: {rows[-1]}")
    base = rows[0]["step_s"]
    ncores = os.cpu_count() or 1
    print(f"\nweak scaling (fixed px/device, host has {ncores} core(s)):")
    print("| devices | total px | step (s) | vs 1-device | SPMD overhead |")
    print("|---|---|---|---|---|")
    for r in rows:
        d = r["devices"]
        # with fewer cores than devices the virtual mesh serializes, so
        # ideal step time is T(1) * D / min(D, ncores); the ratio to that
        # ideal isolates genuine SPMD overhead (collectives, partitioning)
        ideal = base * d / min(d, ncores)
        print(f"| {d} | {r['px']} | {r['step_s']:.3f} "
              f"| {r['step_s'] / base:.2f}x "
              f"| {r['step_s'] / ideal - 1:+.1%} |")
    return rows


# -------------------------------------------------- bucket load balance (host)

def bucket_balance(n_devices=8, n=1 << 23, block=32, n_bands=501):
    """Padded-block counts per shard = per-device kernel grid size
    (``block``: the kernel's ``ops.pallas_inversion.BLOCK``).

    Replicates bucket_by_band's padding arithmetic in numpy: each band's
    pixel count is rounded up to whole blocks, so a shard's workload is
    sum(ceil(count_b / block)).
    """
    def blocks_of(band_ids):
        counts = np.bincount(band_ids, minlength=n_bands)
        return int(np.sum((counts + block - 1) // block))

    rng = np.random.default_rng(0)
    # realistic EW scene: incidence sweeps smoothly across range samples
    nx = 8192
    inc_row = np.linspace(19.0, 47.0, nx)
    inc = np.tile(inc_row, n // nx) + rng.normal(0, 0.05, n)
    bands = np.clip(((inc - 16.0) / 0.1).round().astype(int), 0, n_bands - 1)

    rows = {}
    for name, order in (("row-major (realistic)", slice(None)),
                        ("sorted by incidence (worst case)",
                         np.argsort(inc, kind="stable"))):
        b = bands[order]
        shards = np.array_split(b, n_devices)
        work = [blocks_of(s) for s in shards]
        rows[name] = work
        print(f"  {name}: blocks/shard min={min(work)} max={max(work)} "
              f"mean={np.mean(work):.0f} imbalance={max(work) / np.mean(work):.3f}")
    return rows


def main():
    if os.environ.get("_SCALING_CHILD"):
        d, ppd = (int(x) for x in os.environ["_SCALING_CHILD"].split(","))
        _weak_child(d, ppd)
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--px-per-device", type=int, default=262144)
    args = ap.parse_args()
    print("bucket load balance (8 shards, 8.4 Mpx, high-res inc grid):")
    bucket_balance()
    print()
    weak_scaling([int(d) for d in args.devices.split(",")],
                 args.px_per_device)


if __name__ == "__main__":
    main()
