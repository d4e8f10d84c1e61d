"""Multi-scene batch inversion over a device mesh.

Shards a batch of dual-pol scenes over the mesh's 'data' axis and runs
the inversion per device (the band-bucketed kernel on GPUs, the exact
XLA path on CPUs). On a machine without multiple accelerators this
self-hosts on a virtual CPU mesh; the same code runs unchanged on a
multi-GPU host — inversion is embarrassingly parallel per pixel.
"""

import os

# Demonstrated on a virtual 8-device CPU mesh by default so it runs
# anywhere (flags must be set BEFORE jax initializes). On a multi-GPU
# host set XSARSEA_MULTICHIP_BACKEND=native to use the actual devices.
_USE_CPU_MESH = os.environ.get("XSARSEA_MULTICHIP_BACKEND", "cpu") == "cpu"
if _USE_CPU_MESH:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import jax

if _USE_CPU_MESH:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from xsarsea_tpu.models import get_model
from xsarsea_tpu.parallel import invert_scenes, make_mesh
from xsarsea_tpu.windspeed import prepare_tables


def make_scene(h, w, seed):
    rng = np.random.default_rng(seed)
    inc = np.linspace(20.0, 45.0, w)[None, :].repeat(h, 0)
    wspd = rng.uniform(3.0, 22.0, (h, w))
    wdir = rng.uniform(0.0, 360.0, (h, w))
    m_co, m_cr = get_model("gmf_cmod5n"), get_model("gmf_s1_v2")
    s0_co = np.asarray(m_co(inc, wspd, wdir, broadcast=True))
    s0_cr = np.asarray(m_cr(inc, wspd, broadcast=True))
    anc = (wspd + rng.normal(0, 1.5, (h, w))).clip(0.2) * np.exp(
        1j * np.deg2rad(wdir))
    return dict(
        inc=inc,
        sigma0_co_db=10 * np.log10(s0_co + 1e-15),
        sigma0_cr_db=10 * np.log10(s0_cr + 1e-15),
        dsig_cr=np.full((h, w), 0.1),
        ancillary_wind=anc,
    ), wspd


def main():
    n_dev = len(jax.devices())
    mesh = make_mesh(n_data=n_dev, n_model=1)
    print(f"mesh: {n_dev} x data ({jax.default_backend()})")

    kwargs = dict(inc_step=0.5, wspd_step=0.5, phi_step=5.0)
    tables = prepare_tables("gmf_cmod5n", "gmf_s1_v2", dtype=jnp.float32,
                            **kwargs)

    scenes, truths = zip(*[make_scene(96, 128, s) for s in range(3)])
    outs = invert_scenes(tables, list(scenes), mesh)

    for i, ((co, dual), truth) in enumerate(zip(outs, truths)):
        rms = float(np.sqrt(np.nanmean((np.abs(dual) - truth) ** 2)))
        print(f"scene {i}: shape {co.shape}, dual-pol RMS vs truth "
              f"{rms:.2f} m/s")
        assert rms < 1.0


if __name__ == "__main__":
    main()
