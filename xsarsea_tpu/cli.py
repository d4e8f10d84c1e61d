"""Command-line interface.

Mirrors the reference CLI (/root/reference/src/scripts/xsarsea_cli.py):
``models-to-nc`` exports every registered non-netCDF model to netCDF LUT
files. Extra subcommands: ``list`` (registry table), ``models-to-packed``
(the packed device-ready cache format) and ``invert`` (batch wind
inversion of a scene file — the serving entry point).

argparse-based (the reference uses typer, which is not a dependency of
this framework).
"""

from __future__ import annotations

import argparse
import os
import sys


def _register_from_args(args):
    from xsarsea_tpu.models import register_luts

    if getattr(args, "nc_lut_dir", None) or getattr(args, "cmod7_dir", None):
        register_luts(topdir=args.nc_lut_dir, topdir_cmod7=args.cmod7_dir)


def _models_to(export_dir, fmt, args):
    from xsarsea_tpu.models import available_models
    from xsarsea_tpu.models.base import LutModel
    from xsarsea_tpu.models.nc_lut import NcLutModel

    _register_from_args(args)
    os.makedirs(export_dir, exist_ok=True)
    prefix = LutModel._name_prefix
    for model_name, row in available_models().iterrows():
        model = row.model
        if isinstance(model, NcLutModel):
            print(f"Skipping {model_name} ({model.path})")
            continue
        try:
            if fmt == "nc":
                outfile = os.path.join(export_dir, f"{prefix}{model.name}.nc")
                model.to_netcdf(outfile)
            else:
                from xsarsea_tpu.io.lut_io import write_packed_lut

                outfile = os.path.join(export_dir, f"{prefix}{model.name}.xstl")
                lut = model.to_lut(units="dB")
                write_packed_lut(outfile, lut, lut.attrs)
            print(f"Wrote {outfile}")
        except Exception as e:  # noqa: BLE001 — per-model, keep exporting
            print(f"Error processing {model.name} : {e}")


def cmd_models_to_nc(args):
    _models_to(args.export_dir, "nc", args)


def cmd_models_to_packed(args):
    _models_to(args.export_dir, "packed", args)


def cmd_list(args):
    from xsarsea_tpu.models import available_models

    _register_from_args(args)
    df = available_models(pol=args.pol)
    print(df.drop(columns=["model"]).to_string())


def cmd_invert(args):
    """Batch wind inversion: scene file(s) in, wind field out.

    The serving entry point: reads inc/sigma0[/sigma0_dual/ancillary]
    arrays from an ``.npz``, or from a DIRECTORY of per-key ``.npy``
    files — the directory form memory-maps each array, so arbitrarily
    large scenes stream through the piece pipeline with O(piece) host
    memory (see scripts/demo_full_scene.py for the 10^8-px version of
    this layout). Writes complex wind to an ``.npz``.
    """
    import numpy as np

    from xsarsea_tpu.windspeed import invert_from_model

    _register_from_args(args)
    if os.path.isdir(args.scene):
        scene = {}
        for f in sorted(os.listdir(args.scene)):
            if f.endswith(".npy"):
                scene[f[:-4]] = np.load(os.path.join(args.scene, f),
                                        mmap_mode="r")
    else:
        scene = np.load(args.scene)
    missing = [k for k in ("inc", "sigma0") if k not in scene]
    if missing:
        raise SystemExit(
            f"{args.scene}: missing required arrays {missing} "
            f"(found {list(scene.keys())})")
    models = tuple(m.strip() for m in args.model.split(","))
    dual = scene["sigma0_dual"] if "sigma0_dual" in scene else None
    anc = scene["ancillary_wind"] if "ancillary_wind" in scene else None
    # scene channels and model count must agree — never silently drop one
    if dual is None and len(models) != 1:
        raise SystemExit(
            f"--model names {len(models)} models {models} but the scene "
            f"has no 'sigma0_dual' array: pass exactly one model "
            f"(found {sorted(scene.keys())})")
    if dual is not None and len(models) != 2:
        raise SystemExit(
            "scene has a 'sigma0_dual' array: pass two models "
            "(--model co_model,cr_model) or remove the dual channel")
    if dual is not None:
        wind_co, wind_dual = invert_from_model(
            scene["inc"], scene["sigma0"], dual, ancillary_wind=anc,
            dsig_cr=args.dsig_cr, model=models, mode=args.mode)
        np.savez(args.out, wind_co=wind_co, wind_dual=wind_dual)
        speeds = np.abs(wind_dual)
    else:
        wind = invert_from_model(
            scene["inc"], scene["sigma0"], ancillary_wind=anc,
            dsig_cr=args.dsig_cr, model=models[0], mode=args.mode)
        np.savez(args.out, wind=wind)
        speeds = np.abs(wind)
    n = speeds.size
    valid = np.isfinite(speeds)
    if valid.any():
        summary = (f"{valid.mean():.1%} valid, mean speed "
                   f"{np.nanmean(speeds[valid]):.2f} m/s")
    else:
        summary = "0% valid — no finite retrievals"
    print(f"inverted {n} px with {'+'.join(models)} -> {args.out} "
          f"({summary})")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="xsarsea-tpu",
        description="SAR ocean analysis toolkit (JAX)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--nc-lut-dir", default=None,
                        help="directory of nc_lut_*.nc LUTs to register")
    common.add_argument("--cmod7-dir", default=None,
                        help="CMOD7 binary LUT directory to register")

    p_nc = sub.add_parser("models-to-nc", parents=[common],
                          help="export registered models to netCDF LUTs")
    p_nc.add_argument("export_dir", help="destination directory")
    p_nc.set_defaults(func=cmd_models_to_nc)

    p_pk = sub.add_parser("models-to-packed", parents=[common],
                          help="export registered models to packed LUT caches")
    p_pk.add_argument("export_dir", help="destination directory")
    p_pk.set_defaults(func=cmd_models_to_packed)

    p_ls = sub.add_parser("list", parents=[common],
                          help="list registered models")
    p_ls.add_argument("--pol", default=None, help="filter by polarization")
    p_ls.set_defaults(func=cmd_list)

    p_inv = sub.add_parser(
        "invert", parents=[common],
        help="invert a scene .npz (inc, sigma0[, sigma0_dual, "
             "ancillary_wind]) into wind")
    p_inv.add_argument("scene", help=".npz with inc/sigma0[/sigma0_dual"
                                     "/ancillary_wind] arrays")
    p_inv.add_argument("out", help="output .npz path")
    p_inv.add_argument("--model", required=True,
                       help="model name, or 'co_model,cr_model' for "
                            "dual-pol")
    p_inv.add_argument("--mode", default="auto",
                       help="inversion mode (auto/exact/triton)")
    p_inv.add_argument("--dsig-cr", type=float, default=0.1)
    p_inv.set_defaults(func=cmd_invert)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
