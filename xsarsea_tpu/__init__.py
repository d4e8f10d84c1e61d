"""xsarsea_tpu — SAR ocean analysis framework in JAX.

A ground-up JAX/XLA/Pallas re-design with the capabilities of
umr-lops/xsarsea: GMF forward models, Bayesian wind inversion, sigma0
detrending, wind-streak direction analysis — compiled by XLA for NVIDIA
GPUs (the inversion's hot loop as a Pallas kernel through Triton) or the
CPU, and scaled over device meshes with jax.sharding.
"""

__version__ = "0.1.0"

__all__ = [
    "sigma0_detrend",
    "dir_meteo_to_sample",
    "dir_sample_to_meteo",
    "dir_meteo_to_oceano",
    "dir_oceano_to_meteo",
    "dir_to_180",
    "dir_to_360",
    "get_test_file",
    "read_sarwing_owi",
    "DimArray",
    "windspeed",
    "gradients",
    "to_dimarray",
    "to_dataarray",
]

from xsarsea_tpu.dimarray import DimArray
from xsarsea_tpu.interop import to_dataarray, to_dimarray
from xsarsea_tpu.detrend import read_sarwing_owi, sigma0_detrend
from xsarsea_tpu.directions import (
    dir_meteo_to_oceano,
    dir_meteo_to_sample,
    dir_oceano_to_meteo,
    dir_sample_to_meteo,
    dir_to_180,
    dir_to_360,
)
from xsarsea_tpu.utils import enable_compilation_cache, get_test_file
from xsarsea_tpu import utils  # noqa: F401

enable_compilation_cache()
from xsarsea_tpu import windspeed  # noqa: F401
