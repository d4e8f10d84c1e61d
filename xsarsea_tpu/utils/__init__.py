"""Config, test-data fetching and profiling utilities.

Counterpart of the reference L0 layer (xsarsea ``utils.py``): two-layer
YAML config (packaged default overridden by
``~/.xsarsea_tpu/config.yml``; PyYAML is imported only to read it), an
IFREMER test-data fetcher (network-gated), and a ``timing`` decorator
that reports wall time, and device memory when a JAX device is live.
"""

from __future__ import annotations

import logging
import os
import time
import warnings
import zipfile

import numpy as np

logger = logging.getLogger("xsarsea_tpu")
logger.addHandler(logging.NullHandler())

__all__ = ["load_config", "get_test_file", "timing", "to_dB", "from_dB",
           "logger", "enable_compilation_cache", "trace",
           "device_memory_stats"]

_DEFAULT_CONFIG = {"data_dir": "/tmp"}


def _checkout_root():
    """The source checkout holding this package, or None when installed."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return root if os.path.exists(os.path.join(root, "pyproject.toml")) \
        else None


def enable_compilation_cache():
    """Keep JAX's persistent compilation cache at a fixed path.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set (or a cache directory is
    already configured), JAX uses it and nothing is set here. Otherwise a
    source checkout keeps the cache in ``<checkout>/.jax_cache``; an
    installed package sets none. Called at package import.
    """
    import jax

    if (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or jax.config.jax_compilation_cache_dir):
        return
    root = _checkout_root()
    if root is not None:
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(root, ".jax_cache"))


def load_config():
    """Load config: ``~/.xsarsea_tpu/config.yml`` overriding packaged defaults.

    Mirrors ``xsarsea.utils._load_config`` (reference utils.py:27-43).
    """
    config = dict(_DEFAULT_CONFIG)
    pkg_config = os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "config.yml")
    for path in (pkg_config, os.path.expanduser("~/.xsarsea_tpu/config.yml")):
        if os.path.exists(path):
            import yaml  # optional dependency: only a config file needs it

            with open(path) as f:
                loaded = yaml.safe_load(f) or {}
            config.update(loaded)
    return config


def get_test_file(fname, iszip=True):
    """Fetch a test file from the IFREMER xsardata server and unzip it.

    API-compatible with ``xsarsea.utils.get_test_file`` (reference
    utils.py:46-97). Like the reference, when ``fsspec`` is importable
    the download goes through ``fsspec.open("filecache::<url>")`` — the
    zip archive is kept in ``<data_dir>/fsspec_cache`` so re-extraction
    never re-downloads, and any protocol fsspec understands works for a
    ``test_data_url`` config override (s3://, gs://, file://, ...).
    Without fsspec, plain https via urllib. In network-less environments
    this raises a clear RuntimeError if the file is not already present
    under ``config['data_dir']``.
    """
    config = load_config()
    res_path = config["data_dir"]
    local = os.path.join(res_path, fname)
    if os.path.exists(local):
        return local

    base_url = config.get(
        "test_data_url",
        "https://cyclobs.ifremer.fr/static/sarwing_datarmor/xsardata")
    url = f"{base_url}/{fname}" + (".zip" if iszip else "")
    try:
        try:
            import fsspec
        except ImportError:
            fsspec = None
        warnings.warn(f"Downloading {url}")
        if fsspec is not None:
            # filecache:: keeps the archive in data_dir/fsspec_cache
            # (reference utils.py:83-95 semantics)
            with fsspec.open(
                f"filecache::{url}",
                filecache={"cache_storage":
                           os.path.join(res_path, "fsspec_cache")},
            ) as f:
                if iszip:
                    with zipfile.ZipFile(f, "r") as zf:
                        zf.extractall(res_path)
                else:
                    # stream to a temp name, rename on success: an
                    # interrupted download must not leave a truncated
                    # file at `local` that the exists() check then
                    # serves forever
                    part = local + ".part"
                    try:
                        with open(part, "wb") as out:
                            while chunk := f.read(1 << 22):
                                out.write(chunk)
                        os.replace(part, local)
                    finally:
                        if os.path.exists(part):
                            os.unlink(part)
        else:
            import urllib.request

            tmp = local + (".zip" if iszip else ".part")
            try:
                urllib.request.urlretrieve(url, tmp)
                if iszip:
                    with zipfile.ZipFile(tmp, "r") as zf:
                        zf.extractall(res_path)
                    os.unlink(tmp)
                else:
                    os.replace(tmp, local)
            finally:
                if not iszip and os.path.exists(tmp):
                    os.unlink(tmp)
    except Exception as e:  # pragma: no cover - network dependent
        raise RuntimeError(
            f"test file '{fname}' not found locally at {local} and download failed ({e}). "
            "Place the file manually or configure data_dir."
        ) from e
    return local


def _rss_mb():
    """Current resident set size in MB (no psutil needed).

    Linux: /proc/self/statm (current RSS). Elsewhere: ru_maxrss —
    lifetime PEAK, so deltas clip at 0 once the high-water mark is set —
    scaled per-platform (macOS reports bytes, not KB).
    """
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except Exception:  # pragma: no cover - non-linux
        pass
    try:
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss / 1e6 if sys.platform == "darwin" else rss / 1e3
    except Exception:  # pragma: no cover - non-posix
        return float("nan")


def device_memory_stats():
    """Per-device memory stats dict (bytes_in_use etc.), or {} when the
    backend doesn't expose them (e.g. CPU)."""
    import jax

    out = {}
    for d in jax.local_devices():
        try:
            stats = d.memory_stats()
        except Exception:  # noqa: BLE001 - backend-dependent
            stats = None
        if stats:
            out[str(d)] = stats
    return out


def timing(logger=logger.debug):
    """Decorator logging wall time, RSS delta and device memory per call.

    Counterpart of the reference ``@timing`` profiler (utils.py:100-123);
    on JAX the result is block-until-ready'd so times are honest, and the
    device-side allocation delta is reported when the backend exposes
    memory stats.
    """

    def decorator(f):
        def wrapper(*args, **kwargs):
            def dev_mb():
                try:
                    return sum(s.get("bytes_in_use", 0)
                               for s in device_memory_stats().values()) / 1e6
                except Exception:  # noqa: BLE001
                    return float("nan")

            mem0, dev0 = _rss_mb(), dev_mb()
            start = time.perf_counter()
            result = f(*args, **kwargs)
            try:
                import jax

                jax.block_until_ready(result)
            except Exception:
                pass
            logger(
                f"timing {f.__name__} : {time.perf_counter() - start:.3f}s. "
                f"mem: +{max(0.0, _rss_mb() - mem0):.1f}Mb "
                f"(device: {dev_mb() - dev0:+.1f}Mb)")
            return result

        wrapper.__doc__ = f.__doc__
        wrapper.__name__ = f.__name__
        return wrapper

    return decorator


class trace:
    """Context manager around ``jax.profiler.trace`` — captures a device
    trace viewable in TensorBoard/Perfetto.

    >>> with trace("/tmp/jax-trace"):
    ...     invert_from_model(...)

    No-ops (with a log message) when the profiler is unavailable on the
    backend. Device-level counterpart of the reference's wall-time ``@timing``
    instrumentation for kernel-level analysis.
    """

    def __init__(self, logdir):
        self.logdir = str(logdir)
        self._active = False

    def __enter__(self):
        import jax

        try:
            jax.profiler.start_trace(self.logdir)
            self._active = True
        except Exception:  # noqa: BLE001 - backend-dependent
            logger.warning("jax profiler trace unavailable", exc_info=True)
        return self

    def __exit__(self, *exc):
        if self._active:
            import jax

            try:
                jax.profiler.stop_trace()
            finally:
                self._active = False
        return False


def to_dB(x, eps=1e-15):
    """linear → dB with the reference's epsilon clip (windspeed.py:126, models.py:215)."""
    import jax.numpy as jnp

    if isinstance(x, np.ndarray):
        return 10.0 * np.log10(x + eps)
    return 10.0 * jnp.log10(x + eps)


def from_dB(x):
    """dB → linear (``**`` dispatches on the input's array type)."""
    return 10.0 ** (x / 10.0)
