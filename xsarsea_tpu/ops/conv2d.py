"""2-D stencils and resampling for the gradients pipeline, as XLA convs.

The reference reaches native performance for these through OpenCV C++
(``cv2.Scharr`` gradients.py:612-613, ``cv2.resize INTER_AREA``
gradients.py:351-352) and scipy ``convolve2d`` (gradients.py:637-672).
Here every stencil lowers to XLA (``lax.conv_general_dilated`` or fused
shifted-slice passes) and INTER_AREA resampling becomes two small
matmuls against precomputed fractional-overlap weight matrices (exact
area averaging).

Boundary conventions are faithfully preserved:

* scipy ``boundary='symm'``  -> edge-repeating symmetric pad (np 'symmetric')
* cv2 default BORDER_REFLECT_101 -> edge-excluding reflect (np 'reflect')

All smoothing kernels (B2, B4, B22, B42, Bx*) have exactly-representable
dyadic entries summing to exactly 1.0, so the reference's ones-normalization
convolutions (e.g. gradients.py:710-711) are exact no-ops and are omitted.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "conv2d_same",
    "scharr",
    "B2_KERNEL",
    "B4_KERNEL",
    "smooth_b2",
    "r2_reduce",
    "local_mean",
    "coarsen2_mean",
    "resize_area",
]

# binomial smoothing kernels (gradients.py:678, 703-706, 737-744)
B2_KERNEL = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float64) / 16.0


def _conv_full(a, b):
    """2-D full convolution of small host kernels."""
    out = np.zeros((a.shape[0] + b.shape[0] - 1, a.shape[1] + b.shape[1] - 1))
    for i in range(b.shape[0]):
        for j in range(b.shape[1]):
            out[i:i + a.shape[0], j:j + a.shape[1]] += a * b[i, j]
    return out


B4_KERNEL = _conv_full(B2_KERNEL, B2_KERNEL)
B22_KERNEL = np.array(
    [[1, 0, 2, 0, 1], [0, 0, 0, 0, 0], [2, 0, 4, 0, 2],
     [0, 0, 0, 0, 0], [1, 0, 2, 0, 1]], dtype=np.float64) / 16.0
B42_KERNEL = _conv_full(B22_KERNEL, B22_KERNEL)

# Scharr correlation kernels (cv2.Scharr with dx=1 / dy=1)
SCHARR_X = np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]], dtype=np.float64)
SCHARR_Y = SCHARR_X.T

_BOUNDARY_TO_PAD = {"symm": "symmetric", "reflect101": "reflect", "fill": "constant",
                    "wrap": "wrap"}


def _mm(a, b):
    """Matmul at full f32 input precision (not the TF32/bf16 default)."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def _conv_valid(img, kernel):
    """2-D valid cross-correlation via lax.conv (f32/f64 by input dtype).

    ``precision=HIGHEST``: without it XLA may round f32 inputs (TF32 on
    the GPU, bf16 on other accelerators: ~1e-3 relative error).
    """
    k = jnp.asarray(kernel, dtype=img.dtype)
    out = lax.conv_general_dilated(
        img[None, None],
        k[None, None],
        window_strides=(1, 1),
        padding="VALID",
        precision=lax.Precision.HIGHEST,
    )
    return out[0, 0]


@lru_cache(maxsize=64)
def _separate_kernel(kernel_bytes, shape):
    """Exact rank-1 factorization of a stencil, or None.

    Returns (col (kh,), row (kw,)) f64 vectors with ``outer(col, row)``
    EXACTLY equal to the kernel (bitwise in f64) — true for every kernel
    in this module (binomial products and Scharr, all dyadic). Non-
    factorizable kernels return None and take the lax.conv path.
    """
    k = np.frombuffer(kernel_bytes, dtype=np.float64).reshape(shape)
    i0, j0 = np.unravel_index(np.argmax(np.abs(k)), k.shape)
    if k[i0, j0] == 0:
        return None  # all-zero kernel: lax.conv handles it
    row = k[i0, :] / k[i0, j0]
    col = k[:, j0]
    if not np.array_equal(np.outer(col, row), k):
        return None
    return col, row


def _conv1d_slices(x, taps, axis, mode, fill):
    """1-D 'same' convolution along ``axis`` as shifted slice + FMA.

    XLA fuses the shifted reads into one elementwise pass, fully
    f32-accurate (no reduced-precision conv inputs). Taps with weight
    exactly 0 (Scharr's center, the dilated B22/B42 lattices) are
    skipped.

    scipy 'same' anchor: pad k//2 BEFORE and (k-1)//2 after (verified
    against scipy.signal.convolve2d for odd and even kernel dims; the
    swapped split matches odd kernels only and shifts even ones by 1).
    """
    k = len(taps)
    pb, pa = k // 2, (k - 1) // 2
    pads = [(0, 0), (0, 0)]
    pads[axis] = (pb, pa)
    kwargs = {"constant_values": fill} if mode == "constant" else {}
    xp = jnp.pad(x, pads, mode=mode, **kwargs)
    n = x.shape[axis]
    out = None
    for i, w in enumerate(taps):
        if w == 0.0:
            continue
        sl = lax.slice_in_dim(xp, i, i + n, axis=axis)
        term = sl * jnp.asarray(w, dtype=x.dtype)
        out = term if out is None else out + term
    return out


def conv2d_same(img, kernel, boundary="symm", fillvalue=0.0, correlate=False):
    """scipy.signal.convolve2d(mode='same') equivalent on jnp arrays.

    True convolution (kernel flipped) unless ``correlate=True``; supports
    complex images by convolving the parts separately (lax.conv is real).

    Separable kernels (every stencil in this pipeline: B2/B4/B22/B42
    binomials and Scharr) run as two shifted-slice 1-D passes, exact in
    f32. Padding one axis commutes exactly
    with convolving the other (mirrored columns are copies; a zero fill
    column convolves to zero), so boundary handling is bit-faithful to
    the fused 2-D pad for symm/reflect/wrap and for fill == 0.
    """
    kernel = np.asarray(kernel, dtype=np.float64)
    if not correlate:
        kernel = kernel[::-1, ::-1]
    kh, kw = kernel.shape
    factors = _separate_kernel(kernel.tobytes(), kernel.shape)
    mode = _BOUNDARY_TO_PAD[boundary]
    img = jnp.asarray(img)
    # the rank-1 factors of an integer-valued kernel can carry
    # fractional taps (e.g. [[1,2],[2,4]] -> row [1, 0.5]) that an
    # integer image dtype would truncate to 0 — keep integer images on
    # the lax.conv path, which casts the full kernel losslessly
    separable = (factors is not None
                 and not (mode == "constant" and fillvalue != 0.0)
                 and jnp.issubdtype(img.dtype, jnp.inexact))
    if separable:
        col, row = factors

        def run(x):
            y = _conv1d_slices(x, tuple(col), 0, mode, fillvalue)
            return _conv1d_slices(y, tuple(row), 1, mode, fillvalue)

    else:
        # see _conv1d_slices for the anchor rule
        pt, pb = kh // 2, (kh - 1) // 2
        pl_, pr = kw // 2, (kw - 1) // 2
        kwargs = {"constant_values": fillvalue} if mode == "constant" else {}

        def run(x):
            xp = jnp.pad(x, ((pt, pb), (pl_, pr)), mode=mode, **kwargs)
            return _conv_valid(xp, kernel)

    if jnp.issubdtype(img.dtype, jnp.complexfloating):
        return run(img.real) + 1j * run(img.imag)
    return run(img)


def scharr(img, axis):
    """cv2.Scharr equivalent (correlation, BORDER_REFLECT_101).

    axis=1 -> d/dx (sample direction), axis=0 -> d/dy (line direction),
    matching cv2.Scharr(img, CV_64F, 1, 0) / (0, 1) at gradients.py:612-613.
    """
    k = SCHARR_X if axis == 1 else SCHARR_Y
    return conv2d_same(img, k, boundary="reflect101", correlate=True)


def smooth_b2(img):
    """B2 gaussian-like smoothing with symmetric boundary (gradients.py:675-686)."""
    return conv2d_same(img, B2_KERNEL, boundary="symm")


def coarsen2_mean(img):
    """2x2 block mean with trailing trim (xr.coarsen boundary='trim').

    Computed as row-pair add, then column-pair add, then one multiply.
    Bit-identical to the ``reshape(h//2, 2, w//2, 2).mean(axis=(1, 3))``
    form (same pairwise summation tree: (x00+x10)+(x01+x11), one final
    *0.25 — verified elementwise-equal on random 4096^2 inputs and by
    the reference-parity tests).
    """
    h = (img.shape[0] // 2) * 2
    w = (img.shape[1] // 2) * 2
    x = img[:h, :w]
    r = x[0::2, :] + x[1::2, :]
    return (r[:, 0::2] + r[:, 1::2]) * 0.25


def r2_reduce(img):
    """Anti-moiré reduce-by-2: B4 pre-smooth, 2x2 trim-mean, B2 post-smooth.

    Faithful to the reference R2 (gradients.py:689-721); the ones-kernel
    normalizations there are exact no-ops (kernels sum to exactly 1.0).
    """
    x = conv2d_same(img, B4_KERNEL, boundary="symm")
    x = coarsen2_mean(x)
    return conv2d_same(x, B2_KERNEL, boundary="symm")


def local_mean(img):
    """Local mean operator: B4 then B42 smoothing (gradients.py:724-755)."""
    x = conv2d_same(img, B4_KERNEL, boundary="symm")
    return conv2d_same(x, B42_KERNEL, boundary="symm")


@lru_cache(maxsize=64)
def _zoom_weights(n_in, n_out):
    """Bilinear resampling weights matching scipy.ndimage.zoom(order=1).

    scipy's default grid convention maps output index i to input coordinate
    ``i * (n_in - 1) / (n_out - 1)`` (endpoints aligned)."""
    w = np.zeros((n_out, n_in), dtype=np.float64)
    if n_out == 1:
        w[0, 0] = 1.0
        return w
    x = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(x).astype(int), 0, n_in - 2)
    frac = x - i0
    w[np.arange(n_out), i0] = 1.0 - frac
    w[np.arange(n_out), i0 + 1] += frac
    return w


def zoom_bilinear(img, out_shape):
    """scipy.ndimage.zoom(order=1) equivalent as two matmuls."""
    img = jnp.asarray(img)
    # fractional weights need a float dtype: casting them to an integer
    # image dtype would truncate them to 0/1 and zero out the result
    dt = jnp.promote_types(img.dtype, jnp.float32)
    wr = jnp.asarray(_zoom_weights(img.shape[0], out_shape[0]), dtype=dt)
    wc = jnp.asarray(_zoom_weights(img.shape[1], out_shape[1]), dtype=dt)
    # full f32 precision: the default may round inputs (~1e-3 rel error)
    return _mm(_mm(wr, img.astype(dt)), wc.T)


@lru_cache(maxsize=64)
def _area_weights(n_in, n_out):
    """Fractional-overlap row weights for INTER_AREA shrink (n_out x n_in)."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        a, b = i * scale, (i + 1) * scale
        j0, j1 = int(np.floor(a)), int(np.ceil(b))
        for j in range(j0, min(j1, n_in)):
            w[i, j] = min(b, j + 1) - max(a, j)
        w[i] /= w[i].sum()
    return w


def resize_area(img, out_shape):
    """cv2.resize(..., INTER_AREA) equivalent for shrinking, as two matmuls.

    Exact fractional area averaging (what INTER_AREA computes when
    downscaling), expressed as W_r @ img @ W_c^T (two matrix products).
    Used by the multiscale resampler (gradients.py:336-362).
    """
    n_out_r, n_out_c = out_shape
    img = jnp.asarray(img)
    # float weights (see zoom_bilinear): integer-dtype images promote
    dt = jnp.promote_types(img.dtype, jnp.float32)
    wr = jnp.asarray(_area_weights(img.shape[0], n_out_r), dtype=dt)
    wc = jnp.asarray(_area_weights(img.shape[1], n_out_c), dtype=dt)
    # full f32 precision: the default may round inputs (~1e-3 rel error)
    return _mm(_mm(wr, img.astype(dt)), wc.T)
