"""Integer-exact separable bilinear resize as two banded matmuls.

The reference engine has no resize (its thumbnail analog is this repo's
DCT-domain scaled decode and the jcsample 2x2 average); serving real
traffic needs arbitrary output sizes. This op defines a fixed-point
bilinear contract and implements it as two banded matmuls: a resize along
one axis is a (out x in) band matrix with two taps per row, and XLA fuses
the rounding shifts between the two passes.

Contract (this framework's own, stable and oracle-tested):
- Half-pixel source mapping (the standard align_corners=False rule):
  src = (dst + 0.5) * in / out - 0.5, clamped to [0, in-1].
- Weights quantized to Q14 fixed point: wr = round(frac * 2^14),
  wl = 2^14 - wr. Each axis pass computes (wl*a + wr*b + 2^13) >> 14
  independently (W pass first, then H), quantizing to uint8 range
  values between passes — sequential integer semantics, so the result
  is reproducible bit-for-bit on any backend.

Exactness: products are < 2^14 * 255 < 2^22 and each row sums two of
them, so fp32 (24-bit significand) matmuls are exact — provided the dot
really runs in fp32. A GPU may run an fp32 dot in TF32 (10-bit mantissa)
by default, so every dot here asks for ``Precision.HIGHEST``. The >> 14
rounding runs in int32 afterwards. The numpy oracle in
tests/test_resize.py re-implements the contract independently.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_Q = 14
_HALF = 1 << (_Q - 1)


def _band_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) fp32 band: column j holds the Q14 taps for output j."""
    mat = np.zeros((n_in, n_out), dtype=np.float32)
    j = np.arange(n_out, dtype=np.float64)
    src = (j + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    wr = np.rint((src - lo) * (1 << _Q)).astype(np.int64)
    wl = (1 << _Q) - wr
    mat[lo, j.astype(np.int64)] += wl.astype(np.float32)
    mat[hi, j.astype(np.int64)] += wr.astype(np.float32)
    return mat


@functools.lru_cache(maxsize=256)
def _band_cached(n_in: int, n_out: int) -> np.ndarray:
    return _band_np(n_in, n_out)


def _pass_matmul(x: jnp.ndarray, band: jnp.ndarray) -> jnp.ndarray:
    """One axis pass: exact fp32 two-tap matmul, then the Q14 rounding."""
    acc = jax.lax.dot_general(
        x.astype(jnp.float32), band,
        (((x.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return (acc.astype(jnp.int32) + _HALF) >> _Q


def resize_bilinear(x: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """Resize (..., H, W, C) uint8 to (..., out_h, out_w, C).

    Separable fixed-point bilinear (module docstring contract); both
    axis passes are two-tap banded matmuls on the last-moved axis.
    """
    assert x.dtype == jnp.uint8 and x.ndim >= 3
    *lead, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    # W pass: operate on (..., H*C?, W): move W last per channel by
    # transposing to (..., C, H, W) once; both passes then act on the
    # trailing axis and we transpose back at the end.
    t = jnp.moveaxis(x, -1, -3)  # (..., C, H, W)
    if w != out_w:
        t = _pass_matmul(t, jnp.asarray(_band_cached(w, out_w)))  # int32
    if h != out_h:
        t = jnp.swapaxes(t, -1, -2)  # (..., C, out_W, H)
        t = _pass_matmul(t.astype(jnp.uint8) if t.dtype == jnp.int32 else t,
                         jnp.asarray(_band_cached(h, out_h)))
        t = jnp.swapaxes(t, -1, -2)
    return jnp.moveaxis(t.astype(jnp.uint8), -3, -1)


def resize_bilinear_planar(planes: jax.Array, out_h: int,
                           out_w: int) -> jax.Array:
    """Planar (N, H, W) uint8 variant (one plane per image-channel)."""
    assert planes.dtype == jnp.uint8 and planes.ndim == 3
    n, h, w = planes.shape
    if (h, w) == (out_h, out_w):
        return planes
    t = planes
    if w != out_w:
        t = _pass_matmul(t, jnp.asarray(_band_cached(w, out_w)))
        t = t.astype(jnp.uint8)
    if h != out_h:
        t = jnp.swapaxes(t, -1, -2)
        t = _pass_matmul(t, jnp.asarray(_band_cached(h, out_h)))
        t = jnp.swapaxes(t, -1, -2).astype(jnp.uint8)
    return t
