"""Integer-exact image filters on the XLA path.

These are the jnp/XLA implementations of the reference's device kernel
(`gaussian_kernel.cl:19-72`) and its extensions. All ops are:

- channel-independent (the reference kernel loops channels independently,
  `gaussian_kernel.cl:44`), so they work on any layout where H and W are
  identifiable axes — NHWC, HWC, planar (N, H, W), etc.;
- integer-exact: uint8 in, int32 accumulate, shift/clamp, uint8 out. This is
  bit-identical to the reference's fp32-accumulate + truncating-cast (see
  `hipe_tpu.ops.reference` for the argument and tests for the proof);
- clamp-to-edge at borders (`gaussian_kernel.cl:56-57`);
- static-shaped and fully fusible by XLA: each filter lowers to a handful of
  shifted adds that XLA fuses into one HBM-bandwidth-bound loop.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax

from hipe_tpu.ops.reference import binomial_taps as _np_binomial_taps


def binomial_taps(radius: int) -> tuple[tuple[int, ...], int]:
    """Integer binomial taps and per-axis shift (see ops.reference)."""
    taps, shift = _np_binomial_taps(radius)
    return tuple(int(t) for t in taps), shift


def _edge_pad_axis(x: jax.Array, axis: int, lo: int, hi: int) -> jax.Array:
    """Pad `x` along `axis` by replicating the edge slices (clamp-to-edge)."""
    parts = []
    if lo:
        first = lax.slice_in_dim(x, 0, 1, axis=axis)
        parts.append(jnp.repeat(first, lo, axis=axis))
    parts.append(x)
    if hi:
        n = x.shape[axis]
        last = lax.slice_in_dim(x, n - 1, n, axis=axis)
        parts.append(jnp.repeat(last, hi, axis=axis))
    return jnp.concatenate(parts, axis=axis) if len(parts) > 1 else x


def _conv1d(x: jax.Array, axis: int, taps: Sequence[int], pad: bool) -> jax.Array:
    """1-D integer correlation along `axis`.

    With ``pad=True`` uses clamp-to-edge padding (output length == input
    length). With ``pad=False`` computes the 'valid' interior (output length
    == input - 2*radius) — used when halo rows are already present.
    """
    r = (len(taps) - 1) // 2
    xp = _edge_pad_axis(x, axis, r, r) if pad else x
    n = xp.shape[axis] - 2 * r
    acc = None
    for j, t in enumerate(taps):
        sl = lax.slice_in_dim(xp, j, j + n, axis=axis)
        term = sl if t == 1 else sl * t
        acc = term if acc is None else acc + term
    return acc


def gaussian_blur(
    x: jax.Array,
    radius: int = 1,
    *,
    h_axis: int = -3,
    w_axis: int = -2,
    h_pad: bool = True,
) -> jax.Array:
    """Separable binomial Gaussian blur, integer-exact.

    radius=1 reproduces the reference 3x3 kernel bit-for-bit
    (`gaussian_kernel.cl:36-41,70`); radius 2/4 are the 5x5/9x9 separable
    variants. Default axes assume channels-last layouts (..., H, W, C).

    ``h_pad=False`` treats the H axis as already halo-padded by `radius` rows
    on each side (the row-split path, mirroring `split_image_blur.c:144-173`):
    no H clamp is applied and the output has ``H - 2*radius`` rows.
    """
    assert x.dtype == jnp.uint8
    taps, shift = binomial_taps(radius)
    acc = x.astype(jnp.int32)
    acc = _conv1d(acc, w_axis if w_axis >= 0 else w_axis + x.ndim, taps, pad=True)
    acc = _conv1d(acc, h_axis if h_axis >= 0 else h_axis + x.ndim, taps, pad=h_pad)
    return (acc >> (2 * shift)).astype(jnp.uint8)


def gaussian_blur3x3(x: jax.Array, **kw) -> jax.Array:
    """The reference kernel: 3x3 binomial blur (`gaussian_kernel.cl:19-72`)."""
    return gaussian_blur(x, radius=1, **kw)


def gaussian_blur_planar(x: jax.Array, radius: int = 1, *, h_pad: bool = True):
    """Blur for planar layouts (..., H, W) — one plane per (image, channel)."""
    return gaussian_blur(x, radius, h_axis=-2, w_axis=-1, h_pad=h_pad)


def _stencil_r(x: jax.Array, h_axis: int, w_axis: int, h_pad: bool, r: int):
    """Return int32 shifted views of x for a (2r+1)^2 stencil."""
    h_axis = h_axis if h_axis >= 0 else h_axis + x.ndim
    w_axis = w_axis if w_axis >= 0 else w_axis + x.ndim
    xi = x.astype(jnp.int32)
    xp = _edge_pad_axis(xi, w_axis, r, r)
    if h_pad:
        xp = _edge_pad_axis(xp, h_axis, r, r)
    hn = xp.shape[h_axis] - 2 * r
    wn = xp.shape[w_axis] - 2 * r

    def view(dy, dx):
        v = lax.slice_in_dim(xp, dy, dy + hn, axis=h_axis)
        return lax.slice_in_dim(v, dx, dx + wn, axis=w_axis)

    return view


def _stencil3x3(x: jax.Array, h_axis: int, w_axis: int, h_pad: bool):
    """Return the 9 int32 shifted views of x for a 3x3 stencil."""
    return _stencil_r(x, h_axis, w_axis, h_pad, 1)


def sharpen3x3(
    x: jax.Array, *, h_axis: int = -3, w_axis: int = -2, h_pad: bool = True
) -> jax.Array:
    """Unsharp 3x3 [[0,-1,0],[-1,5,-1],[0,-1,0]], saturating uint8 store."""
    assert x.dtype == jnp.uint8
    v = _stencil3x3(x, h_axis, w_axis, h_pad)
    out = 5 * v(1, 1) - v(0, 1) - v(2, 1) - v(1, 0) - v(1, 2)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def sobel_edge(
    x: jax.Array, *, h_axis: int = -3, w_axis: int = -2, h_pad: bool = True
) -> jax.Array:
    """Sobel |gx|+|gy| edge magnitude, per channel, saturating uint8 store."""
    assert x.dtype == jnp.uint8
    v = _stencil3x3(x, h_axis, w_axis, h_pad)
    gx = (v(0, 2) + 2 * v(1, 2) + v(2, 2)) - (v(0, 0) + 2 * v(1, 0) + v(2, 0))
    gy = (v(2, 0) + 2 * v(2, 1) + v(2, 2)) - (v(0, 0) + 2 * v(0, 1) + v(0, 2))
    return jnp.clip(jnp.abs(gx) + jnp.abs(gy), 0, 255).astype(jnp.uint8)


def _median_of_9(vals):
    """Elementwise median of 9 arrays: Paeth's 19-op min/max network.

    Sort each triple to (lo, me, hi); the median of all nine is then
    med3(max of the los, med3 of the mes, min of the his). Pure
    minimum/maximum ops.
    """
    mn, mx = jnp.minimum, jnp.maximum

    def sort3(a, b, c):
        tl, th = mn(a, b), mx(a, b)
        return mn(tl, c), mx(tl, mn(th, c)), mx(th, c)

    def med3(a, b, c):
        return mx(mn(a, b), mn(mx(a, b), c))

    t = [sort3(*vals[i:i + 3]) for i in (0, 3, 6)]
    lo = mx(mx(t[0][0], t[1][0]), t[2][0])
    me = med3(t[0][1], t[1][1], t[2][1])
    hi = mn(mn(t[0][2], t[1][2]), t[2][2])
    return med3(lo, me, hi)


def median3x3(
    x: jax.Array, *, h_axis: int = -3, w_axis: int = -2, h_pad: bool = True
) -> jax.Array:
    """3x3 median (salt-and-pepper denoise), clamp-to-edge, per channel.

    A min/max network — integer-exact by construction on all backends.
    """
    assert x.dtype == jnp.uint8
    v = _stencil3x3(x, h_axis, w_axis, h_pad)
    vals = [v(dy, dx) for dy in range(3) for dx in range(3)]
    return _median_of_9(vals).astype(jnp.uint8)


def _rank3x3(x, h_axis, w_axis, h_pad, reduce_fn):
    """Separable 3x3 rank extreme: reduce W triples, then H triples."""
    assert x.dtype == jnp.uint8
    v = _stencil3x3(x, h_axis, w_axis, h_pad)
    rows = [
        reduce_fn(reduce_fn(v(dy, 0), v(dy, 1)), v(dy, 2)) for dy in range(3)
    ]
    return reduce_fn(reduce_fn(rows[0], rows[1]), rows[2]).astype(jnp.uint8)


def erode3x3(
    x: jax.Array, *, h_axis: int = -3, w_axis: int = -2, h_pad: bool = True
) -> jax.Array:
    """3x3 minimum (morphological erosion), clamp-to-edge, per channel.

    Bit-identical to PIL ``ImageFilter.MinFilter(3)`` (PIL rank filters
    replicate the border before ranking — the same clamp-to-edge rule as
    the reference kernel, gaussian_kernel.cl:56-57). Pure min ops: exact
    in every layout by construction.
    """
    return _rank3x3(x, h_axis, w_axis, h_pad, jnp.minimum)


def dilate3x3(
    x: jax.Array, *, h_axis: int = -3, w_axis: int = -2, h_pad: bool = True
) -> jax.Array:
    """3x3 maximum (morphological dilation) — PIL ``MaxFilter(3)``."""
    return _rank3x3(x, h_axis, w_axis, h_pad, jnp.maximum)


# ---- Radius-0 point stages (the PIL ImageOps pointwise family) ----
#
# Pure per-pixel arithmetic, no stencil: radius 0, so chains mixing them
# with stencils need no extra halo, row-split shards skip the exchange,
# and every layout (planar, rows, NHWC) runs the identical integer
# expression. Semantics are PIL's LUTs in closed
# form (ImageOps.invert/solarize/posterize), trivially exact:
#   invert:     255 - x
#   solarize:   x if x < 128 else 255 - x   (PIL default threshold)
#   posterize4: x & 0xF0                   (PIL posterize(bits=4))

def _posterize(bits: int):
    # Bitwise mask, exactly PIL's `i & mask`. The div/mul spelling
    # ((x // step) * step — identical for x in [0, 255]) lowers to
    # rem/select with s32 + pred temps that XLA may materialize at
    # stream scale; `and` fuses to uint8.
    mask = 0x100 - (1 << (8 - bits))
    return lambda x: x & mask


POINT_STAGES = {
    "invert": lambda x: 255 - x,
    "solarize": lambda x: jnp.where(x >= 128, 255 - x, x),
    # All PIL posterize depths; "posterize4" is the registry pipeline.
    **{f"posterize{b}": _posterize(b) for b in range(1, 9)},
}


def _make_point_filter(fn):
    def op(x: jax.Array, *, h_axis: int = -3, w_axis: int = -2,
           h_pad: bool = True) -> jax.Array:
        assert x.dtype == jnp.uint8
        return fn(x.astype(jnp.int32)).astype(jnp.uint8)

    return op


def _make_point_filter_rows(fn):
    def op(x: jax.Array, channels: int, *, h_pad: bool = True) -> jax.Array:
        assert x.dtype == jnp.uint8
        return fn(x.astype(jnp.int32)).astype(jnp.uint8)

    return op


# Registry of named filter ops. Each op maps uint8 -> uint8 and accepts
# (h_axis, w_axis, h_pad) kwargs; chains quantize to uint8 between stages.
FILTERS = {
    "gaussian3": gaussian_blur3x3,
    "gaussian5": functools.partial(gaussian_blur, radius=2),
    "gaussian7": functools.partial(gaussian_blur, radius=3),
    "gaussian9": functools.partial(gaussian_blur, radius=4),
    "sharpen": sharpen3x3,
    "edge": sobel_edge,
    "median": median3x3,
    "erode": erode3x3,
    "dilate": dilate3x3,
    **{nm: _make_point_filter(fn) for nm, fn in POINT_STAGES.items()},
}

# Halo rows each filter needs on each side of its H slice (== stencil radius).
FILTER_RADIUS = {
    "gaussian3": 1,
    "gaussian5": 2,
    "gaussian7": 3,
    "gaussian9": 4,
    "sharpen": 1,
    "edge": 1,
    "median": 1,
    "erode": 1,
    "dilate": 1,
    **{nm: 0 for nm in POINT_STAGES},
}


def filter_chain(
    x: jax.Array,
    names: Sequence[str],
    *,
    h_axis: int = -3,
    w_axis: int = -2,
    h_pad: bool = True,
) -> jax.Array:
    """Apply named filters sequentially (uint8 quantization between stages).

    With ``h_pad=False`` the input must carry ``chain_radius(names)`` halo
    rows per side; each stage consumes its own radius, so the output is the
    valid interior — the row-split execution mode for chains.
    """
    for name in names:
        x = FILTERS[name](x, h_axis=h_axis, w_axis=w_axis, h_pad=h_pad)
    return x


def chain_radius(names: Sequence[str]) -> int:
    """Total halo each side needed to run a chain 'valid' over split rows."""
    return sum(FILTER_RADIUS[n] for n in names)


# ---- Interleaved-rows layout (..., H, W*C) ----
#
# The channels-last device layout here is "rows": each image row flattened
# to a W*C vector (a free host-side reshape of interleaved RGB — exactly the
# reference's device buffer layout, heterogeneous_blur.c:128-135). The W-axis stencil becomes a
# dilation-C stencil along the last axis; edge clamp replicates whole
# C-lane pixel blocks.


def _edge_pad_rows(x: jax.Array, axis: int, r: int, c: int) -> jax.Array:
    """Clamp-to-edge pad by r *pixels* (blocks of c lanes) along `axis`."""
    n = x.shape[axis]
    first = lax.slice_in_dim(x, 0, c, axis=axis)
    last = lax.slice_in_dim(x, n - c, n, axis=axis)
    return jnp.concatenate([first] * r + [x] + [last] * r, axis=axis)


def _conv1d_rows(
    x: jax.Array, axis: int, taps: Sequence[int], c: int, pad: bool
) -> jax.Array:
    """1-D integer correlation with pixel stride c along `axis`."""
    r = (len(taps) - 1) // 2
    xp = _edge_pad_rows(x, axis, r, c) if pad else x
    n = xp.shape[axis] - 2 * r * c
    acc = None
    for j, t in enumerate(taps):
        if t == 0:
            continue
        sl = lax.slice_in_dim(xp, j * c, j * c + n, axis=axis)
        term = sl if t == 1 else sl * t
        acc = term if acc is None else acc + term
    return acc


def _rows_stencil(x: jax.Array, c: int, h_pad: bool, r: int = 1):
    """(2r+1)^2 stencil views over (..., H, W*C) int32, pixel-clamped.

    ``view(dy, dx)`` takes dy in [0, 2r] and dx in [-r, r]."""
    xi = x.astype(jnp.int32)
    xp = _edge_pad_rows(xi, -1, r, c)
    if h_pad:
        xp = _edge_pad_axis(xp, xp.ndim - 2, r, r)
    hn = xp.shape[-2] - 2 * r
    wn = xp.shape[-1] - 2 * r * c

    def view(dy, dx):
        v = lax.slice_in_dim(xp, dy, dy + hn, axis=xp.ndim - 2)
        return lax.slice_in_dim(v, (dx + r) * c, (dx + r) * c + wn, axis=-1)

    return view


def gaussian_blur_rows(
    x: jax.Array, channels: int, radius: int = 1, *, h_pad: bool = True
) -> jax.Array:
    """Separable blur on interleaved rows (..., H, W*C); bit-exact."""
    assert x.dtype == jnp.uint8
    taps, shift = binomial_taps(radius)
    acc = _conv1d_rows(x.astype(jnp.int32), -1, taps, channels, pad=True)
    acc = _conv1d(acc, acc.ndim - 2, taps, pad=h_pad)
    return (acc >> (2 * shift)).astype(jnp.uint8)


def sharpen3x3_rows(
    x: jax.Array, channels: int, *, h_pad: bool = True
) -> jax.Array:
    assert x.dtype == jnp.uint8
    v = _rows_stencil(x, channels, h_pad)
    out = 5 * v(1, 0) - v(0, 0) - v(2, 0) - v(1, -1) - v(1, 1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def sobel_edge_rows(
    x: jax.Array, channels: int, *, h_pad: bool = True
) -> jax.Array:
    assert x.dtype == jnp.uint8
    v = _rows_stencil(x, channels, h_pad)
    gx = (v(0, 1) + 2 * v(1, 1) + v(2, 1)) - (v(0, -1) + 2 * v(1, -1) + v(2, -1))
    gy = (v(2, -1) + 2 * v(2, 0) + v(2, 1)) - (v(0, -1) + 2 * v(0, 0) + v(0, 1))
    return jnp.clip(jnp.abs(gx) + jnp.abs(gy), 0, 255).astype(jnp.uint8)


def median3x3_rows(
    x: jax.Array, channels: int, *, h_pad: bool = True
) -> jax.Array:
    assert x.dtype == jnp.uint8
    v = _rows_stencil(x, channels, h_pad)
    vals = [v(dy, dx) for dy in range(3) for dx in (-1, 0, 1)]
    return _median_of_9(vals).astype(jnp.uint8)


def _rank3x3_rows(x, channels, h_pad, reduce_fn):
    assert x.dtype == jnp.uint8
    v = _rows_stencil(x, channels, h_pad)
    rows = [
        reduce_fn(reduce_fn(v(dy, -1), v(dy, 0)), v(dy, 1)) for dy in range(3)
    ]
    return reduce_fn(reduce_fn(rows[0], rows[1]), rows[2]).astype(jnp.uint8)


def erode3x3_rows(
    x: jax.Array, channels: int, *, h_pad: bool = True
) -> jax.Array:
    return _rank3x3_rows(x, channels, h_pad, jnp.minimum)


def dilate3x3_rows(
    x: jax.Array, channels: int, *, h_pad: bool = True
) -> jax.Array:
    return _rank3x3_rows(x, channels, h_pad, jnp.maximum)


ROWS_FILTERS = {
    "gaussian3": functools.partial(gaussian_blur_rows, radius=1),
    "gaussian5": functools.partial(gaussian_blur_rows, radius=2),
    "gaussian7": functools.partial(gaussian_blur_rows, radius=3),
    "gaussian9": functools.partial(gaussian_blur_rows, radius=4),
    "sharpen": sharpen3x3_rows,
    "edge": sobel_edge_rows,
    "median": median3x3_rows,
    "erode": erode3x3_rows,
    "dilate": dilate3x3_rows,
    **{nm: _make_point_filter_rows(fn) for nm, fn in POINT_STAGES.items()},
}


def filter_chain_rows(
    x: jax.Array, channels: int, names: Sequence[str], *, h_pad: bool = True
) -> jax.Array:
    """Filter chain on interleaved rows (..., H, W*C)."""
    for name in names:
        x = ROWS_FILTERS[name](x, channels, h_pad=h_pad)
    return x


# ---- User-defined convolution kernels (the PIL ImageFilter.Kernel family) --
#
# A registered kernel stage is an arbitrary integer-tap correlation with an
# integer divisor and half-integer offset, computed with EXACT integer
# arithmetic and round-half-up:
#
#   out = clamp( floor( acc/scale + offset + 1/2 ) )
#       = clamp( (2*acc + scale*(2*offset + 1)) // (2*scale) )   (all int32)
#
# Taps are given in PIL orientation (`ImageFilter.Kernel` row 0 first): PIL
# applies kernel rows bottom-up (its row 0 multiplies image row y+r —
# impulse-probed), so registration flips rows to our top-down correlation.
# This is PIL's own documented semantics evaluated in infinite precision:
# bit-identical to PIL for scale-1, power-of-two, and odd scales (fp32 tap
# normalization is exact or the rounding margin >= 1/(2*scale) dwarfs PIL's
# ~1e-7 relative float noise; fuzzed over 4.1M pixels, zero deviations).
# Even non-dyadic scales admit exact .5 ties (acc/scale ≡ X.5, pixel rate
# ~1/(2*scale)); PIL's fp32 noise resolves each tie implementation-
# definedly (~coin-flip — e.g. DETAIL at scale 6 differs from its own
# infinite-precision semantics on ~7% of noise-image pixels), while the
# engine rounds ties up, deterministically. Measured: every PIL deviation
# sits on an exact tie and is +-1 (tests assert exactly this).
# Borders: clamp-to-edge like every engine stencil (the reference kernel's
# rule) — PIL instead copies border pixels through unfiltered, so PIL
# equality holds on the interior (r rows/cols in).
#
# The stages are plain int32 adds/multiplies plus one exact
# reciprocal-multiply division, so every layout and row-split shard traces
# the identical expression.

KERNEL_STAGES: dict = {}

# |2*acc + scale*(2*off+1)| must stay fp32-exact with margin for the
# reciprocal-multiply division (see _floordiv_exact): bound by 2^22.
_KERNEL_NUM_LIMIT = 1 << 22


def _floordiv_exact(num: jax.Array, den: int) -> jax.Array:
    """Exact floor(num/den) for |num| <= 2^22, without integer division.

    fp32 reciprocal multiply puts the rounded quotient within +-1 of the
    true floor (|num/den| <= 2^21 keeps the fp32 error < 0.5); one integer
    remainder correction each way lands it exactly.
    """
    q = jnp.round(
        num.astype(jnp.float32) * jnp.float32(1.0 / den)
    ).astype(jnp.int32)
    rem = num - q * den
    return q - (rem < 0).astype(jnp.int32) + (rem >= den).astype(jnp.int32)


def _kernel_acc(view, flipped, size):
    acc = None
    for dy in range(size):
        for dx in range(size):
            t = flipped[dy][dx]
            if t == 0:
                continue
            term = view(dy, dx) if t == 1 else t * view(dy, dx)
            acc = term if acc is None else acc + term
    return acc if acc is not None else 0 * view(size // 2, size // 2)


def _make_kernel_stage(spec):
    size, flipped = spec["size"], spec["flipped"]
    den, cnum = 2 * spec["scale"], spec["scale"] * (spec["off2"] + 1)

    def op(x: jax.Array, *, h_axis: int = -3, w_axis: int = -2,
           h_pad: bool = True) -> jax.Array:
        assert x.dtype == jnp.uint8
        v = _stencil_r(x, h_axis, w_axis, h_pad, size // 2)
        num = 2 * _kernel_acc(v, flipped, size) + cnum
        return jnp.clip(_floordiv_exact(num, den), 0, 255).astype(jnp.uint8)

    return op


def _make_kernel_stage_rows(spec):
    size, flipped = spec["size"], spec["flipped"]
    den, cnum = 2 * spec["scale"], spec["scale"] * (spec["off2"] + 1)
    r = size // 2

    def op(x: jax.Array, channels: int, *, h_pad: bool = True) -> jax.Array:
        assert x.dtype == jnp.uint8
        v = _rows_stencil(x, channels, h_pad, r)
        num = 2 * _kernel_acc(
            lambda dy, dx: v(dy, dx - r), flipped, size
        ) + cnum
        return jnp.clip(_floordiv_exact(num, den), 0, 255).astype(jnp.uint8)

    return op


def register_kernel_filter(name: str, taps, scale: int | None = None,
                           offset: float = 0.0) -> None:
    """Register a user convolution kernel as a chainable filter stage.

    ``taps``: (2r+1)^2 integers in PIL ``ImageFilter.Kernel`` order (row 0
    first — paste PIL kernels verbatim). ``scale`` defaults to ``sum(taps)``
    (PIL's default); must be a positive integer. ``offset`` must be a
    multiple of 0.5 (covers every PIL builtin). The stage becomes a
    first-class FILTERS entry: chainable with any other stage on every
    execution path, with stencil radius r for row-split halo exchange.

    Re-registering the same name with an identical spec is a no-op;
    a conflicting spec raises.
    """
    taps = tuple(int(t) for t in taps)
    size = int(round(len(taps) ** 0.5))
    if size * size != len(taps) or size % 2 == 0 or not (3 <= size <= 9):
        raise ValueError(
            f"kernel {name!r}: taps must be a full odd square "
            f"(3x3/5x5/7x7/9x9), got {len(taps)} taps"
        )
    if scale is None:
        scale = sum(taps)
    if int(scale) != scale or scale <= 0:
        raise ValueError(
            f"kernel {name!r}: scale must be a positive integer "
            f"(PIL default sum(taps) = {sum(taps)}), got {scale!r}"
        )
    scale = int(scale)
    off2 = 2.0 * float(offset)
    if off2 != int(off2):
        raise ValueError(
            f"kernel {name!r}: offset must be a multiple of 0.5, "
            f"got {offset!r}"
        )
    off2 = int(off2)
    num_bound = 2 * 255 * sum(abs(t) for t in taps) + scale * (abs(off2) + 1)
    if num_bound > _KERNEL_NUM_LIMIT:
        raise ValueError(
            f"kernel {name!r}: |taps|/scale/offset too large for exact "
            f"int32 arithmetic (bound {num_bound} > {_KERNEL_NUM_LIMIT})"
        )
    rows = [list(taps[i * size:(i + 1) * size]) for i in range(size)]
    spec = {
        "taps": taps, "scale": scale, "off2": off2, "size": size,
        "flipped": tuple(tuple(r_) for r_ in rows[::-1]),
        "radius": size // 2,
    }
    prev = KERNEL_STAGES.get(name)
    if prev is not None:
        if prev == spec:
            return
        raise ValueError(
            f"kernel {name!r} already registered with a different spec"
        )
    if name in FILTERS:
        raise ValueError(f"{name!r} is already a builtin filter name")
    KERNEL_STAGES[name] = spec
    FILTERS[name] = _make_kernel_stage(spec)
    ROWS_FILTERS[name] = _make_kernel_stage_rows(spec)
    FILTER_RADIUS[name] = spec["radius"]


# The PIL builtin convolution presets (tap tables as in Pillow 12.1
# ImageFilter.py; the test suite asserts these match the installed PIL's
# `.filterargs` so a Pillow bump can't silently drift them). Registered
# as `pil_*` stages — `pil_sharpen` etc. keep clear of the engine's own
# `sharpen` (the reference's 5-point unsharp).
PIL_PRESETS = {
    "pil_blur": ((1, 1, 1, 1, 1,
                  1, 0, 0, 0, 1,
                  1, 0, 0, 0, 1,
                  1, 0, 0, 0, 1,
                  1, 1, 1, 1, 1), 16, 0),
    "pil_contour": ((-1, -1, -1, -1, 8, -1, -1, -1, -1), 1, 255),
    "pil_detail": ((0, -1, 0, -1, 10, -1, 0, -1, 0), 6, 0),
    "pil_edge_enhance": ((-1, -1, -1, -1, 10, -1, -1, -1, -1), 2, 0),
    "pil_edge_enhance_more": ((-1, -1, -1, -1, 9, -1, -1, -1, -1), 1, 0),
    "pil_emboss": ((-1, 0, 0, 0, 1, 0, 0, 0, 0), 1, 128),
    "pil_find_edges": ((-1, -1, -1, -1, 8, -1, -1, -1, -1), 1, 0),
    "pil_sharpen": ((-2, -2, -2, -2, 32, -2, -2, -2, -2), 16, 0),
    "pil_smooth": ((1, 1, 1, 1, 5, 1, 1, 1, 1), 13, 0),
    "pil_smooth_more": ((1, 1, 1, 1, 1,
                         1, 5, 5, 5, 1,
                         1, 5, 44, 5, 1,
                         1, 5, 5, 5, 1,
                         1, 1, 1, 1, 1), 100, 0),
}

for _nm, (_taps, _scale, _off) in PIL_PRESETS.items():
    register_kernel_filter(_nm, _taps, _scale, _off)


# ---- Static-LUT point stages (brightness / gamma / arbitrary 256-LUTs) ---
#
# Any 256-entry uint8 LUT registers as a radius-0 POINT_STAGES entry, so it
# composes everywhere point stages do: chains in every layout and row-split
# shards (radius 0 -> no halo exchange). The in-graph apply is the static
# comparison-sum: out = lut[0] + sum_{v: lut[v] != lut[v-1]} (x >= v) * d_v
# — the same exact rewrite ops/equalize.py uses for data-dependent LUTs,
# but with the diff vector folded at trace time and zero-diff thresholds
# pruned (a brightness LUT at factor < 1 keeps ~128 of 255 terms; smooth
# monotone LUTs prune further). Integer-only, bit-identical to the gather.
#
# Built-in LUT constructors reproduce PIL exactly:
# - brightness(f) == ImageEnhance.Brightness(im).enhance(f): PIL's
#   Image.blend computes fp32 a + f*(b-a) with a truncating uint8 store
#   (probed over factors incl. 0.7, 1.234: trunc-fp32 matches everywhere,
#   round/half-up don't) -> lut[v] = clip(trunc(fp32(f) * v)).
# - gamma(g): lut[v] = round(255 * (v/255)^g) in float64 (no PIL analog;
#   ImageOps has no gamma — documented engine spec).

LUT_STAGES: dict = {}


def _make_lut_point_fn(lut: "np.ndarray"):
    import numpy as np

    lut = np.asarray(lut)
    base = int(lut[0])
    d = lut.astype(np.int64)
    terms = [(v, int(d[v] - d[v - 1])) for v in range(1, 256)
             if d[v] != d[v - 1]]

    def fn(x):
        acc = None
        for v, dv in terms:
            t = jnp.where(x >= v, dv, 0)
            acc = t if acc is None else acc + t
        return (base + acc) if acc is not None else base + 0 * x

    return fn


def register_lut_filter(name: str, lut) -> None:
    """Register a 256-entry uint8 LUT as a chainable radius-0 point stage.

    Same first-class status as invert/solarize/posterize: the stage works
    on every execution path and in any chain. Re-registering the same
    name with an identical LUT is a no-op; a different LUT raises.
    """
    import numpy as np

    lut = np.asarray(lut)
    if lut.shape != (256,):
        raise ValueError(
            f"LUT {name!r}: expected 256 entries, got shape {lut.shape}"
        )
    if lut.dtype != np.uint8:
        if not (np.issubdtype(lut.dtype, np.integer)
                and lut.min() >= 0 and lut.max() <= 255):
            raise ValueError(
                f"LUT {name!r}: entries must be integers in [0, 255]"
            )
        lut = lut.astype(np.uint8)
    prev = LUT_STAGES.get(name)
    if prev is not None:
        if np.array_equal(prev, lut):
            return
        raise ValueError(f"LUT {name!r} already registered with "
                         "different entries")
    if name in FILTERS:
        raise ValueError(f"{name!r} is already a builtin filter name")
    LUT_STAGES[name] = lut
    fn = _make_lut_point_fn(lut)
    POINT_STAGES[name] = fn
    FILTERS[name] = _make_point_filter(fn)
    ROWS_FILTERS[name] = _make_point_filter_rows(fn)
    FILTER_RADIUS[name] = 0


def brightness_lut(factor: float):
    """PIL ``ImageEnhance.Brightness(im).enhance(factor)`` as a LUT.

    Bit-exact: PIL's Image.blend is fp32 ``a + f*(b-a)`` with a
    truncating uint8 store; brightness blends from black, so
    ``lut[v] = clip(trunc(fp32(factor) * v), 0, 255)``.
    """
    import numpy as np

    if factor < 0:
        raise ValueError(f"brightness factor must be >= 0, got {factor}")
    v = np.arange(256, dtype=np.float32)
    out = np.trunc((np.float32(factor) * v).astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


def solarize_lut(threshold: int = 128):
    """PIL ``ImageOps.solarize(im, threshold)`` as a LUT (exact closed
    form: identity below the threshold, inverted at and above it). The
    fixed-threshold builtin stage ``solarize`` is threshold=128."""
    import numpy as np

    if not 0 <= threshold <= 256:
        raise ValueError(f"threshold must be in [0, 256], got {threshold}")
    v = np.arange(256, dtype=np.int64)
    return np.where(v < threshold, v, 255 - v).astype(np.uint8)


def gamma_lut(gamma: float):
    """Gamma-correction LUT: ``lut[v] = round(255 * (v/255)**gamma)``."""
    import numpy as np

    if gamma <= 0:
        raise ValueError(f"gamma must be > 0, got {gamma}")
    v = np.arange(256, dtype=np.float64) / 255.0
    return np.clip(np.round(255.0 * v ** gamma), 0, 255).astype(np.uint8)


# ---- Generalized rank filters (PIL RankFilter / MedianFilter family) -----
#
# An arbitrary order statistic over a (2r+1)^2 window: PIL's
# ``RankFilter(size, rank)`` (``MedianFilter(n)`` = rank n*n//2,
# ``MinFilter``/``MaxFilter`` = rank 0 / n*n-1). PIL rank filters
# replicate the border before ranking — the engine's clamp-to-edge rule —
# so equality vs PIL holds everywhere, borders included (probed at sizes
# 3/5 across ranks). Selection over the window's shifted views runs an
# odd-even transposition sorting network at sizes 3/5 (pure
# jnp.minimum/maximum on int32 — the same op class as the 3x3 median's
# Paeth network, which stays the fast special case) and a bit-serial
# counting selection at sizes 7/9 (see _rank_select) — both exact by
# construction.

RANK_STAGES: dict = {}


def _rank_select(vals, rank: int):
    """rank-th order statistic of n equal-shape integer arrays.

    Two formulations, chosen by window size:

    * n <= 25 (sizes 3/5): unrolled odd-even transposition network —
      pure min/max, ~n^2/2 compare-exchanges.
    * n > 25 (sizes 7/9): bit-serial counting selection. The full
      network at n=81 is ~3.2k compare-exchanges (~6.5k ops); instead
      binary-search the 8-bit value domain MSB-first: the rank-th
      smallest is >= c iff |{x : x < c}| <= rank, so 8 rounds of
      comparison-sums pin down one bit each — 8*(2n+2) ~ 1.3k ops at
      n=81, exact on integers by construction (and bit-exact vs PIL
      RankFilter like the network it replaces).
    """
    vals = list(vals)
    n = len(vals)
    if n <= 25:
        mn, mx = jnp.minimum, jnp.maximum
        for p in range(n):
            for i in range(p % 2, n - 1, 2):
                a, b = vals[i], vals[i + 1]
                vals[i], vals[i + 1] = mn(a, b), mx(a, b)
        return vals[rank]
    vals = [v.astype(jnp.int32) for v in vals]
    acc = jnp.zeros_like(vals[0])
    for bit in range(7, -1, -1):
        cand = acc + jnp.int32(1 << bit)  # acc has only higher bits set
        cnt = vals[0] < cand
        cnt = cnt.astype(jnp.int32)
        for v in vals[1:]:
            cnt = cnt + (v < cand).astype(jnp.int32)
        acc = jnp.where(cnt <= jnp.int32(rank), cand, acc)
    return acc


def register_rank_filter(name: str, size: int, rank: int) -> None:
    """Register ``PIL.ImageFilter.RankFilter(size, rank)`` as a stage.

    size: odd window edge (3/5/7/9); rank: order statistic in
    [0, size*size). The stage is a first-class FILTERS entry (radius
    size//2): chainable in every layout, halo-aware in row-split.
    Bit-identical to PIL including borders. Idempotent re-registration;
    conflicts raise.
    """
    if size not in (3, 5, 7, 9):
        raise ValueError(
            f"rank filter {name!r}: size must be odd 3..9, got {size} "
            "(PIL RankFilter semantics; larger windows would exceed the "
            "halo machinery's radius support)"
        )
    if not (0 <= rank < size * size):
        raise ValueError(
            f"rank filter {name!r}: rank must be in [0, {size * size - 1}],"
            f" got {rank}"
        )
    spec = (int(size), int(rank))
    prev = RANK_STAGES.get(name)
    if prev is not None:
        if prev == spec:
            return
        raise ValueError(
            f"rank filter {name!r} already registered with a different spec"
        )
    if name in FILTERS:
        raise ValueError(f"{name!r} is already a builtin filter name")
    r = size // 2

    def op(x: jax.Array, *, h_axis: int = -3, w_axis: int = -2,
           h_pad: bool = True) -> jax.Array:
        assert x.dtype == jnp.uint8
        v = _stencil_r(x, h_axis, w_axis, h_pad, r)
        vals = [v(dy, dx) for dy in range(size) for dx in range(size)]
        return _rank_select(vals, rank).astype(jnp.uint8)

    def op_rows(x: jax.Array, channels: int, *,
                h_pad: bool = True) -> jax.Array:
        assert x.dtype == jnp.uint8
        v = _rows_stencil(x, channels, h_pad, r)
        vals = [v(dy, dx) for dy in range(size)
                for dx in range(-r, r + 1)]
        return _rank_select(vals, rank).astype(jnp.uint8)

    RANK_STAGES[name] = spec
    FILTERS[name] = op
    ROWS_FILTERS[name] = op_rows
    FILTER_RADIUS[name] = r


# 5x5/7x7/9x9 builtins of the family (the 3x3 ones exist as the
# specialized median/erode/dilate network ops above). median7/median9 are
# PIL MedianFilter(7)/(9).
register_rank_filter("median5", 5, 12)
register_rank_filter("erode5", 5, 0)
register_rank_filter("dilate5", 5, 24)
register_rank_filter("median7", 7, 24)
register_rank_filter("median9", 9, 40)
