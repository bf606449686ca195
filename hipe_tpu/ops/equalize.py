"""Histogram equalization — the engine's first global-statistics op.

Every other pipeline stage is a local stencil (blur/sharpen/edge/median)
or a codec transform; equalization is driven by *whole-image* statistics:
a per-channel 256-bin histogram builds a monotone LUT that is then applied
pointwise. That changes both halves of the device story:

- **Compute**: the LUT build is integer-only and reproduces PIL's
  ``ImageOps.equalize`` bit-for-bit (the external oracle — PIL is the same
  library the multi-format IO path already trusts for BMP/PNG):
  per channel, ``step = (npix - hist[last_nonzero]) // 255`` and
  ``lut[i] = clip((step//2 + cumsum_excl(hist)[i]) // step, 0, 255)``,
  with the identity LUT when fewer than two distinct values exist or
  ``step == 0``. All arithmetic is int32 floor division, so there is no
  float tolerance anywhere — tests assert exact equality against PIL.
- **Apply**: one ``jnp.take_along_axis`` gather per pixel through the
  plane's LUT (:func:`apply_lut`).
- **Sharding**: there is no halo — a row-sharded image needs a *global*
  histogram, so the SPMD pattern is ``lax.psum`` of per-shard partial
  histograms, not ``ppermute`` halo exchange (see
  :func:`hipe_tpu.parallel.row_split.make_equalize_row_split_fn`).

The reference engine has no counterpart (its one kernel is the 3x3 blur,
`gaussian_kernel.cl:19-72`); this is a beyond-parity
extension exercising the op class the stencil family cannot express.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def histogram_planes(planes: jax.Array) -> jax.Array:
    """Per-plane 256-bin histograms: (N, H, W) uint8 -> (N, 256) int32.

    A broadcast-compare-reduce (XLA fuses it into a streaming
    reduction instead of a contended scatter-add).
    """
    n = planes.shape[0]
    x = planes.reshape(n, -1)
    bins = jnp.arange(256, dtype=jnp.uint8)
    return (x[:, :, None] == bins).astype(jnp.int32).sum(axis=1)


def equalize_lut(hist: jax.Array, npix: int) -> jax.Array:
    """PIL ``ImageOps.equalize`` LUTs from histograms, bit-exact.

    hist: (..., 256) int32 counts summing to ``npix`` (a static int).
    Returns (..., 256) uint8 monotone LUTs. Integer-only arithmetic.
    """
    idx = jnp.arange(256, dtype=jnp.int32)
    csum_excl = jnp.cumsum(hist, axis=-1) - hist
    nonzero = hist > 0
    last_idx = jnp.max(jnp.where(nonzero, idx, -1), axis=-1)
    last_count = jnp.take_along_axis(
        hist, last_idx[..., None].astype(jnp.int32), axis=-1
    )[..., 0]
    num_nonzero = nonzero.sum(axis=-1)
    step = (npix - last_count) // 255
    safe = jnp.maximum(step, 1)
    # PIL clamps LUT entries at 255 in its C point() (values past the last
    # populated bin can mathematically exceed it — verified empirically).
    lut_eq = jnp.clip((safe[..., None] // 2 + csum_excl) // safe[..., None],
                      0, 255)
    use_ident = (num_nonzero <= 1) | (step <= 0)
    return jnp.where(
        use_ident[..., None], jnp.broadcast_to(idx, lut_eq.shape), lut_eq
    ).astype(jnp.uint8)


def apply_lut(planes: jax.Array, lut: jax.Array) -> jax.Array:
    """Gather formulation: out[n, p] = lut[n, planes[n, p]]."""
    n = planes.shape[0]
    flat = planes.reshape(n, -1).astype(jnp.int32)
    return jnp.take_along_axis(lut, flat, axis=1).reshape(planes.shape)


def _rows_via_planar(planar_fn, rows: jax.Array, channels: int,
                     **kw) -> jax.Array:
    """(B, H, W*C) rows -> per-channel planes -> planar_fn -> rows.

    The one copy of the rows<->planar layout dance for every
    global-statistics op (sharded shard bodies included).
    """
    b, h, lane = rows.shape
    assert lane % channels == 0
    w = lane // channels
    planes = rows.reshape(b, h, w, channels)
    planes = planes.transpose(0, 3, 1, 2).reshape(b * channels, h, w)
    out = planar_fn(planes, **kw)
    out = out.reshape(b, channels, h, w).transpose(0, 2, 3, 1)
    return out.reshape(b, h, lane)


def _nhwc_via_rows(rows_fn, x: jax.Array, **kw) -> jax.Array:
    """(..., H, W, C) -> rows_fn on (B, H, W*C) -> original shape."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    b = int(np.prod(lead, dtype=np.int64)) if lead else 1
    out = rows_fn(x.reshape(b, h, w * c), c, **kw)
    return out.reshape(*lead, h, w, c)


def equalize_planar(planes: jax.Array) -> jax.Array:
    """(N, H, W) uint8 -> (N, H, W) uint8, each plane equalized alone."""
    hist = histogram_planes(planes)
    lut = equalize_lut(hist, planes.shape[1] * planes.shape[2])
    return apply_lut(planes, lut)


def equalize_rows(rows: jax.Array, channels: int) -> jax.Array:
    """Interleaved rows (B, H, W*C) uint8, per-channel equalization."""
    return _rows_via_planar(equalize_planar, rows, channels)


def equalize_nhwc(x: jax.Array) -> jax.Array:
    """(..., H, W, C) uint8 -> same shape, per-channel equalization."""
    return _nhwc_via_rows(equalize_rows, x)


# ---------------------------------------------------------------------------
# Autocontrast — the second global-statistics op. PIL ImageOps.autocontrast
# (cutoff=0, ignore=None) semantics: per channel, lo = min pixel value,
# hi = max; identity when hi <= lo; else lut[i] = clip(int(i*scale + offset))
# with scale = 255.0/(hi-lo) computed in FLOAT64. The float LUT genuinely
# diverges from the exact rational floor ((i-lo)*255)//(hi-lo) — e.g.
# lo=26, hi=33: pixel 33 maps to 254, not 255, because fl(255/7) < 255/7 —
# so bit-exactness with PIL requires reproducing the float64 arithmetic.
# Rather than rely on device fp64, the full LUT cube over every (lo, hi) pair is
# precomputed host-side in float64 (256*256 rows x 256 entries, 16 MB
# uint8, cached) and the in-graph op just gathers row (lo, hi) after a
# min/max reduction. Sharded execution needs lax.pmin/pmax of the local
# extrema — a third collective flavor after ppermute halos and psum.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _autocontrast_table() -> np.ndarray:
    """(256, 256, 256) uint8: table[lo, hi] is PIL's float64 LUT."""
    ix = np.arange(256, dtype=np.float64)
    tab = np.empty((256, 256, 256), np.uint8)
    ident = np.arange(256, dtype=np.uint8)
    for lo in range(256):
        tab[lo] = ident  # hi <= lo rows: identity ("don't bother")
        his = np.arange(lo + 1, 256)
        if his.size == 0:
            continue
        scale = 255.0 / (his - lo)
        offset = -lo * scale
        # int() truncates toward zero (negatives clip to 0 anyway).
        vals = np.trunc(ix[None, :] * scale[:, None] + offset[:, None])
        tab[lo, his] = np.clip(vals, 0, 255).astype(np.uint8)
    return tab


def autocontrast_lut(lo: jax.Array, hi: jax.Array) -> jax.Array:
    """(N,) uint8 extrema -> (N, 256) uint8 PIL-exact LUTs.

    Traced inputs gather in-graph from the cube, which is embedded as a
    program constant — 16 MB per compiled executable that uses
    autocontrast (a handful of serving shapes in practice; the
    persistent compile cache amortizes recompiles). Concrete inputs
    never touch a device cube: the (N, 256) rows are gathered in NumPy
    and returned as a host constant, so eager callers ship 256*N bytes,
    not 16 MB, and stay off the default backend (hermeticity — the
    consumer op places the rows with its own operands).
    """
    if isinstance(lo, jax.core.Tracer) or isinstance(hi, jax.core.Tracer):
        tab = jnp.asarray(_autocontrast_table())
        return tab[lo.astype(jnp.int32), hi.astype(jnp.int32)]
    tab = _autocontrast_table()
    return tab[np.asarray(lo).astype(np.int32),
               np.asarray(hi).astype(np.int32)]


def _normalize_cutoff(cutoff) -> tuple[int, int]:
    c = cutoff if isinstance(cutoff, tuple) else (cutoff, cutoff)
    if (len(c) != 2 or not all(isinstance(v, int) for v in c)
            or c[0] < 0 or c[1] < 0 or c[0] + c[1] >= 100):
        raise ValueError(
            f"cutoff must be non-negative integer percent(s) summing "
            f"below 100, got {cutoff!r} (integer-only keeps the trim "
            "arithmetic exact — PIL's int(n*cutoff//100))"
        )
    return c[0], c[1]


def autocontrast_extrema(hist: jax.Array,
                         cutoff: tuple[int, int]) -> tuple:
    """PIL's histogram trim: (lo, hi) bins after cutting cutoff% per end.

    Replicates ImageOps.autocontrast's destructive walk exactly in closed
    form: after removing ``cut0 = n*c0//100`` pixels from the low end,
    ``h_lo[i] = clip(min(h[i], cumsum(h)[i] - cut0), 0)``; the high cut
    applies the same formula to the suffix sums of the trimmed histogram.
    lo/hi are the first/last nonzero bins of the result (lo=255, hi=0
    when the cuts consume everything -> identity row of the LUT cube).
    """
    c0, c1 = cutoff
    h = hist.astype(jnp.int32)
    n = h.sum(axis=-1, keepdims=True)
    cut0 = n * c0 // 100
    csum = jnp.cumsum(h, axis=-1)
    h_lo = jnp.clip(jnp.minimum(h, csum - cut0), 0, None)
    cut1 = n * c1 // 100
    suffix = jnp.cumsum(h_lo[..., ::-1], axis=-1)[..., ::-1]
    h_fin = jnp.clip(jnp.minimum(h_lo, suffix - cut1), 0, None)
    idx = jnp.arange(256, dtype=jnp.int32)
    nz = h_fin > 0
    lo = jnp.min(jnp.where(nz, idx, 255), axis=-1)
    hi = jnp.max(jnp.where(nz, idx, 0), axis=-1)
    return lo, hi


def autocontrast_planar(planes: jax.Array, channels: int = 3, *, cutoff=0,
                        preserve_tone: bool = False) -> jax.Array:
    """(N, H, W) uint8 -> same, contrast-stretched.

    ``cutoff``: percent (or (low, high) percents) of pixels trimmed from
    each histogram end before picking the stretch range — PIL's
    ``autocontrast(cutoff=...)``, integer percents only (exact).
    cutoff=0 skips the histogram entirely (min/max reduce).

    ``preserve_tone=False`` (PIL default) stretches each plane alone
    (``channels`` unused). ``preserve_tone=True`` is PIL's
    ``autocontrast(..., preserve_tone=True)``: ONE per-*image* range from
    the Pillow luma (probe-verified bit-exact: L histogram -> the same
    trim walk -> one cube LUT row applied to all channels), so planes
    must group as b*channels + c like the other per-image ops.
    """
    c0, c1 = _normalize_cutoff(cutoff)
    if preserve_tone:
        n, h, w = planes.shape
        assert n % channels == 0, (n, channels)
        b = n // channels
        l = pil_luma(planes.reshape(b, channels, h, w))
        if c0 == 0 and c1 == 0:
            flat = l.reshape(b, -1)
            lo, hi = flat.min(axis=1), flat.max(axis=1)
        else:
            lo, hi = autocontrast_extrema(histogram_planes(l), (c0, c1))
        lut = autocontrast_lut(lo, hi)
        grouped = planes.reshape(b, channels * h * w)
        out = apply_lut(grouped, lut)
        return out.reshape(planes.shape)
    n = planes.shape[0]
    flat = planes.reshape(n, -1)
    if c0 == 0 and c1 == 0:
        lo, hi = flat.min(axis=1), flat.max(axis=1)
    else:
        lo, hi = autocontrast_extrema(histogram_planes(planes), (c0, c1))
    lut = autocontrast_lut(lo, hi)
    return apply_lut(planes, lut)


def autocontrast_rows(rows: jax.Array, channels: int, *, cutoff=0,
                      preserve_tone: bool = False) -> jax.Array:
    """Interleaved rows (B, H, W*C) uint8 autocontrast."""
    return _rows_via_planar(
        lambda planes, **kw: autocontrast_planar(planes, channels, **kw),
        rows, channels, cutoff=cutoff,
        preserve_tone=preserve_tone,
    )


def autocontrast_nhwc(x: jax.Array, *, cutoff=0,
                      preserve_tone: bool = False) -> jax.Array:
    """(..., H, W, C) uint8 -> same shape autocontrast."""
    return _nhwc_via_rows(autocontrast_rows, x, cutoff=cutoff,
                          preserve_tone=preserve_tone)


def autocontrast_oracle(img: np.ndarray, cutoff=0,
                        preserve_tone: bool = False) -> np.ndarray:
    """NumPy reference replicating PIL autocontrast.

    Deliberately implements PIL's *literal destructive histogram walk*
    (not the closed form the JAX path uses) so the test suite
    cross-checks two independent derivations against PIL itself.
    ``preserve_tone=True`` walks the Pillow-luma histogram once and
    applies the one resulting LUT to every channel (PIL semantics).
    """
    c0, c1 = _normalize_cutoff(cutoff)
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    else:
        squeeze = False
    out = np.empty_like(img)
    if preserve_tone and img.shape[2] == 3:
        r, g, b = (img[..., i].astype(np.int64) for i in range(3))
        tone = ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(
            np.uint8)
        sources = [tone] * 3
    else:
        sources = [img[..., ci] for ci in range(img.shape[2])]
    for ci in range(img.shape[2]):
        chan = img[..., ci]
        h = np.bincount(sources[ci].ravel(), minlength=256).astype(np.int64)
        if c0 or c1:
            n = int(h.sum())
            cut = n * c0 // 100
            for lo_i in range(256):
                if cut > h[lo_i]:
                    cut -= h[lo_i]
                    h[lo_i] = 0
                else:
                    h[lo_i] -= cut
                    cut = 0
                if cut <= 0:
                    break
            cut = n * c1 // 100
            for hi_i in range(255, -1, -1):
                if cut > h[hi_i]:
                    cut -= h[hi_i]
                    h[hi_i] = 0
                else:
                    h[hi_i] -= cut
                    cut = 0
                if cut <= 0:
                    break
        nz = np.nonzero(h)[0]
        lo = int(nz[0]) if nz.size else 255
        hi = int(nz[-1]) if nz.size else 0
        if hi <= lo:
            lut = np.arange(256, dtype=np.uint8)
        else:
            scale = 255.0 / (hi - lo)
            offset = -lo * scale
            lut = np.clip(
                np.trunc(np.arange(256, dtype=np.float64) * scale + offset),
                0, 255,
            ).astype(np.uint8)
        out[..., ci] = lut[chan]
    return out[..., 0] if squeeze else out


def equalize_oracle(img: np.ndarray) -> np.ndarray:
    """NumPy reference implementing PIL ImageOps.equalize per channel.

    (H, W) or (H, W, C) uint8. Tests cross-check this against PIL itself
    AND the JAX paths against it, so the three-way agreement pins the
    semantics.
    """
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    else:
        squeeze = False
    out = np.empty_like(img)
    npix = img.shape[0] * img.shape[1]
    for ci in range(img.shape[2]):
        chan = img[..., ci]
        h = np.bincount(chan.ravel(), minlength=256).astype(np.int64)
        nz = np.nonzero(h)[0]
        step = 0 if len(nz) == 0 else (npix - h[nz[-1]]) // 255
        if len(nz) <= 1 or step == 0:
            lut = np.arange(256, dtype=np.int64)
        else:
            lut = (step // 2 + (np.cumsum(h) - h)) // step
        out[..., ci] = np.clip(lut, 0, 255).astype(np.uint8)[chan]
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# Contrast — PIL ImageEnhance.Contrast semantics, bit-exact. The degenerate
# is a solid gray at mean_i = int(mean(im.convert("L")) + 0.5), blended as
# fp32 ``mean_i + factor*(px - mean_i)`` with a truncating uint8 store
# (probed: trunc-fp32 matches PIL everywhere; round/half-up don't; the L
# conversion is Pillow's fixed-point (19595 R + 38470 G + 7471 B + 0x8000)
# >> 16). Rather than rely on device float semantics for the blend, like
# autocontrast the full (mean, value) LUT cube per factor is built
# host-side in fp32-emulating NumPy (256x256 uint8 = 64 KB, lru-cached) and
# the in-graph op is: luma -> exact round-half mean -> cube row gather ->
# LUT apply. The mean uses the integer identity int(S/N + 0.5) ==
# (2S + N) // (2N), with S accumulated as three "count-of-pixels >= t"
# partial sums so every int32 intermediate stays below 2^31 for images up
# to ~12M pixels (the 4000x2250 asset included). Sharding: psum of partial
# luma histograms (the equalize collective pattern), then identical math.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _contrast_table(factor: float) -> np.ndarray:
    """(256, 256) uint8: table[mean, v] = PIL blend(mean, v, factor)."""
    m = np.arange(256, dtype=np.float32)[:, None]
    v = np.arange(256, dtype=np.float32)[None, :]
    t = (np.float32(factor) * (v - m)).astype(np.float32)
    vals = np.trunc((m + t).astype(np.float32))
    return np.clip(vals, 0, 255).astype(np.uint8)


def contrast_lut(mean_i: jax.Array, factor: float) -> jax.Array:
    """(B,) int32 rounded means -> (B, 256) uint8 PIL-exact LUTs."""
    if isinstance(mean_i, jax.core.Tracer):
        tab = jnp.asarray(_contrast_table(float(factor)))
        return tab[mean_i.astype(jnp.int32)]
    tab = _contrast_table(float(factor))
    return tab[np.asarray(mean_i).astype(np.int32)]


def pil_luma(img4: jax.Array) -> jax.Array:
    """(B, C, H, W) uint8 -> (B, H, W) uint8 Pillow convert("L") luma.

    Pillow's ITU-R 601-2 fixed point: (19595 R + 38470 G + 7471 B +
    0x8000) >> 16, exact in int32. C=1 is the identity (PIL L->L).
    """
    b, c = img4.shape[0], img4.shape[1]
    if c == 1:
        return img4[:, 0]
    if c != 3:
        raise ValueError(
            f"contrast needs 1- or 3-channel images (PIL L / RGB), got C={c}"
        )
    r = img4[:, 0].astype(jnp.int32)
    g = img4[:, 1].astype(jnp.int32)
    bl = img4[:, 2].astype(jnp.int32)
    return ((19595 * r + 38470 * g + 7471 * bl + 0x8000) >> 16).astype(
        jnp.uint8)


def luma_mean_round_half(hist: jax.Array, npix: int) -> jax.Array:
    """(B, 256) luma histograms -> (B,) int32 int(S/npix + 0.5), exact.

    S = sum(v * h_v) rewritten as sum over thresholds of the pixel counts
    >= t, split into three partial sums of <= 85 terms each so every
    int32 intermediate is < 2^31 for npix up to ~12.6M; the rounded mean
    is the piecewise floor of (2S + N) / (2N) — matches PIL's
    float64 int(mean + 0.5) everywhere (the fp64 quotient can't cross a
    rounding boundary: margin >= 1/(2N) vs ~1e-14 division error).
    """
    if 170 * npix >= 2 ** 31:
        raise ValueError(
            f"contrast mean: image too large for exact int32 arithmetic "
            f"({npix} pixels; limit ~12.6M)"
        )
    csum = jnp.cumsum(hist.astype(jnp.int32), axis=-1)
    ge = npix - csum[:, :255]  # ge[:, t-1] = #pixels >= t, t in 1..255
    n2 = 2 * npix
    parts = [ge[:, 0:85].sum(-1), ge[:, 85:170].sum(-1),
             ge[:, 170:255].sum(-1)]
    nums = [2 * parts[0], 2 * parts[1], 2 * parts[2] + npix]
    q = sum(n // n2 for n in nums)
    rem = sum(n % n2 for n in nums)
    return q + rem // n2


def contrast_planar(planes: jax.Array, channels: int = 3, *,
                    factor: float = 1.0) -> jax.Array:
    """(B*C, H, W) uint8 (plane index = b*C + c) -> same, per image.

    Unlike equalize/autocontrast (per-channel statistics), the contrast
    LUT is per *image*: one luma mean across all channels, one LUT row
    applied to every channel — PIL's degenerate-gray blend.
    """
    n, h, w = planes.shape
    assert n % channels == 0, (n, channels)
    b = n // channels
    img4 = planes.reshape(b, channels, h, w)
    l = pil_luma(img4)
    hist = histogram_planes(l)
    mean_i = luma_mean_round_half(hist, h * w)
    lut = contrast_lut(mean_i, factor)
    grouped = planes.reshape(b, channels * h * w)
    out = apply_lut(grouped, lut)
    return out.reshape(planes.shape)


def contrast_rows(rows: jax.Array, channels: int, *,
                  factor: float = 1.0) -> jax.Array:
    """Interleaved rows (B, H, W*C) uint8, per-image contrast."""
    return _rows_via_planar(
        lambda planes, **kw: contrast_planar(planes, channels, **kw),
        rows, channels, factor=factor,
    )


def contrast_nhwc(x: jax.Array, *, factor: float = 1.0) -> jax.Array:
    """(..., H, W, C) uint8 -> same shape, per-image contrast."""
    return _nhwc_via_rows(contrast_rows, x, factor=factor)


def contrast_oracle(img: np.ndarray, factor: float = 1.0) -> np.ndarray:
    """NumPy reference for PIL ImageEnhance.Contrast, int64 statistics."""
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    else:
        squeeze = False
    h, w, c = img.shape
    if c == 1:
        l = img[..., 0].astype(np.int64)
    else:
        r, g, b = (img[..., i].astype(np.int64) for i in range(3))
        l = (19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16
    s = int(l.sum())
    npix = h * w
    mean_i = (2 * s + npix) // (2 * npix)
    lut = _contrast_table(float(factor))[mean_i]
    out = lut[img]
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# Color (saturation) — PIL ImageEnhance.Color, bit-exact. The degenerate is
# the image's own Pillow luma replicated across channels, blended per PIXEL:
# out_c = trunc(fp32(l + factor*(c - l))). Unlike contrast there is no
# image-wide statistic and no LUT — the fp32 blend is emulated directly
# in-graph (XLA's f32 multiply-add is IEEE round-to-nearest like PIL's C,
# and the truncating store matches; probed bit-exact across factors).
# Cross-channel (needs the pixel's full RGB), so it lives in this module's
# channels-aware op family rather than the channel-independent FILTERS.
# Sharding is trivial: per-pixel, no collective (make_color_row_split_fn).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _color_product_table(factor: float) -> np.ndarray:
    """(511,) fp32: the PIL-rounded products factor*d for d in [-255, 255]."""
    d = np.arange(-255, 256, dtype=np.float32)
    return (np.float32(factor) * d).astype(np.float32)


def color_planar(planes: jax.Array, channels: int = 3, *,
                 factor: float = 1.0) -> jax.Array:
    """(B*C, H, W) uint8 (plane index = b*C + c) -> same, per pixel."""
    n, h, w = planes.shape
    assert n % channels == 0, (n, channels)
    if channels == 1:
        # PIL Color on an L image blends it with itself: the identity
        # (l + f*(l - l) truncates back to l exactly).
        return planes
    b = n // channels
    img4 = planes.reshape(b, channels, h, w)
    l = pil_luma(img4)
    # PIL rounds the fp32 product factor*(c-l) BEFORE the add; under jit
    # XLA contracts an in-graph mul+add into an FMA (skipping that
    # rounding — measured ±1 on ~1.7% of pixels at factor 2.2, and
    # optimization_barrier does not stop the backend contraction), so the
    # rounded products are precomputed host-side as a 511-entry fp32
    # table over d = c-l and gathered; the remaining add + trunc are
    # single IEEE ops no backend can fuse. Bit-exact vs PIL everywhere.
    prod = jnp.asarray(_color_product_table(float(factor)))
    d = img4.astype(jnp.int32) - l.astype(jnp.int32)[:, None]
    t = jnp.take(prod, d + 255)
    v = l.astype(jnp.float32)[:, None] + t
    out = jnp.clip(jnp.trunc(v), 0, 255).astype(jnp.uint8)
    return out.reshape(planes.shape)


def color_rows(rows: jax.Array, channels: int, *,
               factor: float = 1.0) -> jax.Array:
    """Interleaved rows (B, H, W*C) uint8, per-pixel saturation blend."""
    return _rows_via_planar(
        lambda planes, **kw: color_planar(planes, channels, **kw),
        rows, channels, factor=factor,
    )


def color_nhwc(x: jax.Array, *, factor: float = 1.0) -> jax.Array:
    """(..., H, W, C) uint8 -> same shape, per-pixel saturation blend."""
    return _nhwc_via_rows(color_rows, x, factor=factor)


def color_oracle(img: np.ndarray, factor: float = 1.0) -> np.ndarray:
    """NumPy fp32 reference for PIL ImageEnhance.Color."""
    if img.ndim == 2 or img.shape[-1] == 1:
        return img.copy()
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    l = ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16)
    lf = l.astype(np.float32)[..., None]
    v = (lf + (np.float32(factor)
               * (img.astype(np.float32) - lf)).astype(np.float32)
         ).astype(np.float32)
    return np.clip(np.trunc(v), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Sharpness — PIL ImageEnhance.Sharpness, bit-exact, completing the
# ImageEnhance quartet (Brightness is a LUT stage in ops/blur.py). The
# degenerate is the image filtered with ImageFilter.SMOOTH — whose odd
# scale (13) makes PIL's fp32 kernel identical to the exact integer
# round-half-up (ops/blur.py pil_smooth) — with PIL's kernel-filter border
# rule (border pixels copied through unfiltered, so the blend there is
# blend(x, x, f) = x: the output border IS the input border). The blend
# reuses the color op's host-rounded fp32 product table over d = x - sm
# (same FMA-contraction trap, same fix). Channel-independent but
# border-POSITION-dependent, so it lives in this family (the clamp-window
# row-split machinery assumes translation-invariant stages); sharding is
# one ppermute halo row + axis-index border masks
# (make_sharpness_row_split_fn).
# ---------------------------------------------------------------------------


def _sharpness_blend(x_i32: jax.Array, sm_i32: jax.Array,
                     factor: float) -> jax.Array:
    prod = jnp.asarray(_color_product_table(float(factor)))
    t = jnp.take(prod, x_i32 - sm_i32 + 255)
    v = sm_i32.astype(jnp.float32) + t
    return jnp.clip(jnp.trunc(v), 0, 255).astype(jnp.uint8)


def sharpness_planar(planes: jax.Array, channels: int = 3, *,
                     factor: float = 1.0) -> jax.Array:
    """(N, H, W) uint8 -> same; channel-independent, so any plane layout."""
    from hipe_tpu.ops import blur as xblur

    sm = xblur.FILTERS["pil_smooth"](planes, h_axis=-2, w_axis=-1)
    out = _sharpness_blend(planes.astype(jnp.int32), sm.astype(jnp.int32),
                           factor)
    h, w = planes.shape[-2], planes.shape[-1]
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    border = (ys == 0) | (ys == h - 1) | (xs == 0) | (xs == w - 1)
    return jnp.where(border, planes, out)


def sharpness_rows(rows: jax.Array, channels: int, *,
                   factor: float = 1.0) -> jax.Array:
    """Interleaved rows (B, H, W*C) uint8, per-channel sharpness."""
    return _rows_via_planar(
        lambda planes, **kw: sharpness_planar(planes, channels, **kw),
        rows, channels, factor=factor,
    )


def sharpness_nhwc(x: jax.Array, *, factor: float = 1.0) -> jax.Array:
    """(..., H, W, C) uint8 -> same shape, PIL sharpness."""
    return _nhwc_via_rows(sharpness_rows, x, factor=factor)


def sharpness_oracle(img: np.ndarray, factor: float = 1.0) -> np.ndarray:
    """NumPy reference for PIL ImageEnhance.Sharpness."""
    from hipe_tpu.ops.reference import kernel_oracle

    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    else:
        squeeze = False
    sm = kernel_oracle(img, (1, 1, 1, 1, 5, 1, 1, 1, 1), 13, 0).astype(
        np.int64)
    d = img.astype(np.int64) - sm
    t = _color_product_table(float(factor))[d + 255]
    v = (sm.astype(np.float32) + t).astype(np.float32)
    out = np.clip(np.trunc(v), 0, 255).astype(np.uint8)
    out[0] = img[0]
    out[-1] = img[-1]
    out[:, 0] = img[:, 0]
    out[:, -1] = img[:, -1]
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# Colorize — PIL ImageOps.colorize: grayscale -> RGB through three
# per-channel wedge LUTs built with pure integer floor-division
# interpolation (Pillow's own loops — no float anywhere), trivially exact.
# The serving pipeline applies it as the mirror of gray output
# (ServingPipeline(colorize=...)): L rows gather through the three LUTs
# into interleaved RGB before encode.
# ---------------------------------------------------------------------------


def colorize_lut(black, white, mid=None, blackpoint: int = 0,
                 whitepoint: int = 255, midpoint: int = 127) -> np.ndarray:
    """(3, 256) uint8 wedge LUTs — PIL ``ImageOps.colorize`` bit-exact.

    Colors are RGB triples, ``#rgb`` / ``#rrggbb`` strings, or color
    names (resolved through PIL's ``ImageColor`` table, imported only for
    names). Integer arithmetic identical to Pillow's list construction
    (floor-division interpolation over the point ranges), verified
    against PIL in the tests.
    """

    def rgb(c):
        if not isinstance(c, str):
            return tuple(c)
        hx = c[1:] if c.startswith("#") else None
        if hx is not None and len(hx) in (3, 6):
            if len(hx) == 3:
                hx = "".join(ch * 2 for ch in hx)
            try:
                return tuple(int(hx[i:i + 2], 16) for i in (0, 2, 4))
            except ValueError:
                pass
        from PIL import ImageColor

        return ImageColor.getrgb(c)

    kb, kw = rgb(black), rgb(white)
    km = rgb(mid) if mid is not None else None
    if km is None:
        if not 0 <= blackpoint <= whitepoint <= 255:
            raise ValueError(
                f"need 0 <= blackpoint <= whitepoint <= 255, got "
                f"{blackpoint}/{whitepoint}"
            )
    elif not 0 <= blackpoint <= midpoint <= whitepoint <= 255:
        raise ValueError(
            f"need 0 <= blackpoint <= midpoint <= whitepoint <= 255, got "
            f"{blackpoint}/{midpoint}/{whitepoint}"
        )
    lut = np.empty((3, 256), np.int64)
    for ch in range(3):
        vals = [kb[ch]] * blackpoint
        if km is None:
            n = whitepoint - blackpoint
            vals += [kb[ch] + i * (kw[ch] - kb[ch]) // n for i in range(n)]
        else:
            n1 = midpoint - blackpoint
            vals += [kb[ch] + i * (km[ch] - kb[ch]) // n1 for i in range(n1)]
            n2 = whitepoint - midpoint
            vals += [km[ch] + i * (kw[ch] - km[ch]) // n2 for i in range(n2)]
        vals += [kw[ch]] * (256 - whitepoint)
        lut[ch] = vals
    return lut.astype(np.uint8)


def colorize_oracle(gray: np.ndarray, lut3: np.ndarray) -> np.ndarray:
    """(H, W) uint8 -> (H, W, 3) via the three wedge LUTs."""
    return np.stack([lut3[c][gray] for c in range(3)], axis=-1)


# ---------------------------------------------------------------------------
# Mode filter — PIL ImageFilter.ModeFilter, bit-exact; completes the
# integer-exact ImageFilter family (Kernel presets, Rank/Median/Min/Max
# live in ops/blur.py). Semantics pinned empirically against Pillow and
# asserted exactly in tests/test_mode_filter.py:
#
# - per band, for each pixel: histogram the size x size window TRUNCATED
#   at the image bounds (out-of-image positions are EXCLUDED — not
#   clamp-replicated like every stencil stage);
# - the mode is the first maximum of the 0..255 histogram scan, i.e.
#   ties break to the LOWEST pixel value;
# - a mode that occurs <= 2 times is ignored: the original pixel wins.
#
# Device formulation: no histograms — lift the window values to int32 with a
# -1 sentinel in the out-of-image positions (sentinels match only each
# other and are never candidates), count each window value's occurrences
# with a pairwise equality-sum (J*(J-1)/2 fused compares), and select
# via one packed key max: key = count*256 + (255 - value) for valid
# positions, 0 for sentinels. The max key's count and value decode with
# a shift/mask; count > 2 gates against the center pixel. Everything is
# int32 compare/add/max — one fused elementwise graph, one memory pass.
#
# The truncated window makes borders GLOBAL-position-dependent (same
# wrinkle as sharpness's border-copy rule), so mode lives in this family:
# row-split sharding is ppermute halos plus axis-index masks that turn
# only the true first/last shard's outer halo rows into sentinels
# (make_mode_row_split_fn). The reference engine has no counterpart
# (its one kernel is the 3x3 blur, gaussian_kernel.cl:19-72).
# ---------------------------------------------------------------------------

_MODE_SENTINEL = -1


def _mode_core_i32(xp: jax.Array, size: int) -> jax.Array:
    """Mode-select over a padded int32 stack: (..., H+2r, W+2r) -> uint8.

    ``xp`` carries real window values where the window is inside the
    global image and the -1 sentinel where it is not (global edges).
    """
    from jax import lax

    r = size // 2
    hn = xp.shape[-2] - 2 * r
    wn = xp.shape[-1] - 2 * r

    def view(dy, dx):
        v = lax.slice_in_dim(xp, dy, dy + hn, axis=-2)
        return lax.slice_in_dim(v, dx, dx + wn, axis=-1)

    vals = [view(dy, dx) for dy in range(size) for dx in range(size)]
    j = len(vals)
    ones = jnp.ones((), jnp.int32)
    counts = [ones for _ in range(j)]  # self-match; broadcasts on first add
    for a in range(j):
        for b in range(a + 1, j):
            eq = (vals[a] == vals[b]).astype(jnp.int32)
            counts[a] = counts[a] + eq
            counts[b] = counts[b] + eq
    best = None
    for v, c in zip(vals, counts):
        key = jnp.where(v >= 0, c * 256 + (255 - v), 0)
        best = key if best is None else jnp.maximum(best, key)
    cnt = best >> 8
    val = 255 - (best & 255)
    center = vals[(size * size) // 2]
    return jnp.where(cnt > 2, val, center).astype(jnp.uint8)


def mode_planar(planes: jax.Array, channels: int = 3, *,
                size: int = 3) -> jax.Array:
    """(N, H, W) uint8 -> same; PIL ``ImageFilter.ModeFilter(size)``.

    Channel-independent (PIL filters each band alone), so any plane
    layout works; ``channels`` is accepted for family-signature symmetry.
    """
    assert planes.dtype == jnp.uint8
    if size not in (3, 5):
        raise ValueError(f"mode filter size must be 3 or 5, got {size}")
    r = size // 2
    xi = planes.astype(jnp.int32)
    pad = [(0, 0)] * (xi.ndim - 2) + [(r, r), (r, r)]
    xp = jnp.pad(xi, pad, constant_values=_MODE_SENTINEL)
    return _mode_core_i32(xp, size)


def mode_rows(rows: jax.Array, channels: int, *, size: int = 3) -> jax.Array:
    """Interleaved rows (B, H, W*C) uint8, per-channel mode filter."""
    return _rows_via_planar(
        lambda planes, **kw: mode_planar(planes, channels, **kw),
        rows, channels, size=size,
    )


def mode_nhwc(x: jax.Array, *, size: int = 3) -> jax.Array:
    """(..., H, W, C) uint8 -> same shape, PIL ModeFilter."""
    return _nhwc_via_rows(mode_rows, x, size=size)


def mode5_planar(planes: jax.Array, channels: int = 3) -> jax.Array:
    """PIL ``ImageFilter.ModeFilter(5)`` on planes."""
    return mode_planar(planes, channels, size=5)


def mode5_rows(rows: jax.Array, channels: int) -> jax.Array:
    return mode_rows(rows, channels, size=5)


def mode5_nhwc(x: jax.Array) -> jax.Array:
    return mode_nhwc(x, size=5)


def mode_oracle(img: np.ndarray, size: int = 3) -> np.ndarray:
    """NumPy histogram-scan reference for PIL ModeFilter (test-scale).

    Independent formulation: per value v in 0..255, box-sum the one-hot
    plane over the zero-padded (truncated) window; the first argmax over
    v is the lowest-valued mode, gated on count > 2.
    """
    if img.ndim == 3:
        return np.stack(
            [mode_oracle(img[..., c], size) for c in range(img.shape[-1])],
            axis=-1,
        )
    h, w = img.shape
    r = size // 2
    onehot = (
        img[None] == np.arange(256, dtype=np.int32)[:, None, None]
    ).astype(np.int32)
    op = np.pad(onehot, ((0, 0), (r, r), (r, r)))
    cnt = np.zeros_like(onehot)
    for dy in range(size):
        for dx in range(size):
            cnt += op[:, dy:dy + h, dx:dx + w]
    maxcnt = cnt.max(axis=0)
    maxval = cnt.argmax(axis=0).astype(np.uint8)  # first max = lowest value
    return np.where(maxcnt > 2, maxval, img).astype(np.uint8)
