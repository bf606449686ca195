"""Device-side JPEG decode: dequantize + IDCT + upsample + color convert.

The device decode split. JPEG decoding is two very different halves:

- **Entropy decode** (Huffman/arithmetic) is serial and branchy — it stays on
  the host (`io_/jpeg.py:read_coefficients`, backed by libjpeg's
  ``jpeg_read_coefficients``), exactly as the reference keeps its decode on
  the host CPU (CImg ``load_jpeg``, `CImg/CImg.h:51770`,
  used by `heterogeneous_blur.c:106-137`).
- **Dequantize + IDCT + chroma upsample + YCbCr->RGB** is dense, regular
  vector math — this module runs it on the accelerator, batched over images.

Everything here is **bit-exact against libjpeg(-turbo)'s default integer
pipeline**: ``jpeg_idct_islow`` (jidctint.c — 13-bit fixed-point Loeffler
IDCT with PASS1_BITS=2 and the wrap-around range-limit table),
``h2v2_fancy_upsample`` / ``h2v1_fancy_upsample`` (jdsample.c triangular
filters), and ``ycc_rgb_convert`` (jdcolor.c 16-bit fixed-point tables).
All arithmetic is int32 with the same rounding/shift semantics, so the
decoded pixels equal the host codec's byte-for-byte (asserted by
tests/test_jpeg_device.py on real encodes, including progressive).

Layout: the 64 DCT coefficient positions become 64 separate
``(B, Hb, Wb)`` planes (block-grid coords in the minor dims), the two IDCT
passes are Python-unrolled elementwise graphs over those planes (XLA fuses
them into a handful of elementwise kernels), and plane assembly is one
relayout. No gathers, no dynamic shapes, no per-block loops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# jidctint.c fixed-point constants (CONST_BITS = 13).
CONST_BITS = 13
PASS1_BITS = 2
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172

# jidctred.c fixed-point constants (reduced-size IDCTs, CONST_BITS = 13).
_R_0_211164243 = 1730
_R_0_509795579 = 4176
_R_0_601344887 = 4926
_R_0_720959822 = 5906
_R_0_850430095 = 6967
_R_1_061594337 = 8697
_R_1_272758580 = 10426
_R_1_451774981 = 11893
_R_2_172734803 = 17799
_R_3_624509785 = 29692

# jdcolor.c constants (SCALEBITS = 16).
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_FIX_1_40200 = _fix(1.40200)
_FIX_1_77200 = _fix(1.77200)
_FIX_0_71414 = _fix(0.71414)
_FIX_0_34414 = _fix(0.34414)


def _descale(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """DESCALE(x, n) = arithmetic shift with round-half-up (jpegint.h)."""
    return (x + (1 << (n - 1))) >> n


def _range_limit(val: jnp.ndarray) -> jnp.ndarray:
    """Exact emulation of libjpeg's post-IDCT range-limit table.

    jdmaster.c prepare_range_limit_table builds a 1024-entry wrap-around
    table indexed by ``val & RANGE_MASK``; for in-range values it is
    clamp(val + 128, 0, 255), and far-out-of-range (corrupt-stream) values
    wrap exactly as the table does. Reproduced arithmetically so no gather
    is needed.
    """
    m = val & 1023
    return jnp.where(
        m < 128, m + 128,
        jnp.where(m < 512, 255, jnp.where(m < 896, 0, m - 896)),
    )


def _idct_1d(d: list[jnp.ndarray], final: bool) -> list[jnp.ndarray]:
    """One 8-point islow IDCT pass over 8 coefficient planes.

    ``final=False``: column pass — output descaled by CONST_BITS-PASS1_BITS.
    ``final=True``: row pass — output descaled by CONST_BITS+PASS1_BITS+3
    (sample-domain; caller applies the range limit). Bit-exact port of the
    jidctint.c arithmetic (int32, same rounding).
    """
    shift = (CONST_BITS - PASS1_BITS) if not final else (
        CONST_BITS + PASS1_BITS + 3
    )
    # Even part: rotator c(-6).
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F_0_541196100
    t2 = z1 - z3 * _F_1_847759065
    t3 = z1 + z2 * _F_0_765366865
    z2, z3 = d[0], d[4]
    t0 = (z2 + z3) << CONST_BITS
    t1 = (z2 - z3) << CONST_BITS
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    # Odd part.
    o0, o1, o2, o3 = d[7], d[5], d[3], d[1]
    z1 = o0 + o3
    z2 = o1 + o2
    z3 = o0 + o2
    z4 = o1 + o3
    z5 = (z3 + z4) * _F_1_175875602
    o0 = o0 * _F_0_298631336
    o1 = o1 * _F_2_053119869
    o2 = o2 * _F_3_072711026
    o3 = o3 * _F_1_501321110
    z1 = z1 * -_F_0_899976223
    z2 = z2 * -_F_2_562915447
    z3 = z3 * -_F_1_961570560 + z5
    z4 = z4 * -_F_0_390180644 + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4
    return [
        _descale(t10 + o3, shift),
        _descale(t11 + o2, shift),
        _descale(t12 + o1, shift),
        _descale(t13 + o0, shift),
        _descale(t13 - o0, shift),
        _descale(t12 - o1, shift),
        _descale(t11 - o2, shift),
        _descale(t10 - o3, shift),
    ]


def _dequant_planes(coefs: jnp.ndarray, qtable: np.ndarray) -> list:
    """(..., Hb, Wb, 64) coefficients -> 64 dequantized (..., Hb*Wb) planes.

    Layout: one explicit device transpose turns the input into 64
    coefficient planes with the whole block grid flattened into the minor
    axis, so every IDCT op is one long contiguous elementwise pass.
    """
    q = np.asarray(qtable, dtype=np.int32)
    bshape = coefs.shape[:-3]
    n = coefs.shape[-3] * coefs.shape[-2]
    # Relayout in the narrow dtype; widen to int32 only at the dequant
    # multiply (halves the transpose's memory traffic).
    t = jnp.swapaxes(coefs.reshape(*bshape, n, 64), -1, -2)
    return [t[..., k, :].astype(jnp.int32) * int(q[k]) for k in range(64)]


def _idct_planes_core(planes: list) -> list:
    """64 dequantized planes -> 64 uint8 sample-position planes.

    Column pass (fixed block column c walks rows, index r*8+c), then row
    pass, then the range limit — the full jidctint.c pipeline as an
    unrolled elementwise graph over whatever plane shape the caller chose.
    """
    ws: list = [None] * 64
    for c in range(8):
        col = _idct_1d([planes[r * 8 + c] for r in range(8)], final=False)
        for r in range(8):
            ws[r * 8 + c] = col[r]
    out: list = [None] * 64
    for r in range(8):
        row = _idct_1d([ws[r * 8 + c] for c in range(8)], final=True)
        for c in range(8):
            out[r * 8 + c] = _range_limit(row[c]).astype(jnp.uint8)
    return out


def _idct4_1d(d: list, final: bool) -> list:
    """One 4-point reduced IDCT pass (jidctred.c jpeg_idct_4x4 arithmetic).

    d: the 7 used coefficient planes in index order [0,1,2,3,5,6,7]
    (frequency 4 never contributes to a 4-point output). Bit-exact port of
    the jidctred.c fixed-point math, int32 like the islow path.
    """
    d0, d1, d2, d3, d5, d6, d7 = d
    shift = (CONST_BITS - PASS1_BITS + 1) if not final else (
        CONST_BITS + PASS1_BITS + 3 + 1
    )
    t0 = d0 << (CONST_BITS + 1)
    t2 = d2 * _F_1_847759065 - d6 * _F_0_765366865
    t10, t12 = t0 + t2, t0 - t2
    o0 = (d7 * -_R_0_211164243 + d5 * _R_1_451774981
          + d3 * -_R_2_172734803 + d1 * _R_1_061594337)
    o2 = (d7 * -_R_0_509795579 + d5 * -_R_0_601344887
          + d3 * _F_0_899976223 + d1 * _F_2_562915447)
    return [
        _descale(t10 + o2, shift),
        _descale(t12 + o0, shift),
        _descale(t12 - o0, shift),
        _descale(t10 - o2, shift),
    ]


def _idct2_1d(d: list, final: bool) -> list:
    """One 2-point reduced IDCT pass (jidctred.c jpeg_idct_2x2 arithmetic).

    d: the 5 used coefficient planes in index order [0,1,3,5,7]
    (even frequencies 2,4,6 never contribute to a 2-point output).
    """
    d0, d1, d3, d5, d7 = d
    shift = (CONST_BITS - PASS1_BITS + 2) if not final else (
        CONST_BITS + PASS1_BITS + 3 + 2
    )
    t10 = d0 << (CONST_BITS + 2)
    t0 = (d7 * -_R_0_720959822 + d5 * _R_0_850430095
          + d3 * -_R_1_272758580 + d1 * _R_3_624509785)
    return [_descale(t10 + t0, shift), _descale(t10 - t0, shift)]


def _idct_planes_reduced(planes: list, ssize: int) -> list:
    """64 dequantized planes -> ssize x ssize uint8 sample-position planes.

    The reduced-IDCT analog of `_idct_planes_core`: output entries live at
    index r*8+c for r, c < ssize (the rest stay None) so the result feeds
    `_grid_from_planes(out, hb, wb, range(ssize), range(ssize))` unchanged.
    Bit-exact vs jidctred.c's jpeg_idct_4x4 / 2x2 / 1x1 (verified against
    the installed libjpeg's scaled decode by tests/test_jpeg_scaled.py).
    """
    if ssize == 8:
        return _idct_planes_core(planes)
    out: list = [None] * 64
    if ssize == 1:
        out[0] = _range_limit(_descale(planes[0], 3)).astype(jnp.uint8)
        return out
    if ssize == 4:
        cols, rows_n = [0, 1, 2, 3, 5, 6, 7], 4
        pass1d = _idct4_1d
    elif ssize == 2:
        cols, rows_n = [0, 1, 3, 5, 7], 2
        pass1d = _idct2_1d
    else:
        raise ValueError(f"unsupported reduced IDCT size: {ssize}")
    ws: list = [None] * 64
    for c in cols:
        col = pass1d([planes[r * 8 + c] for r in cols], final=False)
        for k in range(rows_n):
            ws[k * 8 + c] = col[k]
    for k in range(rows_n):
        row = pass1d([ws[k * 8 + c] for c in cols], final=True)
        for j in range(rows_n):
            out[k * 8 + j] = _range_limit(row[j]).astype(jnp.uint8)
    return out


def _grid_from_planes(out: list, hb: int, wb: int,
                      rs: range, cs_: range) -> jnp.ndarray:
    """Assemble sample-position planes into a pixel grid, transpose-free.

    samples[..., len(rs)*i + ri, len(cs_)*j + ci] =
        out[rs[ri]*8 + cs_[ci]][..., i*wb + j]

    With rs=cs_=range(8) this is the full (..., hb*8, wb*8) image; with a
    parity subset (e.g. rs=range(0, 8, 2)) it is a phase grid of the image
    — used to feed the fused upsample+color path without ever assembling
    (or strided-reslicing) the full-resolution plane. Two stack+reshape
    interleaves; no transpose, no gather.
    """
    first = out[0]
    bshape = first.shape[:-1]
    rows = [
        jnp.stack(
            [out[r * 8 + c].reshape(*bshape, hb, wb) for c in cs_],
            axis=-1,
        ).reshape(*bshape, hb, wb * len(cs_))
        for r in rs
    ]
    grid = jnp.stack(rows, axis=-2)  # (..., hb, len(rs), wb*len(cs_))
    return grid.reshape(*bshape, hb * len(rs), wb * len(cs_))


def idct8x8_islow(coefs: jnp.ndarray, qtable: np.ndarray) -> jnp.ndarray:
    """Dequantize + 2-D islow IDCT of a block grid, bit-exact vs jidctint.c.

    coefs: (..., Hb, Wb, 64) int16/int32 quantized coefficients in natural
    order (as the entropy decoder stores them, jdhuff.c). qtable: (64,)
    host-side quant table. Returns (..., Hb*8, Wb*8) uint8 sample planes.
    """
    hb, wb = coefs.shape[-3], coefs.shape[-2]
    out = _idct_planes_core(_dequant_planes(coefs, qtable))
    return _grid_from_planes(out, hb, wb, range(8), range(8))


def _clamp_rows(x: jnp.ndarray, offset: int) -> jnp.ndarray:
    """Row-shifted copy with edge replication (static slicing, no gather)."""
    if offset == -1:
        return jnp.concatenate([x[..., :1, :], x[..., :-1, :]], axis=-2)
    if offset == 1:
        return jnp.concatenate([x[..., 1:, :], x[..., -1:, :]], axis=-2)
    raise ValueError(offset)


def _clamp_cols(x: jnp.ndarray, offset: int) -> jnp.ndarray:
    if offset == -1:
        return jnp.concatenate([x[..., :, :1], x[..., :, :-1]], axis=-1)
    if offset == 1:
        return jnp.concatenate([x[..., :, 1:], x[..., :, -1:]], axis=-1)
    raise ValueError(offset)


def _interleave(a: jnp.ndarray, b: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Elementwise interleave of two same-shape arrays along `axis`."""
    stacked = jnp.stack([a, b], axis=axis + 1 if axis >= 0 else axis)
    shape = list(a.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def fancy_upsample_h2v2(plane: jnp.ndarray) -> jnp.ndarray:
    """2x2 triangular chroma upsample, bit-exact vs jdsample.c h2v2_fancy.

    plane: (..., h, w) uint8/int32. Returns (..., 2h, 2w) int32 samples.
    Per output pixel: (9*nearest + 3*next-h + 3*next-v + 1*diagonal) with
    the reference's exact rounding (+8 for even columns, +7 for odd) and
    edge replication at all four borders.
    """
    x = plane.astype(jnp.int32)
    up = _clamp_rows(x, -1)
    down = _clamp_rows(x, 1)
    cs_even = 3 * x + up      # vertical pair sums for output rows 2i
    cs_odd = 3 * x + down     # and 2i+1
    cs = _interleave(cs_even, cs_odd, axis=-2)  # (..., 2h, w)
    left = _clamp_cols(cs, -1)
    right = _clamp_cols(cs, 1)
    out_even = (3 * cs + left + 8) >> 4
    out_odd = (3 * cs + right + 7) >> 4
    return _interleave(out_even, out_odd, axis=-1)  # (..., 2h, 2w)


def fancy_upsample_h2v1(plane: jnp.ndarray) -> jnp.ndarray:
    """2x1 triangular chroma upsample, bit-exact vs jdsample.c h2v1_fancy."""
    x = plane.astype(jnp.int32)
    left = _clamp_cols(x, -1)
    right = _clamp_cols(x, 1)
    out_even = (3 * x + left + 1) >> 2
    out_odd = (3 * x + right + 2) >> 2
    return _interleave(out_even, out_odd, axis=-1)


def fancy_upsample_h1v2(plane: jnp.ndarray) -> jnp.ndarray:
    """1x2 (vertical-only, 4:4:0) triangular chroma upsample.

    Bit-exact vs libjpeg-turbo's jdsample.c h1v2_fancy_upsample — the
    vertical transpose of h2v1: even output rows take (3*x + above + 1)>>2,
    odd rows (3*x + below + 2)>>2, edges replicated (verified empirically
    against the installed library over odd/even dims).
    """
    x = plane.astype(jnp.int32)
    up = _clamp_rows(x, -1)
    down = _clamp_rows(x, 1)
    out_even = (3 * x + up + 1) >> 2
    out_odd = (3 * x + down + 2) >> 2
    return _interleave(out_even, out_odd, axis=-2)


def _replicate(plane: jnp.ndarray, hr: int, vr: int) -> jnp.ndarray:
    """Plain pixel replication (jdsample.c int_upsample) by (hr, vr)."""
    x = plane.astype(jnp.int32)
    if vr > 1:
        x = jnp.repeat(x, vr, axis=-2)
    if hr > 1:
        x = jnp.repeat(x, hr, axis=-1)
    return x


def upsample_component(plane: jnp.ndarray, hr: int, vr: int) -> jnp.ndarray:
    """Upsample one component by (hr, vr), exactly as jdsample.c selects.

    Per component (independent of the others): identity at (1, 1), the
    triangular fancy filters for (2, 1)/(1, 2)/(2, 2), and plain pixel
    replication (int_upsample) for every other integer ratio — 4:1:1,
    4:1:0, 3:1:1 etc. jdsample.c's narrow-plane guard is honored: the
    horizontal-ratio-2 fancy upsamplers require downsampled_width > 2,
    else the component replicates on BOTH axes (probe-verified: 4:2:0 /
    4:2:2 at image width <= 4 decode with replication in libjpeg, while
    the v-only h1v2 fancy has no such guard — 4:4:0 is exact at every
    width). Verified bit-exact against the installed libjpeg over all of
    these layouts incl. mismatched Cb/Cr (tests/test_jpeg_device.py).
    Returns int32 samples at (..., h*vr, w*hr).
    """
    if (hr, vr) == (1, 1):
        return plane.astype(jnp.int32)
    if hr == 2 and plane.shape[-1] <= 2:
        return _replicate(plane, hr, vr)
    if (hr, vr) == (2, 2):
        return fancy_upsample_h2v2(plane)
    if (hr, vr) == (2, 1):
        return fancy_upsample_h2v1(plane)
    if (hr, vr) == (1, 2):
        return fancy_upsample_h1v2(plane)
    return _replicate(plane, hr, vr)


def ycc_to_rgb(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray) -> jnp.ndarray:
    """Fixed-point YCbCr->RGB, bit-exact vs jdcolor.c build_ycc_rgb_table.

    y, cb, cr: (..., H, W) int32 samples in [0, 255]. Returns
    (..., H, W, 3) uint8 interleaved RGB. The table lookups are reproduced
    arithmetically; the sample range limit reduces to a plain clamp because
    y + tab always lands in the simple-table segment [-256, 511].
    """
    cbc = cb - 128
    crc = cr - 128
    r = y + ((_FIX_1_40200 * crc + _ONE_HALF) >> _SCALEBITS)
    b = y + ((_FIX_1_77200 * cbc + _ONE_HALF) >> _SCALEBITS)
    g = y + ((-_FIX_0_34414 * cbc + _ONE_HALF + -_FIX_0_71414 * crc)
             >> _SCALEBITS)
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(rgb, 0, 255).astype(jnp.uint8)


def _rgb_rows(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray) -> jnp.ndarray:
    """Color-convert one phase grid and interleave channels: (..., h, w*3)."""
    cbc = cb.astype(jnp.int32) - 128
    crc = cr.astype(jnp.int32) - 128
    y = y.astype(jnp.int32)
    r = y + ((_FIX_1_40200 * crc + _ONE_HALF) >> _SCALEBITS)
    b = y + ((_FIX_1_77200 * cbc + _ONE_HALF) >> _SCALEBITS)
    g = y + ((-_FIX_0_34414 * cbc + _ONE_HALF + -_FIX_0_71414 * crc)
             >> _SCALEBITS)
    rgb = jnp.stack([r, g, b], axis=-1)
    rgb = jnp.clip(rgb, 0, 255).astype(jnp.uint8)
    h, w = rgb.shape[-3], rgb.shape[-2]
    return rgb.reshape(*rgb.shape[:-3], h, w * 3)


def _interleave_col_phases(rgb_e: jnp.ndarray, rgb_o: jnp.ndarray):
    """Two column-phase rows arrays (..., h, w2*3) -> (..., h, 2*w2*3)."""
    w2 = rgb_e.shape[-1] // 3
    pair = jnp.stack(
        [rgb_e.reshape(*rgb_e.shape[:-1], w2, 3),
         rgb_o.reshape(*rgb_o.shape[:-1], w2, 3)],
        axis=-2,
    )  # (..., h, w2, 2, 3)
    return pair.reshape(*rgb_e.shape[:-1], w2 * 6)


def _cmyk_rows(comps: list, color: int) -> jnp.ndarray:
    """Four full-res sample grids -> interleaved CMYK rows (..., H, W*4).

    color == 5 (YCCK, Adobe transform 2): jdcolor.c ycck_cmyk_convert —
    the standard fixed-point YCC->RGB on components 0-2 with the result
    inverted (MAXJSAMPLE - x), K passed through untouched. color == 4
    (plain CMYK): null conversion — all four components pass through
    (samples are already range-limited by the IDCT).
    """
    if color == 5:
        # MAXJSAMPLE - range_limit(ycc_rgb(...)): the inversion wraps the
        # exact fixed-point converter the YCbCr path uses (ycc_to_rgb).
        rgb = ycc_to_rgb(comps[0].astype(jnp.int32),
                         comps[1].astype(jnp.int32),
                         comps[2].astype(jnp.int32))
        out = jnp.concatenate(
            [255 - rgb.astype(jnp.int32),
             comps[3].astype(jnp.int32)[..., None]], axis=-1)
    else:
        out = jnp.stack([c.astype(jnp.int32) for c in comps], axis=-1)
    out = out.astype(jnp.uint8)
    h, w = out.shape[-3], out.shape[-2]
    return out.reshape(*out.shape[:-3], h, w * 4)


def _decode_rgb_rows_from_planes(
    geo: DecodeGeometry,
    y_planes: list, cb_planes: list, cr_planes: list,
) -> jnp.ndarray:
    """Sample-position planes -> interleaved-rows RGB, fully phase-fused.

    The performance core of the device decode. Instead of assembling the
    full-resolution Y plane and materializing full-resolution int32 chroma
    (the naive jdsample/jdcolor port — measured 3x the cost of the IDCT
    itself), this works phase by phase at subsampled resolution:

    - Y *phase grids* (even/odd rows x even/odd cols) are assembled
      directly from the 64 IDCT position planes by parity subsetting —
      pure stack+reshape, no strided re-slicing of an assembled plane.
    - Chroma upsampling computes each output phase at chroma resolution in
      int16 (column sums <= 4*255), algebraically identical to
      h2v2/h2v1_fancy_upsample (jdsample.c) including edge replication.
    - Color conversion runs per phase; a single interleave emits the
      framework's canonical rows layout (..., H, W*3).
    """
    hgt, wid = geo.height, geo.width
    _, _, ywb, yhb = geo.comps[0]
    _, _, cwb, chb = geo.comps[1]
    hr = geo.max_h // geo.comps[1][0]
    vr = geo.max_v // geo.comps[1][1]
    _, dw_c = _downsampled_dims(geo, 1)
    if (geo.comps[1][:2] != geo.comps[2][:2]
            or (hr, vr) not in ((1, 1), (2, 1), (2, 2), (1, 2))
            or (hr == 2 and dw_c <= 2)):
        # Exotic layouts (4:1:1 / 4:1:0 / 3:1:1 replication ratios,
        # mismatched Cb/Cr) and narrow chroma planes (jdsample.c uses
        # replication, not the fancy filters, when downsampled_width <= 2
        # and the horizontal ratio is 2): per-component upsample at full
        # resolution — the straightforward jdsample/jdcolor formulation.
        # Rare streams, so correctness path, not phase-fused.
        y = _grid_from_planes(y_planes, yhb, ywb,
                              range(8), range(8))[..., :hgt, :wid]
        chroma = []
        for planes, ci in ((cb_planes, 1), (cr_planes, 2)):
            h_samp, v_samp, wb_i, hb_i = geo.comps[ci]
            dh_i, dw_i = _downsampled_dims(geo, ci)
            g = _grid_from_planes(planes, hb_i, wb_i,
                                  range(8), range(8))[..., :dh_i, :dw_i]
            up = upsample_component(
                g, geo.max_h // h_samp, geo.max_v // v_samp)
            chroma.append(up[..., :hgt, :wid])
        return _rgb_rows(y.astype(jnp.int32), chroma[0], chroma[1])
    dh, dw = _downsampled_dims(geo, 1)
    cb = _grid_from_planes(cb_planes, chb, cwb,
                           range(8), range(8))[..., :dh, :dw].astype(jnp.int16)
    cr = _grid_from_planes(cr_planes, chb, cwb,
                           range(8), range(8))[..., :dh, :dw].astype(jnp.int16)

    def col_phases(cs):
        left = _clamp_cols(cs, -1)
        right = _clamp_cols(cs, 1)
        if vr == 2:  # h2v2: >> 4 with biases 8/7 (jdsample.c)
            return (3 * cs + left + 8) >> 4, (3 * cs + right + 7) >> 4
        return (3 * cs + left + 1) >> 2, (3 * cs + right + 2) >> 2

    def y_phase(pr, pc):
        rs = range(pr, 8, 2) if pr is not None else range(8)
        cs_ = range(pc, 8, 2) if pc is not None else range(8)
        return _grid_from_planes(y_planes, yhb, ywb, rs, cs_)[..., :dh, :dw]

    if (hr, vr) == (2, 2):
        rows_out = []
        for p, voff in ((0, -1), (1, 1)):
            cs_cb = 3 * cb + _clamp_rows(cb, voff)
            cs_cr = 3 * cr + _clamp_rows(cr, voff)
            cb_e, cb_o = col_phases(cs_cb)
            cr_e, cr_o = col_phases(cs_cr)
            rgb_e = _rgb_rows(y_phase(p, 0), cb_e, cr_e)
            rgb_o = _rgb_rows(y_phase(p, 1), cb_o, cr_o)
            rows_out.append(_interleave_col_phases(rgb_e, rgb_o))
        full = jnp.stack(rows_out, axis=-2)  # (..., dh, 2, 2*dw*3)
        full = full.reshape(*full.shape[:-3], dh * 2, full.shape[-1])
    elif (hr, vr) == (2, 1):
        cb_e, cb_o = col_phases(cb)
        cr_e, cr_o = col_phases(cr)
        rgb_e = _rgb_rows(y_phase(None, 0), cb_e, cr_e)
        rgb_o = _rgb_rows(y_phase(None, 1), cb_o, cr_o)
        full = _interleave_col_phases(rgb_e, rgb_o)
    elif (hr, vr) == (1, 2):
        # 4:4:0 (h1v2): vertical-only fancy upsample — two row phases at
        # chroma resolution, no column phases (fancy_upsample_h1v2
        # semantics, row biases 1/2).
        rows_out = []
        for p, voff, bias in ((0, -1, 1), (1, 1, 2)):
            cbp = (3 * cb + _clamp_rows(cb, voff) + bias) >> 2
            crp = (3 * cr + _clamp_rows(cr, voff) + bias) >> 2
            rows_out.append(_rgb_rows(y_phase(p, None), cbp, crp))
        full = jnp.stack(rows_out, axis=-2)  # (..., dh, 2, dw*3)
        full = full.reshape(*full.shape[:-3], dh * 2, full.shape[-1])
    else:  # (1, 1)
        y = _grid_from_planes(y_planes, yhb, ywb,
                              range(8), range(8))[..., :hgt, :wid]
        full = _rgb_rows(y, cb, cr)
    return full[..., :hgt, : wid * 3]


class DecodeGeometry(NamedTuple):
    """Static shape/subsampling info for one jit specialization."""

    width: int
    height: int
    ncomps: int
    # Per component: (h_samp, v_samp, width_in_blocks, height_in_blocks).
    comps: tuple[tuple[int, int, int, int], ...]
    max_h: int
    max_v: int
    # Coded color space for 4-component streams (libjpeg J_COLOR_SPACE:
    # 4=CMYK passthrough, 5=YCCK -> CMYK transform). 1/3-component
    # geometries always carry the default so existing cache keys,
    # equality checks and hand-built geometries are unchanged.
    color: int = 3


def geometry_of(co) -> DecodeGeometry:
    """DecodeGeometry from an io_.jpeg.JpegCoefficients."""
    return DecodeGeometry(
        width=co.width,
        height=co.height,
        ncomps=co.num_components,
        comps=tuple(
            (c.h_samp, c.v_samp, c.coefs.shape[1], c.coefs.shape[0])
            for c in co.components
        ),
        max_h=co.max_h,
        max_v=co.max_v,
        color=(getattr(co, "color_space", 3)
               if co.num_components == 4 else 3),
    )


def _downsampled_dims(geo: DecodeGeometry, ci: int) -> tuple[int, int]:
    """Component's real sample dims (jdmaster.c downsampled_width/height)."""
    h_samp, v_samp, _, _ = geo.comps[ci]
    dw = -(-geo.width * h_samp // geo.max_h)
    dh = -(-geo.height * v_samp // geo.max_v)
    return dh, dw


def gray_geometry(geo: DecodeGeometry) -> DecodeGeometry:
    """1-component (luma-only) view of a color stream's geometry.

    Models libjpeg's out_color_space=JCS_GRAYSCALE decode of a YCbCr
    stream: chroma components are never IDCT'd (jdmaster marks them not
    component_needed) and jdcolor's grayscale conversion copies the
    range-limited Y samples — i.e. exactly the 1-component decode graph
    on component 0. Valid only for full-resolution-luma streams
    (comps[0] at max sampling, the same constraint the color device
    path's fast formulation has); callers gate on that.
    """
    h_samp, v_samp, wb, hb = geo.comps[0]
    assert (h_samp, v_samp) == (geo.max_h, geo.max_v), geo.comps
    return DecodeGeometry(width=geo.width, height=geo.height, ncomps=1,
                          comps=((h_samp, v_samp, wb, hb),),
                          max_h=h_samp, max_v=v_samp)


def supported(geo: DecodeGeometry) -> bool:
    """True if this geometry decodes on device (else fall back to host).

    Covers every sampling layout libjpeg itself decodes with luma at
    full resolution: grayscale; 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0 via the
    fancy upsamplers; 4:1:1 / 4:1:0 / 3:1:1 and any other integer ratio
    via replication (int_upsample); mismatched Cb/Cr factors via
    per-component upsampler selection. Only fractional ratios (libjpeg
    errors on those too, jdsample.c) and subsampled-luma streams take
    the host path.
    """
    if geo.ncomps == 1:
        return True
    if geo.ncomps == 4:
        # Adobe CMYK / YCCK: per-component upsample + elementwise color
        # transform — only integer ratios required (no luma-at-max
        # constraint; jdcolor's ycck/null converts are per-sample).
        if geo.color not in (4, 5):
            return False
        return not any(
            geo.max_h % h_samp or geo.max_v % v_samp
            for h_samp, v_samp, _, _ in geo.comps
        )
    if geo.ncomps != 3:
        return False
    y_h, y_v, _, _ = geo.comps[0]
    if (y_h, y_v) != (geo.max_h, geo.max_v):
        return False
    for ci in (1, 2):
        h_samp, v_samp, _, _ = geo.comps[ci]
        if geo.max_h % h_samp or geo.max_v % v_samp:
            return False
    return True


def scaled_sizes(geo: DecodeGeometry, scale_denom: int) -> tuple[int, ...]:
    """Per-component scaled DCT size at 1/scale_denom, as libjpeg picks it.

    Replicates jdmaster.c's selection (verified against the installed
    library via `io_.jpeg.scaled_info` in tests/test_jpeg_scaled.py): start
    at min_DCT_scaled_size = 8/denom, then double while the component's
    sampling ratio absorbs it — which is how 4:2:0 chroma lands at the same
    resolution as the scaled output (no upsampling), while 4:2:2/4:4:0
    chroma keeps a 2x upsample along one axis.
    """
    mins = {1: 8, 2: 4, 4: 2, 8: 1}[scale_denom]
    sizes = []
    for h_samp, v_samp, _, _ in geo.comps:
        ssize = mins
        while (ssize < 8
               and (geo.max_h * mins) % (h_samp * ssize * 2) == 0
               and (geo.max_v * mins) % (v_samp * ssize * 2) == 0):
            ssize *= 2
        sizes.append(ssize)
    return tuple(sizes)


def _scaled_down_dims(geo: DecodeGeometry, ci: int, ssize: int):
    """Component sample dims at a scaled decode (jdmaster.c downsampled_*)."""
    h_samp, v_samp, _, _ = geo.comps[ci]
    dw = -(-geo.width * h_samp * ssize // (geo.max_h * 8))
    dh = -(-geo.height * v_samp * ssize // (geo.max_v * 8))
    return dh, dw


def supported_scaled(geo: DecodeGeometry, scale_denom: int) -> bool:
    """True if a 1/scale_denom decode runs on device (else host fallback)."""
    if scale_denom == 1:
        return supported(geo)
    if scale_denom not in (2, 4, 8):
        return False
    if not supported(geo):
        return False
    sizes = scaled_sizes(geo, scale_denom)
    mins = {2: 4, 4: 2, 8: 1}[scale_denom]
    for ci in range(geo.ncomps):
        h_samp, v_samp, _, _ = geo.comps[ci]
        if (geo.max_h * mins) % (h_samp * sizes[ci]) or (
                geo.max_v * mins) % (v_samp * sizes[ci]):
            return False  # fractional scaled ratio: host path
    return True


def decode_planes_scaled(
    geo: DecodeGeometry,
    comp_coefs: list[jnp.ndarray],
    qtables: list[np.ndarray],
    scale_denom: int,
    layout: str = "hwc",
) -> jnp.ndarray:
    """Device decode at 1/scale_denom (2, 4 or 8): DCT-domain thumbnailing.

    Bit-exact vs libjpeg's scaled decode (``scale_num/scale_denom``,
    jdmaster.c + jidctred.c): each component runs the reduced ssize-point
    IDCT the library would pick, then chroma is fancy-upsampled *at the
    scaled resolution* where its ssize could not absorb the sampling ratio
    (4:2:2 / 4:4:0), exactly as jdsample.c does. A 1/8 thumbnail touches
    1/64th the samples of a full decode — the cheap path for thumbnail
    serving (`runtime/serve.py` decode_scale).

    comp_coefs[i]: (..., Hb_i, Wb_i, 64) int16 quantized coefficients.
    Returns (..., out_h, out_w, C) uint8 ("hwc") or (..., out_h, out_w*C)
    ("rows"), out_dim = ceil(dim / scale_denom).
    """
    if scale_denom == 1:
        return decode_planes(geo, comp_coefs, qtables, layout=layout)
    if not supported_scaled(geo, scale_denom):
        raise ValueError(
            f"unsupported scaled-decode geometry: {geo.comps} @1/{scale_denom}"
        )
    sizes = scaled_sizes(geo, scale_denom)
    out_h = -(-geo.height // scale_denom)
    out_w = -(-geo.width // scale_denom)
    grids = []
    for ci in range(geo.ncomps):
        ssize = sizes[ci]
        hb, wb = comp_coefs[ci].shape[-3], comp_coefs[ci].shape[-2]
        planes = _dequant_planes(comp_coefs[ci], qtables[ci])
        out = _idct_planes_reduced(planes, ssize)
        grid = _grid_from_planes(out, hb, wb, range(ssize), range(ssize))
        dh, dw = _scaled_down_dims(geo, ci, ssize)
        grids.append(grid[..., :dh, :dw])
    if geo.ncomps == 1:
        y = grids[0][..., :out_h, :out_w]
        return y if layout == "rows" else y[..., None]
    mins = {2: 4, 4: 2, 8: 1}[scale_denom]

    def up_scaled(ci: int) -> jnp.ndarray:
        """Upsample one component's scaled grid to the scaled output res.

        The installed library honors do_fancy_upsampling only when
        min_DCT_scaled_size (the luma ssize, = mins) is > 1: at 1/8 it
        replicates even a ratio-2 chroma axis. Probe-verified both ways
        — 4:2:2 at 1/4 needs fancy (chroma ssize 2, mins 2) while 4:1:0
        at 1/8 needs replication (chroma ssize 2, mins 1); the two rules
        are indistinguishable on standard layouts. Ratios beyond the
        fancy set (4:1:1-family) replicate at any ssize, as at full size.
        """
        h_samp, v_samp, _, _ = geo.comps[ci]
        hr = geo.max_h * mins // (h_samp * sizes[ci])
        vr = geo.max_v * mins // (v_samp * sizes[ci])
        g = grids[ci]
        # At mins == 1 the library replicates every ratio; otherwise
        # upsample_component applies the fancy/replication selection —
        # including the narrow-plane width guard, which at a scaled
        # decode acts on the SCALED downsampled width (g's own width).
        g = (_replicate(g, hr, vr) if mins == 1
             else upsample_component(g, hr, vr))
        return g[..., :out_h, :out_w]

    if geo.ncomps == 4:
        rows = _cmyk_rows([up_scaled(ci) for ci in range(4)], geo.color)
        if layout == "rows":
            return rows
        return rows.reshape(*rows.shape[:-1], out_w, 4)
    y = grids[0].astype(jnp.int32)
    chroma = [up_scaled(1), up_scaled(2)]
    rgb = ycc_to_rgb(y, chroma[0], chroma[1])
    if layout == "rows":
        return rgb.reshape(*rgb.shape[:-3], out_h, out_w * 3)
    return rgb


@functools.lru_cache(maxsize=64)
def _jitted_scaled_decoder(geo: DecodeGeometry, qkey: tuple, denom: int):
    qtables = [np.array(q, dtype=np.uint16) for q in qkey]

    @jax.jit
    def run(*comp_coefs):
        return decode_planes_scaled(geo, list(comp_coefs), qtables, denom)

    return run


def decode_coefficients_scaled(co, scale_denom: int, device=None) -> jax.Array:
    """Scaled device decode of an io_.jpeg.JpegCoefficients -> uint8 pixels."""
    geo = geometry_of(co)
    qkey = tuple(tuple(int(v) for v in c.qtable) for c in co.components)
    fn = _jitted_scaled_decoder(geo, qkey, scale_denom)
    coefs = [c.coefs for c in co.components]
    if device is not None:
        coefs = [jax.device_put(a, device) for a in coefs]
    return fn(*coefs)


def decode_planes(
    geo: DecodeGeometry,
    comp_coefs: list[jnp.ndarray],
    qtables: list[np.ndarray],
    layout: str = "hwc",
) -> jnp.ndarray:
    """Finish decoding on device: coefficients -> decoded uint8 pixels.

    comp_coefs[i]: (..., Hb_i, Wb_i, 64) int16 quantized coefficients.
    qtables[i]: (64,) uint16 host-side quant table for component i.
    Leading batch dims broadcast through every stage.

    layout: "hwc" -> (..., H, W, C); "rows" -> (..., H, W*C), the
    framework's canonical interleaved-rows device layout. The two are a
    free reshape of one another; on-device consumers take "rows".
    """
    if not supported(geo):
        raise ValueError(f"unsupported sampling geometry: {geo.comps}")
    if geo.ncomps == 1:
        y = idct8x8_islow(comp_coefs[0], qtables[0])
        y = y[..., : geo.height, : geo.width]
        return y if layout == "rows" else y[..., None]
    if geo.ncomps == 4:
        # Adobe CMYK / YCCK: rare streams, so correctness path — the
        # concatenated IDCT graph over all four components, then the
        # generic per-component upsample and the jdcolor transform
        # (_cmyk_rows).
        dqs = [_dequant_planes(comp_coefs[ci], qtables[ci])
               for ci in range(4)]
        ns = [comp_coefs[ci].shape[-3] * comp_coefs[ci].shape[-2]
              for ci in range(4)]
        cat = [jnp.concatenate([dqs[c][k] for c in range(4)], axis=-1)
               for k in range(64)]
        out = _idct_planes_core(cat)
        offs = [sum(ns[:i]) for i in range(5)]
        comps = []
        for ci in range(4):
            planes = [o[..., offs[ci]:offs[ci + 1]] for o in out]
            h_samp, v_samp, wb, hb = geo.comps[ci]
            dh, dw = _downsampled_dims(geo, ci)
            g = _grid_from_planes(planes, hb, wb,
                                  range(8), range(8))[..., :dh, :dw]
            up = upsample_component(
                g, geo.max_h // h_samp, geo.max_v // v_samp)
            comps.append(up[..., : geo.height, : geo.width])
        rows = _cmyk_rows(comps, geo.color)
        if layout == "rows":
            return rows
        return rows.reshape(*rows.shape[:-1], geo.width, 4)
    # All three components' IDCTs run as ONE unrolled plane graph: the
    # dequantized planes are concatenated along the flattened block-grid
    # (lane) axis, so the per-op shapes are 1.5x larger and the op count
    # is 1/3rd of three separate IDCTs.
    dqs = [
        _dequant_planes(comp_coefs[ci], qtables[ci]) for ci in range(3)
    ]
    ns = [
        comp_coefs[ci].shape[-3] * comp_coefs[ci].shape[-2]
        for ci in range(3)
    ]
    cat = [
        jnp.concatenate([dqs[0][k], dqs[1][k], dqs[2][k]], axis=-1)
        for k in range(64)
    ]
    out = _idct_planes_core(cat)
    y_planes = [o[..., : ns[0]] for o in out]
    cb_planes = [o[..., ns[0] : ns[0] + ns[1]] for o in out]
    cr_planes = [o[..., ns[0] + ns[1] :] for o in out]
    rows = _decode_rgb_rows_from_planes(geo, y_planes, cb_planes, cr_planes)
    if layout == "rows":
        return rows
    return rows.reshape(*rows.shape[:-1], geo.width, 3)


@functools.lru_cache(maxsize=64)
def _jitted_decoder(geo: DecodeGeometry, qkey: tuple):
    """Per-(geometry, quant tables) jitted device decoder."""
    qtables = [np.array(q, dtype=np.uint16) for q in qkey]

    @jax.jit
    def run(*comp_coefs):
        return decode_planes(geo, list(comp_coefs), qtables)

    return run


def decode_coefficients(co, device=None) -> jax.Array:
    """Decode an io_.jpeg.JpegCoefficients on device -> (H, W, C) uint8.

    The quant tables are folded into the compiled program as constants
    (they are per-encoder, shared across a stream); coefficient planes are
    the only host->device traffic.
    """
    geo = geometry_of(co)
    qkey = tuple(tuple(int(v) for v in c.qtable) for c in co.components)
    fn = _jitted_decoder(geo, qkey)
    coefs = [c.coefs for c in co.components]
    if device is not None:
        coefs = [jax.device_put(a, device) for a in coefs]
    return fn(*coefs)


def make_batch_decoder(geo: DecodeGeometry, qtables: list[np.ndarray]):
    """Jitted (B,...) batch decoder for a fixed geometry + quant tables.

    Returns fn(*comp_coefs) -> (B, H, W, C) uint8; use for device-resident
    coefficient streams (the decode analog of runtime/device_stream.py).
    """
    qkey = tuple(tuple(int(v) for v in np.asarray(q)) for q in qtables)
    return _jitted_decoder(geo, qkey)
