"""Device-side JPEG encode: color convert + downsample + fDCT + quantize.

The encode mirror of ops/jpeg_decode.py, completing the device-side codec
loop. The device computes everything numeric — fixed-point RGB->YCbCr
(jccolor.c rgb_ycc_convert tables), iMCU edge padding, chroma downsampling
(jcsample.c h2v2/h2v1_downsample with the alternating rounding bias),
forward islow DCT (jcfdctint.c, 13-bit fixed point) and the sign-aware
rounding quantizer (jcdct.c forward_DCT, divisors = quantval << 3) — and
the host does only the serial entropy encode (io_/jpeg.py
write_coefficients -> jpeg_write_coefficients, as jpegtran does).

For identical pixels/quality/subsampling the emitted file is
**byte-identical** to a direct libjpeg encode (asserted by
tests/test_jpeg_encode_device.py): the coefficients match libjpeg's exactly, and
the native writer reproduces the direct encoder's MCU dummy-block
semantics.

The reference keeps its encode on host via CImg save_jpeg
(`split_image_blur.c:40-56`); here a serving pipeline can
run decode -> filter -> encode with only entropy coding on the host.

Layout strategy matches the decoder: 64 block-position planes with the
flattened block grid in the minor axis; the two DCT passes are unrolled
elementwise graphs; plane extraction/assembly is stack/reshape only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from hipe_tpu.ops.jpeg_decode import (
    CONST_BITS,
    PASS1_BITS,
    DecodeGeometry,
    _descale,
    _F_0_298631336,
    _F_0_390180644,
    _F_0_541196100,
    _F_0_765366865,
    _F_0_899976223,
    _F_1_175875602,
    _F_1_501321110,
    _F_1_847759065,
    _F_1_961570560,
    _F_2_053119869,
    _F_2_562915447,
    _F_3_072711026,
    _fix,
    _ONE_HALF,
    _SCALEBITS,
)

# jccolor.c rgb_ycc tables.
_FIX_0_29900 = _fix(0.29900)
_FIX_0_58700 = _fix(0.58700)
_FIX_0_11400 = _fix(0.11400)
_FIX_0_16874 = _fix(0.16874)
_FIX_0_33126 = _fix(0.33126)
_FIX_0_50000 = _fix(0.50000)
_FIX_0_41869 = _fix(0.41869)
_FIX_0_08131 = _fix(0.08131)
_CBCR_OFFSET = 128 << _SCALEBITS


def rgb_to_ycc(rgb: jnp.ndarray) -> tuple[jnp.ndarray, ...]:
    """Fixed-point RGB->YCbCr, bit-exact vs jccolor.c rgb_ycc_convert.

    rgb: (..., H, W, 3) uint8. Returns three (..., H, W) int32 planes in
    [0, 255] (exact by construction, no clamp in the reference either).
    """
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    y = (_FIX_0_29900 * r + _FIX_0_58700 * g + _FIX_0_11400 * b
         + _ONE_HALF) >> _SCALEBITS
    cb = (-_FIX_0_16874 * r - _FIX_0_33126 * g + _FIX_0_50000 * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    cr = (_FIX_0_50000 * r - _FIX_0_41869 * g - _FIX_0_08131 * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    return y, cb, cr


def rgb_to_gray(rgb: jnp.ndarray) -> jnp.ndarray:
    """Fixed-point RGB->luma, bit-exact vs jccolor.c rgb_gray_convert.

    The Y channel of :func:`rgb_to_ycc` alone (libjpeg uses the same
    tables for both converters, so a grayscale encode of this plane is
    byte-identical to libjpeg's own RGB->grayscale encode — verified in
    tests/test_serve_device_encode.py). rgb: (..., H, W, 3) uint8;
    returns (..., H, W) int32 in [0, 255].
    """
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    return (_FIX_0_29900 * r + _FIX_0_58700 * g + _FIX_0_11400 * b
            + _ONE_HALF) >> _SCALEBITS


def _pad_edge(x: jnp.ndarray, rows: int, cols: int) -> jnp.ndarray:
    """Edge-replicate the trailing (h, w) dims up to (rows, cols).

    The compressor's iMCU-edge expansion (jcprepct.c expand_bottom_edge,
    jcsample.c expand_right_edge are both last-sample duplication).
    """
    dh, dw = rows - x.shape[-2], cols - x.shape[-1]
    if dh:
        x = jnp.concatenate(
            [x, jnp.broadcast_to(x[..., -1:, :], (*x.shape[:-2], dh,
                                                  x.shape[-1]))], axis=-2)
    if dw:
        x = jnp.concatenate(
            [x, jnp.broadcast_to(x[..., :, -1:], (*x.shape[:-1], dw))],
            axis=-1)
    return x


def _alternating_bias(w: int, even: int, odd: int) -> np.ndarray:
    """jcsample.c's per-output-column rounding bias as a broadcast vector.

    The bias depends only on output-column parity, so instead of parity
    phase-splitting (4 lane-strided gathers + a stack interleave, the
    round-1 formulation) it is a periodic constant added in place.
    """
    assert w % 2 == 0, w
    return np.tile(np.array([even, odd], dtype=np.int32), w // 2)


def downsample_h2v2(plane: jnp.ndarray) -> jnp.ndarray:
    """2x2 average, bit-exact vs jcsample.c h2v2_downsample.

    plane: (..., 2h, 2w) int32 with even dims. The rounding bias
    alternates 1, 2, 1, 2 by output column. One reshape-reduce for the
    2x2 sums + a broadcast bias vector — no strided parity gathers.
    """
    h2, w2 = plane.shape[-2] // 2, plane.shape[-1] // 2
    x = plane.reshape(*plane.shape[:-2], h2, 2, w2, 2)
    s = x.sum(axis=(-3, -1))
    return (s + _alternating_bias(w2, 1, 2)) >> 2


def downsample_h2v1(plane: jnp.ndarray) -> jnp.ndarray:
    """2x1 average, bit-exact vs jcsample.c h2v1_downsample (bias 0,1)."""
    w2 = plane.shape[-1] // 2
    s = plane.reshape(*plane.shape[:-1], w2, 2).sum(axis=-1)
    return (s + _alternating_bias(w2, 0, 1)) >> 1


def downsample_int(plane: jnp.ndarray, h_expand: int,
                   v_expand: int) -> jnp.ndarray:
    """Generic jcsample.c int_downsample: plain block average with a
    fixed ``+numpix/2`` bias and truncating division — libjpeg's method
    for every ratio without a specialized handler (4:1:1 h4v1, 4:1:0
    h4v2, 3:1:1 h3v1, mismatched-chroma layouts). Non-power-of-two
    divisors (3:1:1) use XLA integer division (non-negative operands,
    so trunc == floor)."""
    hh = plane.shape[-2] // v_expand
    ww = plane.shape[-1] // h_expand
    x = plane.reshape(*plane.shape[:-2], hh, v_expand, ww, h_expand)
    s = x.sum(axis=(-3, -1))
    numpix = h_expand * v_expand
    if numpix & (numpix - 1) == 0:
        return (s + (numpix >> 1)) >> numpix.bit_length() - 1
    return (s + numpix // 2) // numpix


def _fdct_1d(d: list[jnp.ndarray], final: bool) -> list[jnp.ndarray]:
    """One 8-point islow forward-DCT pass, bit-exact vs jcfdctint.c."""
    t0 = d[0] + d[7]
    t7 = d[0] - d[7]
    t1 = d[1] + d[6]
    t6 = d[1] - d[6]
    t2 = d[2] + d[5]
    t5 = d[2] - d[5]
    t3 = d[3] + d[4]
    t4 = d[3] - d[4]
    t10 = t0 + t3
    t13 = t0 - t3
    t11 = t1 + t2
    t12 = t1 - t2
    out = [None] * 8
    if not final:
        out[0] = (t10 + t11) << PASS1_BITS
        out[4] = (t10 - t11) << PASS1_BITS
        even_shift = CONST_BITS - PASS1_BITS
    else:
        out[0] = _descale(t10 + t11, PASS1_BITS)
        out[4] = _descale(t10 - t11, PASS1_BITS)
        even_shift = CONST_BITS + PASS1_BITS
    z1 = (t12 + t13) * _F_0_541196100
    out[2] = _descale(z1 + t13 * _F_0_765366865, even_shift)
    out[6] = _descale(z1 - t12 * _F_1_847759065, even_shift)
    z1 = t4 + t7
    z2 = t5 + t6
    z3 = t4 + t6
    z4 = t5 + t7
    z5 = (z3 + z4) * _F_1_175875602
    t4 = t4 * _F_0_298631336
    t5 = t5 * _F_2_053119869
    t6 = t6 * _F_3_072711026
    t7 = t7 * _F_1_501321110
    z1 = z1 * -_F_0_899976223
    z2 = z2 * -_F_2_562915447
    z3 = z3 * -_F_1_961570560 + z5
    z4 = z4 * -_F_0_390180644 + z5
    out[7] = _descale(t4 + z1 + z3, even_shift)
    out[5] = _descale(t5 + z2 + z4, even_shift)
    out[3] = _descale(t6 + z2 + z3, even_shift)
    out[1] = _descale(t7 + z1 + z4, even_shift)
    return out


def _planes_from_grid(grid: jnp.ndarray) -> tuple[list, int, int]:
    """(..., hb*8, wb*8) samples -> 64 position planes of (..., hb*wb).

    The inverse of jpeg_decode._grid_from_planes: reshape-split both pixel
    dims and slice out each (r, c) position; one relayout overall.
    """
    bshape = grid.shape[:-2]
    hb, wb = grid.shape[-2] // 8, grid.shape[-1] // 8
    x = grid.reshape(*bshape, hb, 8, wb, 8)
    planes = [
        x[..., :, r, :, c].reshape(*bshape, hb * wb)
        for r in range(8)
        for c in range(8)
    ]
    return planes, hb, wb


def _fdct_planes_core(planes: list) -> list:
    """64 level-shifted int32 planes -> 64 unquantized fDCT planes.

    Row pass (jcfdctint pass 1: walks columns within each row), then
    column pass — the mirror of jpeg_decode._idct_planes_core.
    """
    ws: list = [None] * 64
    for r in range(8):
        row = _fdct_1d([planes[r * 8 + c] for c in range(8)], final=False)
        for c in range(8):
            ws[r * 8 + c] = row[c]
    out: list = [None] * 64
    for c in range(8):
        col = _fdct_1d([ws[r * 8 + c] for r in range(8)], final=True)
        for r in range(8):
            out[r * 8 + c] = col[r]
    return out


def fdct_quantize(plane: jnp.ndarray, qtable: np.ndarray) -> jnp.ndarray:
    """Sample plane -> quantized DCT coefficients, bit-exact vs libjpeg.

    plane: (..., hb*8, wb*8) int32 samples in [0, 255] (block-multiple
    dims; caller pads). Returns (..., hb, wb, 64) int16 natural-order
    quantized coefficients — exactly what jpeg_read_coefficients would
    report for these pixels.
    """
    planes, hb, wb = _planes_from_grid(plane.astype(jnp.int32) - 128)
    out = _fdct_planes_core(planes)
    # Quantize: divisors = quantval << 3 (jcdct.c start_pass_fdctmgr),
    # sign-aware round-half-away division (forward_DCT).
    q = np.asarray(qtable, dtype=np.int64)
    coefs = []
    for k in range(64):
        qd = int(q[k]) << 3
        t = out[k]
        a = jnp.abs(t) + (qd >> 1)
        v = a // qd
        coefs.append(jnp.where(t < 0, -v, v).astype(jnp.int16))
    stacked = jnp.stack(coefs, axis=-1)  # (..., hb*wb, 64)
    return stacked.reshape(*stacked.shape[:-2], hb, wb, 64)


# Chroma layouts the DEVICE encoder implements. The four libjpeg-default
# layouts use the specialized jcsample downsamplers (alternating-bias
# h2v2/h2v1); every other integer ratio — the host codec's exotic
# test-surface names 4:1:1 / 4:1:0 / 3:1:1 and the mismatched-chroma
# "asym" — routes through the generic int_downsample reproduction
# (fixed +numpix/2 bias), exactly libjpeg's own method selection
# (jcsample.c start_pass_downsample). serve.py and cli.py gate
# encode_on_device against this, so adding a layout here enables it
# everywhere at once.
DEVICE_SUBSAMPLINGS = ("420", "444", "422", "440",
                       "411", "410", "311", "asym")
_SUBSAMP_FACTORS = {"420": (2, 2), "422": (2, 1), "444": (1, 1),
                    "440": (1, 2)}
# Per-component (h_samp, v_samp), mirroring io_.jpeg._SUB_FACTORS (the
# native codec's apply_subsamp table) — the single source the geometry
# derives from.
_SUBSAMP_COMPS = {
    "444": ((1, 1), (1, 1), (1, 1)),
    "420": ((2, 2), (1, 1), (1, 1)),
    "422": ((2, 1), (1, 1), (1, 1)),
    "440": ((1, 2), (1, 1), (1, 1)),
    "411": ((4, 1), (1, 1), (1, 1)),
    "410": ((4, 2), (1, 1), (1, 1)),
    "311": ((3, 1), (1, 1), (1, 1)),
    "asym": ((2, 2), (2, 1), (1, 1)),
}


def encode_geometry(height: int, width: int, channels: int,
                    subsampling: str = "420") -> DecodeGeometry:
    """Component geometry for an encode, matching jpeg_set_defaults."""
    if channels == 1:
        hb, wb = -(-height // 8), -(-width // 8)
        return DecodeGeometry(width=width, height=height, ncomps=1,
                              comps=((1, 1, wb, hb),), max_h=1, max_v=1)
    facs = _SUBSAMP_COMPS[subsampling]
    max_h = max(f[0] for f in facs)
    max_v = max(f[1] for f in facs)
    comps = []
    for h_i, v_i in facs:
        dw = -(-width * h_i // max_h)
        dh = -(-height * v_i // max_v)
        comps.append((h_i, v_i, -(-dw // 8), -(-dh // 8)))
    return DecodeGeometry(
        width=width, height=height, ncomps=3, comps=tuple(comps),
        max_h=max_h, max_v=max_v,
    )


def encode_planes(
    geo: DecodeGeometry,
    img: jnp.ndarray,
    qtables: list[np.ndarray],
) -> list[jnp.ndarray]:
    """Device encode: pixels -> per-component quantized coefficients.

    img: (..., H, W, C) uint8 (or (..., H, W) for grayscale). Returns
    [(..., Hb_i, Wb_i, 64) int16] matching libjpeg's own coefficients for
    the same pixels/quality/subsampling bit-for-bit.
    """
    hgt, wid = geo.height, geo.width
    if geo.ncomps == 1:
        # Accept (..., H, W) or (..., H, W, 1), disambiguated by the
        # trailing dims (H=W=1 degenerates identically either way).
        if img.shape[-2:] == (hgt, wid):
            y = img
        elif img.shape[-3:] == (hgt, wid, 1):
            y = img[..., 0]
        else:
            raise ValueError(f"bad grayscale shape {img.shape}")
        _, _, wb, hb = geo.comps[0]
        yp = _pad_edge(y.astype(jnp.int32), hb * 8, wb * 8)
        return [fdct_quantize(yp, qtables[0])]
    hs, vs = geo.max_h, geo.max_v
    y, cb, cr = rgb_to_ycc(img)
    _, _, ywb, yhb = geo.comps[0]
    # Edge-padding semantics of the direct encoder, reproduced exactly:
    # - horizontally, the downsampler's *input* is expanded to
    #   output_cols * h_expand per component (jcsample.c
    #   expand_right_edge — for the standard layouts that equals the
    #   luma iMCU width; mismatched-chroma layouts need the
    #   per-component width);
    # - vertically, full-res rows are expanded only to the conversion
    #   group (a multiple of v_samp); rows beyond that are replicated in
    #   the *downsampled* domain (jcprepct.c expand_bottom_edge on the
    #   downsampled output buffer). Padding full-res rows instead gives
    #   different chroma whenever the last real chroma row is a genuine
    #   vertical average.
    imcu_w = 8 * hs * -(-wid // (8 * hs))
    group_h = vs * -(-hgt // vs)
    y = _pad_edge(y, yhb * 8, imcu_w)
    outs = [
        fdct_quantize(y[..., :, : ywb * 8], qtables[0])
    ]
    for ci, plane in ((1, cb), (2, cr)):
        h_i, v_i, wb_i, hb_i = geo.comps[ci]
        h_e, v_e = hs // h_i, vs // v_i
        in_w = wb_i * 8 * h_e
        plane = _pad_edge(plane, group_h, in_w)[..., :, :in_w]
        # libjpeg's method selection (jcsample.c start_pass_downsample):
        # fullsize copy, the two alternating-bias specials, then the
        # generic fixed-bias int_downsample for everything else.
        if (h_e, v_e) == (2, 2):
            plane = downsample_h2v2(plane)
        elif (h_e, v_e) == (2, 1):
            plane = downsample_h2v1(plane)
        elif (h_e, v_e) != (1, 1):
            plane = downsample_int(plane, h_e, v_e)
        plane = _pad_edge(plane, hb_i * 8, wb_i * 8)
        outs.append(fdct_quantize(plane, qtables[ci]))
    return outs


@functools.lru_cache(maxsize=64)
def _jitted_encoder(geo: DecodeGeometry, qkey: tuple):
    qtables = [np.array(q, dtype=np.uint16) for q in qkey]

    @jax.jit
    def run(img):
        return tuple(encode_planes(geo, img, qtables))

    return run


def encode_bytes_device(
    img: np.ndarray,
    quality: int = 90,
    subsampling: str = "420",
    progressive: bool = False,
    device=None,
) -> bytes:
    """Full device-side encode of one HWC uint8 image -> JPEG bytes.

    Device: color/downsample/fDCT/quantize. Host: entropy encode. Output
    is byte-identical to io_.jpeg.encode_bytes_opts on the same inputs.
    """
    from hipe_tpu.io_ import jpeg as jio

    h, w = img.shape[:2]
    channels = img.shape[2] if img.ndim == 3 else 1
    geo = encode_geometry(h, w, channels, subsampling)
    luma, chroma = jio.quality_tables(quality)
    qtables = [luma] if channels == 1 else [luma, chroma, chroma]
    qkey = tuple(tuple(int(v) for v in q) for q in qtables)
    fn = _jitted_encoder(geo, qkey)
    x = img if channels == 3 else img.reshape(h, w)
    if device is not None:
        x = jax.device_put(x, device)
    coefs = [np.asarray(c) for c in fn(x)]
    return jio.write_coefficients(
        coefs, w, h, quality=quality, subsampling=subsampling,
        progressive=progressive,
    )
