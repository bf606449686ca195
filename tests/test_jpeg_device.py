"""Device-side JPEG decode: bit-exact vs the host libjpeg pipeline.

The device decode split (host entropy decode -> device dequant + IDCT +
upsample + color convert, ops/jpeg_decode.py) must reproduce libjpeg's
default integer decode byte-for-byte: jpeg_idct_islow (jidctint.c), fancy
upsampling (jdsample.c), ycc_rgb_convert (jdcolor.c). The reference decodes
entirely on host via CImg (heterogeneous_blur.c:106-137);
equivalence to that path is equivalence to libjpeg itself.
"""

import numpy as np
import pytest

from hipe_tpu.io_ import jpeg
from hipe_tpu.ops import jpeg_decode as jd

if not jpeg.native_available():  # pragma: no cover
    pytest.skip("native libjpeg codec unavailable", allow_module_level=True)


def _roundtrip_exact(img, **enc):
    data = jpeg.encode_bytes_opts(img, **enc)
    host = jpeg.decode_bytes(data)
    co = jpeg.read_coefficients(data)
    dev = np.asarray(jd.decode_coefficients(co))
    np.testing.assert_array_equal(host, dev)
    return co


def _rand(h, w, c, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, c), dtype=np.uint8
    )


def test_asset_bit_exact():
    # Seeded photo-like stand-ins at the reference assets' geometries.
    from hipe_tpu.utils.images import REFERENCE_256, REFERENCE_320, seeded_image

    for size in (REFERENCE_256, REFERENCE_320):
        data = jpeg.encode_bytes(seeded_image(*size, seed=size[0]),
                                 quality=90)
        host = jpeg.decode_bytes(data)
        dev = np.asarray(jd.decode_coefficients(jpeg.read_coefficients(data)))
        np.testing.assert_array_equal(host, dev)


def test_h2v2_odd_dims():
    # Odd dims exercise MCU padding, crop, and upsample edge replication.
    _roundtrip_exact(_rand(33, 17, 3), quality=75, subsampling="420")


def test_h2v1_and_h1v1():
    _roundtrip_exact(_rand(32, 24, 3, seed=1), quality=85, subsampling="422")
    _roundtrip_exact(_rand(31, 25, 3, seed=2), quality=90, subsampling="444")


def test_h1v2_440():
    # 4:4:0 (vertical-only subsampling): turbo's h1v2_fancy_upsample on
    # decode. Odd height exercises the replicated bottom chroma row.
    co = _roundtrip_exact(_rand(32, 24, 3, seed=4), quality=85,
                          subsampling="440")
    assert [(c.h_samp, c.v_samp) for c in co.components] == \
        [(1, 2), (1, 1), (1, 1)]
    _roundtrip_exact(_rand(33, 17, 3, seed=5), quality=90,
                     subsampling="440")


def test_grayscale():
    _roundtrip_exact(_rand(40, 56, 1, seed=3), quality=80)


def test_progressive():
    # jpeg_read_coefficients completes multi-scan streams; the device half
    # is scan-agnostic, so progressive decodes identically.
    co = _roundtrip_exact(
        _rand(48, 36, 3, seed=4), quality=70, subsampling="420",
        progressive=True,
    )
    assert co.progressive


def test_low_quality_heavy_quant():
    # Low quality -> large quant values -> the widest IDCT dynamic range.
    _roundtrip_exact(_rand(24, 24, 3, seed=5), quality=10, subsampling="420")


def test_batch_decoder_matches_singles():
    imgs = [_rand(16, 24, 3, seed=s) for s in range(4)]
    datas = [
        jpeg.encode_bytes_opts(im, quality=75, subsampling="420")
        for im in imgs
    ]
    cos = [jpeg.read_coefficients(d) for d in datas]
    geo = jd.geometry_of(cos[0])
    fn = jd.make_batch_decoder(geo, [c.qtable for c in cos[0].components])
    batched = [
        np.stack([co.components[ci].coefs for co in cos])
        for ci in range(3)
    ]
    out = np.asarray(fn(*batched))
    assert out.shape == (4, 16, 24, 3)
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(out[i], jpeg.decode_bytes(d))


@pytest.mark.parametrize("subs", ["411", "410", "311", "asym"])
def test_exotic_samplings_bit_exact(subs):
    # Replication-upsampled layouts (4:1:1 / 4:1:0 / 3:1:1) and mismatched
    # Cb/Cr factors ("asym": Cb h2v1, Cr h1v1 — each component gets a
    # different upsampler) take the generic per-component device path
    # (upsample_component); libjpeg decodes all of these (jdsample.c
    # int_upsample + per-component selection). Odd dims exercise MCU
    # padding and the replicated edge samples.
    co = _roundtrip_exact(_rand(33, 41, 3, seed=6), quality=85,
                          subsampling=subs)
    assert jd.supported(jd.geometry_of(co))
    _roundtrip_exact(_rand(32, 48, 3, seed=7), quality=70, subsampling=subs)


@pytest.mark.parametrize("subs,w", [("420", 4), ("420", 1), ("422", 3),
                                    ("asym", 4)])
def test_narrow_images_use_replication(subs, w):
    # jdsample.c guards the horizontal-ratio-2 fancy upsamplers with
    # downsampled_width > 2 — narrow chroma planes replicate instead.
    # These widths decoded with errors up to 72 before the guard was
    # replicated on device (probe-verified across w=1..16).
    _roundtrip_exact(_rand(16, w, 3, seed=8), quality=85, subsampling=subs)
    _roundtrip_exact(_rand(3, w, 3, seed=9), quality=85, subsampling=subs)


def test_unsupported_geometry_detected():
    # Subsampled luma (Y not at max sampling factor): host path.
    geo = jd.DecodeGeometry(
        width=16, height=16, ncomps=3,
        comps=((1, 1, 2, 2), (2, 1, 4, 2), (1, 1, 2, 2)),
        max_h=2, max_v=1,
    )
    assert not jd.supported(geo)
    with pytest.raises(ValueError):
        jd.decode_planes(
            geo,
            [np.zeros((2, 4, 64), np.int16)] * 3,
            [np.ones(64, np.uint16)] * 3,
        )
    # Fractional chroma ratio (max 3, chroma 2): libjpeg itself errors on
    # these (jdsample.c "Fractional sampling not implemented"); host path.
    frac = jd.DecodeGeometry(
        width=16, height=16, ncomps=3,
        comps=((3, 1, 6, 2), (2, 1, 4, 2), (2, 1, 4, 2)),
        max_h=3, max_v=1,
    )
    assert not jd.supported(frac)


def test_phase_fused_decode_matches_generic_pipeline():
    # The production decode path (concatenated-IDCT + phase-fused
    # upsample/color, no full-res Y assembly) must agree on every pixel
    # with the independent generic pipeline built from the literal ports:
    # idct8x8_islow + fancy_upsample_h2v2/h2v1 + ycc_to_rgb.
    rng = np.random.default_rng(11)
    for (hgt, wid), (hs, vs) in (
        ((13, 21), (2, 2)), ((16, 24), (2, 2)),
        ((13, 21), (2, 1)), ((9, 7), (1, 1)),
    ):
        dh = -(-hgt // vs)
        dw = -(-wid // hs)
        yhb, ywb = -(-hgt // 8), -(-wid // 8)
        chb, cwb = -(-dh // 8), -(-dw // 8)
        geo = jd.DecodeGeometry(
            width=wid, height=hgt, ncomps=3,
            comps=((hs, vs, ywb, yhb), (1, 1, cwb, chb), (1, 1, cwb, chb)),
            max_h=hs, max_v=vs,
        )
        coefs = [
            rng.integers(-256, 256, (2, hb, wb, 64), dtype=np.int16)
            for hb, wb in ((yhb, ywb), (chb, cwb), (chb, cwb))
        ]
        qts = [np.full(64, 3, np.uint16), np.full(64, 5, np.uint16),
               np.full(64, 5, np.uint16)]
        got = np.asarray(jd.decode_planes(geo, coefs, qts))
        y = np.asarray(jd.idct8x8_islow(coefs[0], qts[0]))[..., :hgt, :wid]
        ups = {
            (2, 2): jd.fancy_upsample_h2v2,
            (2, 1): jd.fancy_upsample_h2v1,
            (1, 1): lambda p: p.astype(np.int32),
        }[(hs, vs)]
        cbp = np.asarray(jd.idct8x8_islow(coefs[1], qts[1]))[..., :dh, :dw]
        crp = np.asarray(jd.idct8x8_islow(coefs[2], qts[2]))[..., :dh, :dw]
        want = np.asarray(jd.ycc_to_rgb(
            np.asarray(y, np.int32),
            np.asarray(ups(cbp))[..., :hgt, :wid],
            np.asarray(ups(crp))[..., :hgt, :wid],
        ))
        np.testing.assert_array_equal(got, want, err_msg=f"{(hs, vs)}")


def test_range_limit_matches_table():
    # The arithmetic range limit must equal libjpeg's wrap-around table
    # (jdmaster.c prepare_range_limit_table) over the full index space.
    table = np.zeros(1024, dtype=np.int32)
    table[0:128] = np.arange(128) + 128
    table[128:512] = 255
    table[512:896] = 0
    table[896:1024] = np.arange(128)
    vals = np.arange(-2048, 2048, dtype=np.int32)
    got = np.asarray(jd._range_limit(vals))
    np.testing.assert_array_equal(got, table[vals & 1023])


def test_arithmetic_and_restart_streams_device_exact():
    # Entropy coding is entirely the host's half of the split; arithmetic
    # (SOF9) and restart-marker streams deliver the same quantized
    # coefficients, so the device graph must be bit-exact on them too.
    img = _rand(33, 29, 3, seed=31)
    for kw in ({"arithmetic": True}, {"restart_interval": 2},
               {"arithmetic": True, "restart_interval": 1}):
        _roundtrip_exact(img, quality=85, subsampling="420", **kw)
    _roundtrip_exact(_rand(16, 24, 3, seed=32), quality=90,
                     subsampling="444", arithmetic=True, progressive=True)
