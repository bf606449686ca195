"""DCT-domain scaled (thumbnail) decode: bit-exact vs libjpeg scaled decode.

The device path (ops/jpeg_decode.decode_planes_scaled) reproduces libjpeg's
``scale_num/scale_denom`` decode for 1/2, 1/4 and 1/8: per-component reduced
IDCTs (jidctred.c jpeg_idct_4x4/2x2/1x1), the jdmaster.c scaled-DCT-size
selection (4:2:0 chroma absorbs its sampling ratio by IDCT upscaling; 4:2:2 /
4:4:0 chroma keeps a fancy upsample at scaled resolution; at ssize==1 the
upsample degrades to replication), and the standard color conversion. The
oracle is the installed libjpeg itself (`io_.jpeg.decode_bytes_scaled`); the
geometry decisions are cross-checked against the library's own
`jpeg_calc_output_dimensions` via the `scaled_info` probe.

Reference parity note: the reference decodes full-size only (CImg load_jpeg,
heterogeneous_blur.c:106-137); scaled decode is a
beyond-parity extension for thumbnail serving.
"""

import numpy as np
import pytest

from hipe_tpu.io_ import jpeg
from hipe_tpu.ops import jpeg_decode as jd

if not jpeg.native_available():  # pragma: no cover
    pytest.skip("native libjpeg codec unavailable", allow_module_level=True)


def _rand(h, w, c, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, c), dtype=np.uint8
    )


def _exact(data: bytes, denom: int):
    ref = jpeg.decode_bytes_scaled(data, 1, denom)
    co = jpeg.read_coefficients(data)
    got = np.asarray(jd.decode_coefficients_scaled(co, denom))
    np.testing.assert_array_equal(got, ref)


def test_scaled_sizes_match_library_probe():
    """Our jdmaster.c replication == the installed library's decisions."""
    img = _rand(97, 123, 3)
    for subs in ("420", "422", "444", "440"):
        data = jpeg.encode_bytes_opts(img, quality=85, subsampling=subs)
        geo = jd.geometry_of(jpeg.read_coefficients(data))
        for den in (1, 2, 4, 8):
            (ow, oh), comps = jpeg.scaled_info(data, 1, den)
            assert (ow, oh) == (-(-geo.width // den), -(-geo.height // den))
            sizes = jd.scaled_sizes(geo, den)
            assert sizes == tuple(c[0] for c in comps), (subs, den)
            for ci, (_, dw, dh) in enumerate(comps):
                assert jd._scaled_down_dims(geo, ci, sizes[ci]) == (dh, dw)


@pytest.mark.parametrize(
    "subs", ["420", "422", "444", "440", "411", "410", "311", "asym"])
@pytest.mark.parametrize("denom", [2, 4, 8])
def test_scaled_decode_bit_exact(subs, denom):
    # Odd dims exercise MCU padding, the ceil'd scaled output dims, and the
    # upsample/replication edge columns at scaled resolution.
    data = jpeg.encode_bytes_opts(_rand(33, 41, 3, seed=denom), quality=85,
                                  subsampling=subs)
    _exact(data, denom)


def test_scaled_decode_narrow_chroma_replicates():
    # The jdsample.c downsampled_width > 2 guard acts on the SCALED
    # chroma width at a scaled decode: 4:2:2 at width 16 has full-size
    # chroma width 8 (fancy) but 1/4-scale chroma width 2 (replication).
    # Decoded with err 9 before the guard was applied at scaled widths.
    for subs, w in (("422", 16), ("420", 12)):
        data = jpeg.encode_bytes_opts(_rand(24, w, 3, seed=15), quality=85,
                                      subsampling=subs)
        for den in (2, 4):
            _exact(data, den)


def test_scaled_decode_even_dims_and_quality():
    for q in (60, 95):
        data = jpeg.encode_bytes_opts(_rand(64, 64, 3, seed=q), quality=q,
                                      subsampling="420")
        for den in (2, 4, 8):
            _exact(data, den)


def test_scaled_decode_grayscale():
    data = jpeg.encode_bytes(_rand(49, 57, 1, seed=7), quality=90)
    for den in (2, 4, 8):
        _exact(data, den)


def test_scaled_decode_progressive():
    data = jpeg.encode_bytes_opts(_rand(40, 48, 3, seed=9), quality=85,
                                  subsampling="420", progressive=True)
    for den in (2, 4, 8):
        _exact(data, den)


def test_scaled_batch_leading_dims():
    """decode_planes_scaled broadcasts leading batch dims like the full path."""
    imgs = [_rand(32, 40, 3, seed=10 + i) for i in range(3)]
    datas = [jpeg.encode_bytes_opts(im, quality=85, subsampling="420")
             for im in imgs]
    cos = [jpeg.read_coefficients(d) for d in datas]
    geo = jd.geometry_of(cos[0])
    qts = [np.array(c.qtable, np.uint16) for c in cos[0].components]
    batched = [
        np.stack([co.components[ci].coefs for co in cos])
        for ci in range(3)
    ]
    out = np.asarray(jd.decode_planes_scaled(geo, batched, qts, 2))
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(out[i], jpeg.decode_bytes_scaled(d, 1, 2))


def test_scale_denom_1_is_full_decode():
    data = jpeg.encode_bytes_opts(_rand(24, 24, 3, seed=11), quality=85,
                                  subsampling="420")
    co = jpeg.read_coefficients(data)
    got = np.asarray(jd.decode_coefficients_scaled(co, 1))
    np.testing.assert_array_equal(got, jpeg.decode_bytes(data))


def test_supported_scaled_gating():
    data = jpeg.encode_bytes_opts(_rand(32, 32, 3, seed=12), quality=85,
                                  subsampling="420")
    geo = jd.geometry_of(jpeg.read_coefficients(data))
    assert jd.supported_scaled(geo, 2)
    assert not jd.supported_scaled(geo, 3)   # non-power-of-2: host path
    assert not jd.supported_scaled(geo, 16)
    # 4:1:1 decodes on device at any scale (replication upsample), like
    # at full size.
    data411 = jpeg.encode_bytes_opts(_rand(32, 32, 3, seed=12), quality=85,
                                     subsampling="411")
    geo411 = jd.geometry_of(jpeg.read_coefficients(data411))
    assert jd.supported_scaled(geo411, 2)
    # Subsampled luma stays host-fallback at scale, as at full size.
    geo_suby = geo._replace(
        comps=(
            (1, 1, geo.comps[0][2], geo.comps[0][3]),
            (2, 2, geo.comps[1][2], geo.comps[1][3]),
            (2, 2, geo.comps[2][2], geo.comps[2][3]),
        ),
        max_h=2, max_v=2,
    )
    assert not jd.supported_scaled(geo_suby, 2)


def test_host_scaled_api():
    img = _rand(50, 70, 3, seed=13)
    data = jpeg.encode_bytes(img, quality=90)
    full = jpeg.decode_bytes(data)
    np.testing.assert_array_equal(jpeg.decode_bytes_scaled(data, 8, 8), full)
    h, w, c = jpeg.scaled_dims(data, 1, 4)
    assert (h, w, c) == (13, 18, 3)
    up = jpeg.decode_bytes_scaled(data, 2, 1)  # library also upscales
    assert up.shape == (100, 140, 3)
