"""4-component (Adobe CMYK / YCCK) JPEG streams: host + device decode.

The reference loads JPEGs through CImg -> libjpeg, which decodes whatever
the library decodes — including 4-component Adobe CMYK (transform 0) and
YCCK (transform 2) streams (CImg/CImg.h load_jpeg switches
on cinfo.output_components). Parity here: the host codec decodes them to
4-channel CMYK samples exactly as libjpeg emits them, and the device
decode split reproduces that byte-for-byte (jdcolor.c ycck_cmyk_convert /
null conversion on top of the shared dequant/IDCT/upsample stages), at
full size and at DCT-domain 1/2-1/8 scales. Serving stays a 1/3-channel
contract and rejects CMYK payloads with a clear error.
"""

import numpy as np
import pytest

from hipe_tpu.io_ import jpeg
from hipe_tpu.ops import jpeg_decode as jd

if not jpeg.native_available():  # pragma: no cover
    pytest.skip("native libjpeg codec unavailable", allow_module_level=True)


def _rand4(h, w, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, 4), dtype=np.uint8
    )


def _device_exact(data: bytes):
    host = jpeg.decode_bytes(data)
    co = jpeg.read_coefficients(data)
    dev = np.asarray(jd.decode_coefficients(co))
    np.testing.assert_array_equal(host, dev)
    return co, host


@pytest.mark.parametrize("ycck", [False, True])
def test_host_roundtrip_and_classification(ycck):
    img = _rand4(32, 40, seed=1)
    data = jpeg.encode_cmyk_bytes(img, quality=95, ycck=ycck)
    out = jpeg.decode_bytes(data)
    assert out.shape == (32, 40, 4)
    co = jpeg.read_coefficients(data)
    # libjpeg classifies via the Adobe APP14 marker: 4=CMYK, 5=YCCK.
    assert co.color_space == (5 if ycck else 4)
    if ycck:
        # jpeg_set_colorspace(JCS_YCCK) subsamples the chroma pair and
        # keeps K at full resolution — the sampling mix that exercises
        # the per-component upsample in the device path.
        assert [(c.h_samp, c.v_samp) for c in co.components] == \
            [(2, 2), (1, 1), (1, 1), (2, 2)]
    else:
        assert all((c.h_samp, c.v_samp) == (1, 1) for c in co.components)


@pytest.mark.parametrize("ycck", [False, True])
@pytest.mark.parametrize("dims", [(33, 41), (32, 48)])
def test_device_decode_bit_exact(ycck, dims):
    h, w = dims
    data = jpeg.encode_cmyk_bytes(_rand4(h, w, seed=h), quality=85,
                                  ycck=ycck)
    co, _ = _device_exact(data)
    assert jd.supported(jd.geometry_of(co))


def test_device_decode_progressive():
    data = jpeg.encode_cmyk_bytes(_rand4(40, 36, seed=3), quality=70,
                                  ycck=True, progressive=True)
    co, _ = _device_exact(data)
    assert co.progressive


@pytest.mark.parametrize("ycck", [False, True])
@pytest.mark.parametrize("denom", [2, 4, 8])
def test_scaled_device_decode_bit_exact(ycck, denom):
    data = jpeg.encode_cmyk_bytes(_rand4(33, 41, seed=denom), quality=85,
                                  ycck=ycck)
    co = jpeg.read_coefficients(data)
    assert jd.supported_scaled(jd.geometry_of(co), denom)
    ref = jpeg.decode_bytes_scaled(data, 1, denom)
    got = np.asarray(jd.decode_coefficients_scaled(co, denom))
    np.testing.assert_array_equal(got, ref)


def test_batch_reader_carries_color_space():
    datas = [
        jpeg.encode_cmyk_bytes(_rand4(16, 24, seed=s), quality=80,
                               ycck=bool(s % 2))
        for s in range(4)
    ]
    cos = jpeg.read_coefficients_batch(datas)
    assert [c.color_space for c in cos] == [4, 5, 4, 5]
    # Geometry/decoder work from the batch reader's output too.
    for co, data in zip(cos, datas):
        dev = np.asarray(jd.decode_coefficients(co))
        np.testing.assert_array_equal(dev, jpeg.decode_bytes(data))


def test_unclassified_four_component_geometry_unsupported():
    # A 4-component geometry without a CMYK/YCCK classification (color
    # left at the YCbCr default) must not claim device support.
    geo = jd.DecodeGeometry(
        width=16, height=16, ncomps=4,
        comps=((1, 1, 2, 2),) * 4, max_h=1, max_v=1,
    )
    assert not jd.supported(geo)


def test_serving_rejects_cmyk_payloads():
    from hipe_tpu.runtime.serve import ServingPipeline

    data = jpeg.encode_cmyk_bytes(_rand4(24, 24, seed=9), quality=85)
    for kwargs in ({}, {"decode_on_device": True}):
        sp = ServingPipeline("blur3", use_pallas=False, **kwargs)
        with pytest.raises(ValueError, match="CMYK"):
            sp.process_batch([data])
