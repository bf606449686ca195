"""Native JPEG codec: decode parity with PIL, roundtrip, batched decode."""

import numpy as np
import pytest

from hipe_tpu.io_ import jpeg
from hipe_tpu.utils.images import REFERENCE_256, REFERENCE_320, seeded_image

# Seeded stand-ins for the reference's two JPEG assets (same geometry).
SIZES = {"256x256": REFERENCE_256, "320x240": REFERENCE_320}


def _asset(name: str, quality: int = 90) -> bytes:
    return jpeg.encode_bytes(seeded_image(*SIZES[name], seed=len(name)),
                             quality=quality)


def test_native_codec_builds():
    assert jpeg.native_available(), "native libjpeg codec failed to build"


@pytest.mark.parametrize("name", sorted(SIZES))
def test_decode_matches_pil(name):
    data = _asset(name)
    got = jpeg.decode_bytes(data)
    want = jpeg._pil_decode(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    # libjpeg versions may differ in IDCT rounding by at most 1 count
    assert np.max(np.abs(got.astype(int) - want.astype(int))) <= 1


def test_encode_decode_roundtrip_close():
    rng = np.random.default_rng(0)
    # Smooth image so JPEG loss is small
    base = rng.integers(100, 140, size=(64, 64, 3)).astype(np.uint8)
    data = jpeg.encode_bytes(base, quality=95)
    out = jpeg.decode_bytes(data)
    assert out.shape == base.shape
    assert np.mean(np.abs(out.astype(int) - base.astype(int))) < 10


def test_decode_batch_matches_single():
    data = _asset("256x256")
    single = jpeg.decode_bytes(data)
    batch = jpeg.decode_batch([data] * 7, num_threads=4)
    assert batch.shape == (7,) + single.shape
    for i in range(7):
        np.testing.assert_array_equal(batch[i], single)


def test_decode_invalid_raises():
    with pytest.raises(ValueError):
        jpeg.decode_bytes(b"not a jpeg at all")


def test_decode_truncated_and_corrupted_payloads():
    """Native codec error paths: no crash, clean ValueError (setjmp path)."""
    good = _asset("256x256")
    rng = np.random.default_rng(0)
    cases = [
        good[: len(good) // 3],            # truncated body
        good[:2],                          # just the SOI marker
        b"\xff\xd8" + bytes(rng.integers(0, 256, 500, dtype=np.uint8)),
        good[:200] + bytes(50) + good[260:],  # corrupted header region
    ]
    for i, payload in enumerate(cases):
        try:
            out = jpeg.decode_bytes(payload)
            # libjpeg tolerates some damage by emitting partial scans —
            # acceptable as long as shape/dtype are sane
            assert out.dtype == np.uint8 and out.ndim == 3, i
        except ValueError:
            pass  # clean failure is the expected path


def test_decode_batch_with_one_bad_payload_raises():
    good = _asset("256x256")
    with pytest.raises(ValueError):
        jpeg.decode_batch([good, b"junk-not-a-jpeg", good])


def test_file_io_dispatches_on_format(tmp_path):
    """decode_file/encode_file handle non-JPEG formats via PIL — the
    extension-dispatch behavior of the reference's CImg load()/save()
    (BMP/PNM are native there; load is content-sniffed here so a
    mislabeled .jpg still decodes)."""
    img = np.random.default_rng(3).integers(
        0, 256, (24, 32, 3), dtype=np.uint8
    )
    for ext in ("bmp", "png", "ppm"):
        p = str(tmp_path / f"t.{ext}")
        jpeg.encode_file(img, p)
        np.testing.assert_array_equal(jpeg.decode_file(p), img)  # lossless
    # JPEG path still the native codec (bit-identical to decode_bytes).
    pj = str(tmp_path / "t.jpg")
    jpeg.encode_file(img, pj, quality=90)
    with open(pj, "rb") as f:
        np.testing.assert_array_equal(
            jpeg.decode_file(pj), jpeg.decode_bytes(f.read())
        )
    # Content sniffing: JPEG bytes under a .png name decode natively.
    mislabeled = str(tmp_path / "fake.png")
    with open(pj, "rb") as fsrc, open(mislabeled, "wb") as fdst:
        fdst.write(fsrc.read())
    np.testing.assert_array_equal(
        jpeg.decode_file(mislabeled), jpeg.decode_file(pj)
    )


def test_arithmetic_and_restart_entropy_codings():
    # Arithmetic coding (SOF9 streams) and restart markers change only the
    # entropy layer: pixels and quantized coefficients must match the
    # Huffman baseline bit-for-bit (jdarith.c vs jdhuff.c feed the same
    # IDCT). The reference's CImg/libjpeg loader accepts both stream kinds.
    from hipe_tpu.io_ import jpeg

    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (37, 51, 3), dtype=np.uint8)
    base = jpeg.encode_bytes_opts(img, quality=85, subsampling="420")
    ari = jpeg.encode_bytes_opts(img, quality=85, subsampling="420",
                                 arithmetic=True)
    rst = jpeg.encode_bytes_opts(img, quality=85, subsampling="420",
                                 restart_interval=2)
    assert b"\xff\xc9" in ari        # SOF9: arithmetic sequential
    assert b"\xff\xc9" not in base
    assert b"\xff\xd0" in rst        # RST0 marker present
    ref = jpeg.decode_bytes(base)
    np.testing.assert_array_equal(ref, jpeg.decode_bytes(ari))
    np.testing.assert_array_equal(ref, jpeg.decode_bytes(rst))
    cb = jpeg.read_coefficients(base)
    for variant in (ari, rst):
        cv = jpeg.read_coefficients(variant)
        for x, y in zip(cb.components, cv.components):
            np.testing.assert_array_equal(x.coefs, y.coefs)


def test_write_coefficients_arithmetic_byte_identical():
    # jpegtran-style recompression: coefficients read from a Huffman
    # stream, written back with arithmetic=True, must byte-equal a direct
    # arithmetic encode of the same pixels (identical coefficients =>
    # identical deterministic entropy encode). Same for restart markers,
    # and for the batched pthread writer.
    from hipe_tpu.io_ import jpeg

    rng = np.random.default_rng(22)
    img = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    co = jpeg.read_coefficients(
        jpeg.encode_bytes_opts(img, quality=80, subsampling="420"))
    coefs = [c.coefs for c in co.components]
    for kw in ({"arithmetic": True}, {"restart_interval": 3},
               {"arithmetic": True, "restart_interval": 1}):
        direct = jpeg.encode_bytes_opts(img, quality=80, subsampling="420",
                                        **kw)
        rewritten = jpeg.write_coefficients(coefs, 40, 24, quality=80,
                                            subsampling="420", **kw)
        assert rewritten == direct
        batched = jpeg.write_coefficients_batch(
            [c.coefs[None] for c in co.components], 40, 24, quality=80,
            subsampling="420", **kw)
        assert batched == [direct]


def test_optimize_huffman_entropy_coding():
    # optimize_coding: per-image optimal Huffman tables — smaller files,
    # identical pixels/coefficients, and coefficient rewrites byte-equal
    # direct optimized encodes (single and batched writers).
    from hipe_tpu.io_ import jpeg

    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, (29, 43, 3), dtype=np.uint8)
    base = jpeg.encode_bytes_opts(img, quality=85)
    opt = jpeg.encode_bytes_opts(img, quality=85, optimize=True)
    assert len(opt) < len(base)
    np.testing.assert_array_equal(jpeg.decode_bytes(base),
                                  jpeg.decode_bytes(opt))
    co = jpeg.read_coefficients(base)
    coefs = [c.coefs for c in co.components]
    assert jpeg.write_coefficients(coefs, 43, 29, quality=85,
                                   optimize=True) == opt
    assert jpeg.write_coefficients_batch(
        [c.coefs[None] for c in co.components], 43, 29, quality=85,
        optimize=True) == [opt]
