"""Serving pipeline with device-side JPEG encode (and full transcode).

encode_on_device fuses filter + color/downsample/fDCT/quantize in one
jitted program (ops/jpeg_encode.py); with decode_on_device too the whole
numeric transcode runs on device, coefficients in -> coefficients out.
Every path must emit bytes identical to the host-codec ServingPipeline
(reference data path: `split_image_blur.c:106-139,548-553`).
"""

import numpy as np
import pytest

from hipe_tpu.io_ import jpeg
from hipe_tpu.runtime.serve import ServingPipeline

if not jpeg.native_available():  # pragma: no cover
    pytest.skip("native libjpeg codec unavailable", allow_module_level=True)


def _payloads(n=4, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return [
        jpeg.encode_bytes(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 90
        )
        for _ in range(n)
    ]


def test_encode_on_device_matches_host_bytes():
    payloads = _payloads()
    ref = ServingPipeline("blur3", use_pallas=False).process_batch(payloads)
    got = ServingPipeline(
        "blur3", use_pallas=False, encode_on_device=True
    ).process_batch(payloads)
    assert got == ref


def test_full_device_transcode_matches_host_bytes():
    payloads = _payloads(seed=1)
    ref = ServingPipeline("chain", use_pallas=False).process_batch(payloads)
    sp = ServingPipeline("chain", use_pallas=False,
                         decode_on_device=True, encode_on_device=True)
    assert sp.process_batch(payloads) == ref
    # Device work happened on both halves; host decode path untouched.
    assert sp.stats.device_ms > 0 and sp.stats.encode_ms > 0


def test_streaming_run_fused_transcode():
    payloads = _payloads(n=6, seed=2)
    ref = ServingPipeline("blur3", use_pallas=False).process_batch(payloads)
    sp = ServingPipeline("blur3", use_pallas=False,
                         decode_on_device=True, encode_on_device=True)
    out = [b for batch in sp.run([payloads[:3], payloads[3:]])
           for b in batch]
    assert out == ref
    assert sp.stats.images == 6


def test_encode_false_still_returns_pixels():
    payloads = _payloads(n=2, seed=3)
    sp = ServingPipeline("blur3", use_pallas=False,
                         decode_on_device=True, encode_on_device=True)
    px = sp.process_batch(payloads, encode=False)
    ref = ServingPipeline("blur3", use_pallas=False).process_batch(
        payloads, encode=False
    )
    np.testing.assert_array_equal(px, ref)


def test_mixed_quality_stream_groups_and_matches():
    # Two quant-table groups in one batch: grouping must keep order and
    # each file must match the host codec exactly.
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
            for _ in range(4)]
    payloads = [jpeg.encode_bytes(im, q)
                for im, q in zip(imgs, (90, 70, 90, 70))]
    ref = ServingPipeline("blur3", use_pallas=False).process_batch(payloads)
    got = ServingPipeline(
        "blur3", use_pallas=False,
        decode_on_device=True, encode_on_device=True,
    ).process_batch(payloads)
    assert got == ref


def test_mixed_resolution_transcode_and_clear_pixel_error():
    # Mixed geometries in ONE batch: the transcode path returns per-image
    # bytes; the pixel-return path raises a clear error (not numpy's
    # shape complaint).
    rng = np.random.default_rng(6)
    a = jpeg.encode_bytes(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), 90)
    b = jpeg.encode_bytes(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), 90)
    sp = ServingPipeline("blur3", use_pallas=False,
                         decode_on_device=True, encode_on_device=True)
    outs = sp.process_batch([a, b, a])
    # The host codec path needs uniform batches — reference per image.
    host = ServingPipeline("blur3", use_pallas=False)
    ref = [host.process_batch([p])[0] for p in (a, b, a)]
    assert outs == ref
    sp2 = ServingPipeline("blur3", use_pallas=False, decode_on_device=True)
    with pytest.raises(ValueError, match="mixed-resolution"):
        sp2.process_batch([a, b], encode=False)


def _downscale_oracle(px):
    """jcsample-exact 2x2 average per channel, edge-replicated odd dims."""
    import jax.numpy as jnp

    from hipe_tpu.ops import jpeg_encode as je

    b, h, w, c = px.shape
    img = jnp.moveaxis(jnp.asarray(px, jnp.int32), -1, 1)
    img = je._pad_edge(img, 2 * -(-h // 2), 2 * -(-w // 2))
    small = je.downsample_h2v2(img)
    return np.asarray(jnp.moveaxis(small, 1, -1)).astype(np.uint8)


@pytest.mark.parametrize("dims", [(32, 48), (33, 47)])
def test_output_scale_thumbnail_all_placements(dims):
    """output_scale=2: filter -> exact h2v2 average -> encode at half size,
    identical bytes across host/device codec placements."""
    h, w = dims
    rng = np.random.default_rng(11)
    payloads = [
        jpeg.encode_bytes(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 90
        )
        for _ in range(2)
    ]
    full = ServingPipeline("blur3", use_pallas=False).process_batch(
        payloads, encode=False
    )
    small = _downscale_oracle(full)
    assert small.shape[1:3] == (-(-h // 2), -(-w // 2))
    want = [jpeg.encode_bytes_opts(im, quality=90, subsampling="420")
            for im in small]

    for kwargs in (
        {},
        {"encode_on_device": True},
        {"decode_on_device": True, "encode_on_device": True},
    ):
        sp = ServingPipeline("blur3", use_pallas=False, output_scale=2,
                             **kwargs)
        got = sp.process_batch(payloads)
        assert got == want, kwargs
    # pixel return path
    px = ServingPipeline("blur3", use_pallas=False, output_scale=2,
                         decode_on_device=True).process_batch(
        payloads, encode=False)
    np.testing.assert_array_equal(px, small)


@pytest.mark.parametrize("sub", ["444", "440"])
def test_encode_subsampling_honored_on_all_paths(sub):
    """Host-encode, device-encode, and full-transcode paths all emit the
    requested subsampling (the host path silently fell back to 4:2:0
    before round 3) and byte-identical files."""
    payloads = _payloads(n=2, seed=4)
    expect = {"444": [(1, 1)] * 3, "440": [(1, 2), (1, 1), (1, 1)]}[sub]

    host = ServingPipeline("blur3", use_pallas=False,
                           encode_subsampling=sub).process_batch(payloads)
    dev = ServingPipeline("blur3", use_pallas=False, encode_on_device=True,
                          encode_subsampling=sub).process_batch(payloads)
    tr = ServingPipeline("blur3", use_pallas=False, decode_on_device=True,
                         encode_on_device=True,
                         encode_subsampling=sub).process_batch(payloads)
    assert host == dev == tr
    co = jpeg.read_coefficients(host[0])
    assert [(c.h_samp, c.v_samp) for c in co.components] == expect


def test_exotic_encode_subsampling_everywhere():
    """Exotic layouts ("411" etc.) encode on host AND device (the generic
    int_downsample reproduction); an unknown layout name is still a clear
    upfront error, not a deep KeyError."""
    payloads = _payloads(n=1, seed=5)
    out = ServingPipeline("blur3", use_pallas=False,
                          encode_subsampling="411").process_batch(payloads)
    co = jpeg.read_coefficients(out[0])
    assert [(c.h_samp, c.v_samp) for c in co.components] == \
        [(4, 1), (1, 1), (1, 1)]
    # ...and the device decoder reads the exotic file right back.
    import hipe_tpu.ops.jpeg_decode as jd
    np.testing.assert_array_equal(
        np.asarray(jd.decode_coefficients(co)), jpeg.decode_bytes(out[0]))
    # Device encode of the same layout: byte-identical to the host path.
    got = ServingPipeline("blur3", use_pallas=False, encode_on_device=True,
                          encode_subsampling="411").process_batch(payloads)
    assert got == out
    with pytest.raises(ValueError, match="encode_on_device"):
        ServingPipeline("blur3", encode_on_device=True,
                        encode_subsampling="421")


def test_encode_optimize_all_placements():
    # Optimal per-image Huffman tables: smaller files, identical
    # coefficients, byte-identical across every codec placement.
    payloads = _payloads(n=2, seed=10)
    ref = ServingPipeline("blur3", use_pallas=False,
                          encode_optimize=True).process_batch(payloads)
    for kwargs in ({"encode_on_device": True},
                   {"decode_on_device": True, "encode_on_device": True}):
        sp = ServingPipeline("blur3", use_pallas=False, encode_optimize=True,
                             **kwargs)
        assert sp.process_batch(payloads) == ref, kwargs
    plain = ServingPipeline("blur3", use_pallas=False).process_batch(payloads)
    for o, p in zip(ref, plain):
        assert len(o) < len(p)
        np.testing.assert_array_equal(jpeg.decode_bytes(o),
                                      jpeg.decode_bytes(p))


def test_encode_arithmetic_and_restart_all_placements():
    # Output entropy options live in the host entropy layer, so every
    # encode placement (host, device-encode, full device transcode) must
    # emit identical bytes: arithmetic-coded (SOF9) / restart-marker
    # streams that decode to the same pixels as the Huffman output.
    payloads = _payloads(n=3, seed=9)
    kw = dict(encode_arithmetic=True, encode_restart_interval=2)
    ref = ServingPipeline("blur3", use_pallas=False, **kw).process_batch(
        payloads)
    assert all(b"\xff\xc9" in f and b"\xff\xd0" in f for f in ref)
    dev_enc = ServingPipeline("blur3", use_pallas=False,
                              encode_on_device=True, **kw)
    full = ServingPipeline("blur3", use_pallas=False, decode_on_device=True,
                           encode_on_device=True, **kw)
    assert dev_enc.process_batch(payloads) == ref
    assert full.process_batch(payloads) == ref
    huff = ServingPipeline("blur3", use_pallas=False).process_batch(payloads)
    for a, hf in zip(ref, huff):
        assert len(a) < len(hf)  # arithmetic coding strictly smaller here
        np.testing.assert_array_equal(jpeg.decode_bytes(a),
                                      jpeg.decode_bytes(hf))


def test_encode_progressive_all_placements():
    # Progressive emission (jpeg_simple_progression, cjpeg -progressive)
    # is a host entropy-layer option: every encode placement emits
    # byte-identical progressive streams with the same pixels as the
    # sequential output.
    payloads = _payloads(n=2, seed=11)
    ref = ServingPipeline("blur3", use_pallas=False,
                          encode_progressive=True).process_batch(payloads)
    assert all(jpeg.read_coefficients(f).progressive for f in ref)
    for kwargs in ({"encode_on_device": True},
                   {"decode_on_device": True, "encode_on_device": True}):
        sp = ServingPipeline("blur3", use_pallas=False,
                             encode_progressive=True, **kwargs)
        assert sp.process_batch(payloads) == ref, kwargs
    seq = ServingPipeline("blur3", use_pallas=False).process_batch(payloads)
    for p, s in zip(ref, seq):
        np.testing.assert_array_equal(jpeg.decode_bytes(p),
                                      jpeg.decode_bytes(s))
    # Composes with arithmetic coding: progressive arithmetic frames (SOFA).
    pa = ServingPipeline(
        "blur3", use_pallas=False, encode_progressive=True,
        encode_arithmetic=True, encode_on_device=True,
    ).process_batch(payloads)
    assert all(b"\xff\xca" in f for f in pa)
    for f, s in zip(pa, seq):
        np.testing.assert_array_equal(jpeg.decode_bytes(f),
                                      jpeg.decode_bytes(s))


@pytest.mark.parametrize("dims,target", [((48, 64), (20, 31)),
                                         ((41, 53), (64, 80))])
def test_resize_to_all_placements(dims, target):
    """resize_to=(H, W): filter -> integer-exact bilinear (ops/resize.py)
    -> encode at the target size, identical bytes across every codec
    placement, down- and up-scaling, odd input dims included."""
    from hipe_tpu.ops.resize import resize_bilinear

    h, w = dims
    rng = np.random.default_rng(13)
    payloads = [
        jpeg.encode_bytes(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 90
        )
        for _ in range(2)
    ]
    full = ServingPipeline("blur3", use_pallas=False).process_batch(
        payloads, encode=False
    )
    small = np.asarray(resize_bilinear(np.asarray(full), *target))
    assert small.shape[1:3] == target
    want = [jpeg.encode_bytes_opts(im, quality=90, subsampling="420")
            for im in small]

    for kwargs in (
        {},
        {"encode_on_device": True},
        {"decode_on_device": True, "encode_on_device": True},
    ):
        sp = ServingPipeline("blur3", use_pallas=False, resize_to=target,
                             **kwargs)
        assert sp.process_batch(payloads) == want, kwargs
    px = ServingPipeline("blur3", use_pallas=False, resize_to=target,
                         decode_on_device=True).process_batch(
        payloads, encode=False)
    np.testing.assert_array_equal(px, small)


def test_resize_to_composes_with_decode_scale():
    # decode_scale sets the filter resolution; resize_to sets the output
    # size from there. The oracle composes the scaled host decode, the
    # XLA filter, and the standalone resize op.
    from hipe_tpu.models import pipelines as plib
    from hipe_tpu.ops.resize import resize_bilinear

    rng = np.random.default_rng(14)
    payloads = [jpeg.encode_bytes(
        rng.integers(0, 256, (64, 96, 3), dtype=np.uint8), 90)]
    scaled = np.stack([jpeg.decode_bytes_scaled(p, 1, 4) for p in payloads])
    filtered = np.asarray(plib.get("blur3")(scaled))
    want_px = np.asarray(resize_bilinear(filtered, 10, 10))
    want = [jpeg.encode_bytes_opts(im, quality=90, subsampling="420")
            for im in want_px]
    for kwargs in ({}, {"decode_on_device": True, "encode_on_device": True}):
        sp = ServingPipeline("blur3", use_pallas=False, decode_scale=4,
                             resize_to=(10, 10), **kwargs)
        assert sp.process_batch(payloads) == want, kwargs


def test_resize_to_validation():
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingPipeline("blur3", output_scale=2, resize_to=(10, 10))
    with pytest.raises(ValueError, match="positive ints"):
        ServingPipeline("blur3", resize_to=(0, 10))


def test_gray_output_all_placements():
    """gray_output: filter -> jccolor rgb_gray luma on device -> grayscale
    encode, byte-identical to libjpeg's own RGB->grayscale encode of the
    filtered pixels on every codec placement; composes with resize_to."""
    payloads = _payloads(n=2, h=33, w=41, seed=21)
    full = ServingPipeline("blur3", use_pallas=False).process_batch(
        payloads, encode=False)
    want = [jpeg.encode_bytes_opts(im, quality=90, gray_from_rgb=True)
            for im in np.asarray(full)]
    for kwargs in (
        {},
        {"encode_on_device": True},
        {"decode_on_device": True, "encode_on_device": True},
    ):
        sp = ServingPipeline("blur3", use_pallas=False, gray_output=True,
                             **kwargs)
        assert sp.process_batch(payloads) == want, kwargs
    # pixel-return path: (B, H, W, 1) luma, matching the decoded gray files
    px = ServingPipeline("blur3", use_pallas=False, gray_output=True,
                         decode_on_device=True).process_batch(
        payloads, encode=False)
    assert px.shape[-1] == 1
    # the returned pixels are exactly the device-computed luma plane
    from hipe_tpu.ops.jpeg_encode import rgb_to_gray
    import jax.numpy as jnp

    luma = np.asarray(rgb_to_gray(jnp.asarray(np.asarray(full)))
                      ).astype(np.uint8)[..., None]
    np.testing.assert_array_equal(np.asarray(px), luma)
    # composes with resize_to
    from hipe_tpu.ops.resize import resize_bilinear

    small = np.asarray(resize_bilinear(np.asarray(full), 12, 17))
    want_rs = [jpeg.encode_bytes_opts(im, quality=90, gray_from_rgb=True)
               for im in small]
    sp = ServingPipeline("blur3", use_pallas=False, gray_output=True,
                         resize_to=(12, 17), decode_on_device=True,
                         encode_on_device=True)
    assert sp.process_batch(payloads) == want_rs


def test_gray_output_passthrough_on_gray_inputs():
    # 1-channel inputs are already luma: gray_output must be a no-op and
    # the output identical to the plain pipeline's.
    rng = np.random.default_rng(23)
    payloads = [jpeg.encode_bytes_opts(
        rng.integers(0, 256, (24, 24, 1), dtype=np.uint8), quality=90)]
    ref = ServingPipeline("blur3", use_pallas=False).process_batch(payloads)
    got = ServingPipeline("blur3", use_pallas=False,
                          gray_output=True).process_batch(payloads)
    assert got == ref


def test_decode_gray_all_placements():
    """decode_gray: the whole pipeline runs on the libjpeg JCS_GRAYSCALE
    decode (Y-only IDCT). Every placement must equal the oracle: host
    gray decode -> 1-channel filter -> grayscale encode."""
    payloads = _payloads(n=3, h=41, w=29, seed=25)
    gray_px = np.stack([
        jpeg.decode_bytes(p, force_gray=True) for p in payloads])
    from hipe_tpu.models import pipelines as plib

    filtered = np.asarray(plib.get("chain")(gray_px))
    want = [jpeg.encode_bytes_opts(im, quality=90) for im in filtered]
    for kwargs in (
        {},
        {"encode_on_device": True},
        {"decode_on_device": True},
        {"decode_on_device": True, "encode_on_device": True},
    ):
        sp = ServingPipeline("chain", use_pallas=False, decode_gray=True,
                             **kwargs)
        assert sp.process_batch(payloads) == want, kwargs
    px = ServingPipeline("chain", use_pallas=False, decode_gray=True,
                         decode_on_device=True).process_batch(
        payloads, encode=False)
    np.testing.assert_array_equal(np.asarray(px), filtered)


def test_decode_gray_composes_with_decode_scale():
    # Scaled gray decode: jdmaster's scaled-size selection for gray
    # output matches the 1-component selection (probe-verified); every
    # placement equals the host scaled-gray oracle.
    from hipe_tpu.models import pipelines as plib

    payloads = _payloads(n=2, h=35, w=51, seed=29)
    for den in (2, 8):
        gray_px = np.stack([
            jpeg.decode_bytes_scaled(p, 1, den, force_gray=True)
            for p in payloads])
        filtered = np.asarray(plib.get("blur3")(gray_px))
        want = [jpeg.encode_bytes_opts(im, quality=90) for im in filtered]
        for kwargs in ({}, {"decode_on_device": True,
                            "encode_on_device": True}):
            sp = ServingPipeline("blur3", use_pallas=False,
                                 decode_gray=True, decode_scale=den,
                                 **kwargs)
            assert sp.process_batch(payloads) == want, (den, kwargs)


def test_decode_gray_validation_and_exotic_fallback():
    # 4:1:0 (full-res luma) reduces to the device gray graph; the payload
    # mix with a gray stream shares the 1-component jit specialization.
    rng = np.random.default_rng(27)
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    p_color = jpeg.encode_bytes_opts(img, quality=85, subsampling="410")
    p_gray = jpeg.encode_bytes_opts(
        rng.integers(0, 256, (16, 24, 1), dtype=np.uint8), quality=85)
    sp = ServingPipeline("blur3", use_pallas=False, decode_gray=True,
                         decode_on_device=True, encode_on_device=True)
    got = sp.process_batch([p_color, p_gray])
    from hipe_tpu.models import pipelines as plib

    for g, p in zip(got, [p_color, p_gray]):
        want_px = np.asarray(plib.get("blur3")(
            jpeg.decode_bytes(p, force_gray=True)[None]))[0]
        assert g == jpeg.encode_bytes_opts(want_px, quality=90)
