"""ServingPipeline decode_scale: DCT-domain thumbnail serving end to end.

decode_scale=2/4/8 enters the pipeline at ceil(dim/N) via libjpeg's scaled
decode semantics — on the host codec (decode_batch_scaled) or on device
(ops/jpeg_decode.decode_planes_scaled, reduced IDCTs) — so the filter and
encode run on 1/4 - 1/64th of the samples. All codec placements must agree
bit-for-bit with the reference composition: libjpeg scaled decode ->
filter -> (optional 2x average) -> encode.

Beyond-parity extension (the reference decodes full-size only,
`heterogeneous_blur.c:106-137`).
"""

import numpy as np
import pytest

from hipe_tpu.io_ import jpeg
from hipe_tpu.models import pipelines as plib
from hipe_tpu.runtime.serve import ServingPipeline

if not jpeg.native_available():  # pragma: no cover
    pytest.skip("native libjpeg codec unavailable", allow_module_level=True)


def _payloads(n=3, h=48, w=64, seed=0, quality=90):
    rng = np.random.default_rng(seed)
    return [
        jpeg.encode_bytes(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8), quality
        )
        for _ in range(n)
    ]


def _scaled_filter_oracle(payloads, denom, pipeline="blur3"):
    """Reference composition: libjpeg scaled decode -> XLA filter."""
    import jax.numpy as jnp

    batch = np.stack([jpeg.decode_bytes_scaled(p, 1, denom)
                      for p in payloads])
    pipe = plib.get(pipeline)
    b, h, w, c = batch.shape
    rows = pipe.apply_rows(jnp.asarray(batch.reshape(b, h, w * c)), c,
                           use_pallas=False)
    return np.asarray(rows).reshape(b, h, w, c)


def test_decode_batch_scaled_matches_singles():
    payloads = _payloads(n=4, h=33, w=41, seed=1)
    got = jpeg.decode_batch_scaled(payloads, 1, 4)
    want = np.stack([jpeg.decode_bytes_scaled(p, 1, 4) for p in payloads])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("denom", [2, 8])
def test_decode_scale_host_path_pixels(denom):
    payloads = _payloads(seed=denom)
    px = ServingPipeline("blur3", use_pallas=False,
                         decode_scale=denom).process_batch(
        payloads, encode=False)
    np.testing.assert_array_equal(px, _scaled_filter_oracle(payloads, denom))


@pytest.mark.parametrize("denom", [2, 8])
def test_decode_scale_device_path_matches_host(denom):
    # Odd dims: the scaled out dims are ceil'd and the fused program's
    # static shapes must agree with the host codec's.
    payloads = _payloads(h=33, w=47, seed=10 + denom)
    host = ServingPipeline("blur3", use_pallas=False,
                           decode_scale=denom).process_batch(
        payloads, encode=False)
    dev = ServingPipeline("blur3", use_pallas=False, decode_scale=denom,
                          decode_on_device=True).process_batch(
        payloads, encode=False)
    np.testing.assert_array_equal(dev, host)


def test_decode_scale_full_transcode_bytes():
    payloads = _payloads(seed=3)
    ref = ServingPipeline("chain", use_pallas=False,
                          decode_scale=4).process_batch(payloads)
    got = ServingPipeline("chain", use_pallas=False, decode_scale=4,
                          decode_on_device=True,
                          encode_on_device=True).process_batch(payloads)
    assert got == ref
    # And the bytes really are quarter-size thumbnails of the filtered image.
    im = jpeg.decode_bytes(got[0])
    assert im.shape[:2] == (12, 16)


def test_decode_scale_composes_with_output_scale():
    payloads = _payloads(h=50, w=70, seed=4)
    sp = ServingPipeline("blur3", use_pallas=False, decode_scale=2,
                         output_scale=2, decode_on_device=True)
    px = sp.process_batch(payloads, encode=False)
    # 50x70 -> scaled decode 25x35 -> filter -> 2x average -> 13x18
    assert px.shape[1:3] == (13, 18)


def test_decode_scale_streaming_run():
    payloads = _payloads(n=6, seed=5)
    ref = ServingPipeline("blur3", use_pallas=False,
                          decode_scale=2).process_batch(payloads)
    sp = ServingPipeline("blur3", use_pallas=False, decode_scale=2,
                         decode_on_device=True)
    out = [b for batch in sp.run([payloads[:3], payloads[3:]])
           for b in batch]
    assert out == ref
    assert sp.stats.images == 6


def test_decode_scale_validation():
    with pytest.raises(ValueError, match="decode_scale"):
        ServingPipeline("blur3", decode_scale=3)
