"""Contrast — PIL ImageEnhance.Contrast bit-exact (the third
global-statistics op: per-image luma mean -> fp32-truncating blend LUT).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hipe_tpu.ops import equalize as eq


def _pil_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    from PIL import Image, ImageEnhance

    mode = "L" if img.ndim == 2 else "RGB"
    pim = Image.fromarray(img, mode=mode)
    return np.asarray(ImageEnhance.Contrast(pim).enhance(factor))


FACTORS = [0.0, 0.5, 0.8, 1.0, 1.3, 1.9, 2.5]


@pytest.mark.parametrize("factor", FACTORS)
def test_oracle_matches_pil(factor):
    rng = np.random.default_rng(int(factor * 100) + 1)
    img = rng.integers(0, 256, (40, 52, 3), np.uint8)
    np.testing.assert_array_equal(
        eq.contrast_oracle(img, factor), _pil_contrast(img, factor))
    gray = rng.integers(0, 256, (24, 30), np.uint8)
    np.testing.assert_array_equal(
        eq.contrast_oracle(gray, factor), _pil_contrast(gray, factor))


@pytest.mark.parametrize("factor", [0.6, 1.7])
def test_jax_paths_match_pil(factor):
    rng = np.random.default_rng(7)
    batch = np.stack(
        [rng.integers(0, 256, (32, 40, 3), np.uint8) for _ in range(3)])
    want = np.stack([_pil_contrast(b, factor) for b in batch])
    got = np.asarray(eq.contrast_nhwc(jnp.asarray(batch), factor=factor))
    np.testing.assert_array_equal(got, want)
    rows = jnp.asarray(batch.reshape(3, 32, 120))
    got_r = np.asarray(eq.contrast_rows(rows, 3, factor=factor))
    np.testing.assert_array_equal(got_r.reshape(batch.shape), want)
    planes = jnp.asarray(batch.transpose(0, 3, 1, 2).reshape(9, 32, 40))
    got_p = np.asarray(eq.contrast_planar(planes, 3, factor=factor))
    np.testing.assert_array_equal(
        got_p, want.transpose(0, 3, 1, 2).reshape(9, 32, 40))
    # Traced path (cube embedded as a program constant).
    jf = jax.jit(lambda x: eq.contrast_nhwc(x, factor=factor))
    np.testing.assert_array_equal(np.asarray(jf(jnp.asarray(batch))), want)


def test_luma_matches_pil_convert_l():
    from PIL import Image

    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (48, 56, 3), np.uint8)
    want = np.asarray(Image.fromarray(img).convert("L"))
    img4 = jnp.asarray(img.transpose(2, 0, 1)[None])
    got = np.asarray(eq.pil_luma(img4))[0]
    np.testing.assert_array_equal(got, want)


def test_luma_mean_exact_int32_pieces():
    # The threshold-sum mean must equal the plain int64 formula for
    # histograms at 4000x2250 scale (where a naive int32 sum(v*h) would
    # overflow) and for degenerate all-one-bin histograms.
    rng = np.random.default_rng(13)
    npix = 4000 * 2250
    for trial in range(5):
        w = rng.random(256)
        h = (w / w.sum() * npix).astype(np.int64)
        h[0] += npix - h.sum()  # exact total
        s = int((np.arange(256) * h).sum())
        want = (2 * s + npix) // (2 * npix)
        got = int(np.asarray(
            eq.luma_mean_round_half(jnp.asarray(h[None]), npix))[0])
        assert got == want, (trial, got, want)
    for v in (0, 255, 128):
        h = np.zeros(256, np.int64)
        h[v] = npix
        got = int(np.asarray(
            eq.luma_mean_round_half(jnp.asarray(h[None]), npix))[0])
        assert got == v


def test_pipeline_registry_and_validation():
    from hipe_tpu.models.pipelines import PIPELINES, GlobalStatsPipeline

    assert "contrast" in PIPELINES
    rng = np.random.default_rng(19)
    img = rng.integers(0, 256, (2, 32, 40, 3), np.uint8)
    # Registry default factor 1.0 is the identity (PIL blend at 1.0).
    got = np.asarray(PIPELINES["contrast"](jnp.asarray(img)))
    np.testing.assert_array_equal(got, img)
    pipe = GlobalStatsPipeline("contrast", factor=1.5)
    want = np.stack([_pil_contrast(b, 1.5) for b in img])
    np.testing.assert_array_equal(np.asarray(pipe(jnp.asarray(img))), want)
    with pytest.raises(ValueError, match="factor applies to 'contrast'"):
        GlobalStatsPipeline("equalize", factor=2.0)
    with pytest.raises(ValueError, match=">= 0"):
        GlobalStatsPipeline("contrast", factor=-1.0)
    with pytest.raises(ValueError, match="make_contrast_row_split_fn"):
        pipe.radius


@pytest.mark.parametrize("layout", ["nhwc", "rows"])
def test_row_split_psum_luma_exact(layout):
    from hipe_tpu.parallel import mesh as meshlib
    from hipe_tpu.parallel.row_split import make_contrast_row_split_fn

    mesh = meshlib.make_mesh(8, axis=meshlib.ROW_AXIS)
    rng = np.random.default_rng(23)
    batch = np.stack(
        [rng.integers(0, 256, (64, 40, 3), np.uint8) for _ in range(3)])
    want = np.stack([_pil_contrast(b, 0.6) for b in batch])
    if layout == "rows":
        fn = make_contrast_row_split_fn(mesh, factor=0.6, channels=3)
        got = np.asarray(fn(jnp.asarray(batch.reshape(3, 64, 120))))
        got = got.reshape(batch.shape)
    else:
        fn = make_contrast_row_split_fn(mesh, factor=0.6)
        got = np.asarray(fn(jnp.asarray(batch)))
    np.testing.assert_array_equal(got, want)


def test_serving_pipeline_contrast_and_encode_placements():
    from hipe_tpu.io_ import jpeg
    from hipe_tpu.models.pipelines import GlobalStatsPipeline
    from hipe_tpu.runtime.serve import ServingPipeline

    rng = np.random.default_rng(29)
    payloads = [
        jpeg.encode_bytes(rng.integers(0, 256, (32, 48, 3), np.uint8), 90)
        for _ in range(2)
    ]
    pipe = GlobalStatsPipeline("contrast", factor=1.4)
    px = ServingPipeline(pipe, use_pallas=False).process_batch(
        payloads, encode=False)
    for got, payload in zip(px, payloads):
        np.testing.assert_array_equal(
            got, eq.contrast_oracle(jpeg.decode_bytes(payload), 1.4))
    ref = ServingPipeline(pipe, use_pallas=False).process_batch(payloads)
    for kwargs in ({"decode_on_device": True},
                   {"encode_on_device": True},
                   {"decode_on_device": True, "encode_on_device": True}):
        got = ServingPipeline(
            pipe, use_pallas=False, **kwargs).process_batch(payloads)
        assert got == ref, kwargs


def test_cli_approach1_and_stream_parametrized_contrast():
    # plib.get passes constructed pipeline objects through, so the
    # engine/stream CLI paths accept --factor-parametrized pipelines.
    from hipe_tpu.models import pipelines as plib

    pipe = plib.GlobalStatsPipeline("contrast", factor=1.5)
    assert plib.get(pipe) is pipe
    from hipe_tpu.cli import _stats_pipeline_from_flags

    class A:
        factor = 1.5
        cutoff = None
        preserve_tone = False

    got, err = _stats_pipeline_from_flags(A(), "contrast")
    assert err is None and got.factor == 1.5
    got, err = _stats_pipeline_from_flags(A(), "blur3")
    assert got is None and "contrast/color/sharpness" in err
