"""Interleaved-rows layout ops (the channels-last device layout)."""

import numpy as np
import pytest

import jax.numpy as jnp

from hipe_tpu.models import pipelines as plib
from hipe_tpu.ops import blur as xblur
from hipe_tpu.ops import reference as oracle
from hipe_tpu.utils.images import checker_image


def _rows(batch):
    b, h, w, c = batch.shape
    return jnp.asarray(batch.reshape(b, h, w * c))


BATCH = np.stack([checker_image(32, 40, 3, seed=s) for s in range(2)])


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_xla_rows_blur_bit_exact(radius):
    got = np.asarray(
        xblur.gaussian_blur_rows(_rows(BATCH), 3, radius)
    ).reshape(BATCH.shape)
    want = np.stack(
        [oracle.gaussian_blur_int_oracle(b, radius) for b in BATCH]
    )
    np.testing.assert_array_equal(got, want)


def test_xla_rows_sharpen_edge_chain():
    got_s = np.asarray(
        xblur.sharpen3x3_rows(_rows(BATCH), 3)
    ).reshape(BATCH.shape)
    np.testing.assert_array_equal(
        got_s, np.stack([oracle.sharpen3x3_oracle(b) for b in BATCH])
    )
    got_e = np.asarray(
        xblur.sobel_edge_rows(_rows(BATCH), 3)
    ).reshape(BATCH.shape)
    np.testing.assert_array_equal(
        got_e, np.stack([oracle.sobel_edge_oracle(b) for b in BATCH])
    )
    got_c = np.asarray(
        xblur.filter_chain_rows(_rows(BATCH), 3, ("gaussian3", "sharpen",
                                                  "edge"))
    ).reshape(BATCH.shape)
    want_c = np.stack(
        [
            oracle.sobel_edge_oracle(
                oracle.sharpen3x3_oracle(oracle.gaussian_blur_int_oracle(b))
            )
            for b in BATCH
        ]
    )
    np.testing.assert_array_equal(got_c, want_c)


def test_xla_rows_halo_mode():
    img = checker_image(48, 32, 3, seed=9)
    want = oracle.gaussian_blur_int_oracle(img)
    lo, hi = 10, 40
    slab = img[lo - 1 : hi + 1]
    rows = jnp.asarray(slab.reshape(1, slab.shape[0], -1))
    got = np.asarray(
        xblur.gaussian_blur_rows(rows, 3, 1, h_pad=False)
    ).reshape(1, hi - lo, 32, 3)
    np.testing.assert_array_equal(got[0], want[lo:hi])


@pytest.mark.parametrize("name,radius", [("blur3", 1), ("blur5", 2)])
def test_pipeline_rows_blur_stays_xla(name, radius):
    # Rows in, rows out: even single Gaussians stay on the rows XLA ops
    # (a planar relayout around the kernel measured slower on the card).
    pipe = plib.PIPELINES[name]
    assert pipe.kernel_name(True, layout="rows") == "xla"
    assert pipe.kernel_name(True) == f"pallas-triton:{pipe.filters[0]}_planar"
    batch = np.stack([checker_image(32, 40, 3, seed=s) for s in range(2)])
    got = np.asarray(
        pipe.apply_rows(_rows(batch), 3, use_pallas=True)
    ).reshape(batch.shape)
    want = np.stack(
        [oracle.gaussian_blur_int_oracle(b, radius) for b in batch]
    )
    np.testing.assert_array_equal(got, want)


def test_pipeline_rows_chain_runs_xla():
    # Chains have no hand-written kernel: use_pallas leaves them on XLA.
    pipe = plib.PIPELINES["chain"]
    assert pipe.kernel_name(True) == "xla"
    got = np.asarray(
        pipe.apply_rows(_rows(BATCH), 3, use_pallas=True)
    ).reshape(BATCH.shape)
    want = np.stack(
        [
            oracle.sobel_edge_oracle(
                oracle.sharpen3x3_oracle(oracle.gaussian_blur_int_oracle(b))
            )
            for b in BATCH
        ]
    )
    np.testing.assert_array_equal(got, want)


def test_pipeline_apply_rows_xla_and_wrapper():
    pipe = plib.PIPELINES["chain"]
    got = np.asarray(
        pipe.apply_rows(_rows(BATCH), 3, use_pallas=False)
    ).reshape(BATCH.shape)
    want = np.stack(
        [
            oracle.sobel_edge_oracle(
                oracle.sharpen3x3_oracle(oracle.gaussian_blur_int_oracle(b))
            )
            for b in BATCH
        ]
    )
    np.testing.assert_array_equal(got, want)
    got2 = np.asarray(pipe.apply_nhwc(jnp.asarray(BATCH), use_pallas=False))
    np.testing.assert_array_equal(got2, want)


def test_row_split_rows_layout():
    """SPMD row split over rows layout == oracle (8 shards, chain)."""
    from hipe_tpu.parallel import mesh as meshlib
    from hipe_tpu.parallel.row_split import make_row_split_fn

    mesh = meshlib.make_mesh(8, axis=meshlib.ROW_AXIS)
    batch = np.stack([checker_image(64, 48, 3, seed=s) for s in range(2)])
    fn = make_row_split_fn(mesh, ("gaussian3", "sharpen", "edge"), channels=3)
    got = np.asarray(fn(_rows(batch))).reshape(batch.shape)
    want = np.stack(
        [
            oracle.sobel_edge_oracle(
                oracle.sharpen3x3_oracle(oracle.gaussian_blur_int_oracle(b))
            )
            for b in batch
        ]
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,radius", [
    (300, 48, 1), (256, 48, 2), (100, 30, 1), (50, 48, 4),
])
def test_large_plane_planar_xla(h, w, radius):
    """Planar XLA blur == oracle across tall / ragged geometries."""
    img = checker_image(h, w, 3, seed=h)
    planes = jnp.asarray(img.transpose(2, 0, 1).reshape(3, h, w))
    got = np.asarray(xblur.gaussian_blur_planar(planes, radius))
    want = oracle.gaussian_blur_int_oracle(img, radius)
    np.testing.assert_array_equal(got.transpose(1, 2, 0), want)


@pytest.mark.parametrize("channels", [1, 4])
def test_channel_counts_beyond_rgb(channels):
    """Grayscale and RGBA streams work through every layer (C-generic ops)."""
    batch = np.stack(
        [checker_image(32, 128, channels, seed=s) for s in range(2)]
    )
    rows = jnp.asarray(batch.reshape(2, 32, 128 * channels))
    pipe = plib.PIPELINES["blur3"]
    got = np.asarray(
        pipe.apply_rows(rows, channels, use_pallas=False)
    ).reshape(batch.shape)
    want = np.stack([oracle.gaussian_blur_int_oracle(b) for b in batch])
    np.testing.assert_array_equal(got, want)
    # the planar kernel (interpreted) on the same images as planes
    planes = jnp.asarray(batch.transpose(0, 3, 1, 2).reshape(-1, 32, 128))
    got_p = np.asarray(
        pipe.apply_planar(planes, use_pallas=True, interpret=True)
    ).reshape(2, channels, 32, 128).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got_p, want)


def test_engine_grayscale_stream():
    import jax

    from hipe_tpu.runtime.engine import Engine, EngineConfig

    devs = jax.devices("cpu")
    img = checker_image(24, 32, 1, seed=3)
    eng = Engine(
        EngineConfig(approach=1, mode="both", batch_size=4, num_images=8),
        cpu_device=devs[0], accel_device=devs[1],
    )
    eng.run(image=img)
    want = oracle.gaussian_blur_int_oracle(img)
    np.testing.assert_array_equal(eng.first_output[0], want)


def test_nhwc_wrapper_and_cache_helper(monkeypatch):
    """Convenience NHWC wrapper + compilation-cache helper."""
    batch = np.stack([checker_image(32, 40, 3, seed=s) for s in range(2)])
    got = np.asarray(
        plib.PIPELINES["blur3"].apply_nhwc(
            jnp.asarray(batch), use_pallas=True
        )
    )
    want = np.stack([oracle.gaussian_blur_int_oracle(b) for b in batch])
    np.testing.assert_array_equal(got, want)

    import jax

    from hipe_tpu.utils import cache

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    try:
        assert cache.enable_compilation_cache() == cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_engine_custom_filter_tuple_pipeline():
    import jax

    from hipe_tpu.runtime.engine import Engine, EngineConfig

    devs = jax.devices("cpu")
    img = checker_image(24, 32, 3, seed=4)
    eng = Engine(
        EngineConfig(approach=1, mode="both", batch_size=4, num_images=8,
                     pipeline=("gaussian3", "sharpen")),
        cpu_device=devs[0], accel_device=devs[1],
    )
    eng.run(image=img)
    want = oracle.sharpen3x3_oracle(oracle.gaussian_blur_int_oracle(img))
    np.testing.assert_array_equal(eng.first_output[0], want)


@pytest.mark.parametrize("name,oracle_fn", [
    ("sharpen", oracle.sharpen3x3_oracle),
    ("edge", oracle.sobel_edge_oracle),
])
@pytest.mark.parametrize("h", [300, 100, 47])
def test_large_plane_point_stages_xla(name, oracle_fn, h):
    """Planar XLA sharpen/edge on tall planes == oracle."""
    img = checker_image(h, 40, 3, seed=h + len(name))
    planes = jnp.asarray(img.transpose(2, 0, 1))
    got = np.asarray(xblur.filter_chain(planes, (name,), h_axis=-2,
                                        w_axis=-1))
    np.testing.assert_array_equal(got.transpose(1, 2, 0), oracle_fn(img))


def test_large_plane_chain_xla():
    """Planar XLA chain == unsplit chain oracle (edges incl.)."""
    img = checker_image(130, 40, 3, seed=3)
    planes = jnp.asarray(img.transpose(2, 0, 1))
    got = np.asarray(xblur.filter_chain(
        planes, ("gaussian3", "sharpen", "edge"), h_axis=-2, w_axis=-1))
    want = oracle.sobel_edge_oracle(
        oracle.sharpen3x3_oracle(oracle.gaussian_blur_int_oracle(img))
    )
    np.testing.assert_array_equal(got.transpose(1, 2, 0), want)


def test_oversized_chain_routes_to_xla():
    """Oversized planes need no special route: chains stay on XLA."""
    img = checker_image(2049, 1025, 1, seed=9)[..., 0]
    planes = jnp.asarray(img[None])
    pipe = plib.PIPELINES["chain"]
    got = np.asarray(pipe.apply_planar(planes, use_pallas=True))[0]
    want = oracle.sobel_edge_oracle(
        oracle.sharpen3x3_oracle(
            oracle.gaussian_blur_int_oracle(img[..., None])
        )
    )[..., 0]
    np.testing.assert_array_equal(got, want)
