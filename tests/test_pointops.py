"""Radius-0 point stages (invert/solarize/posterize4): PIL-exact, chainable.

Coverage: closed forms vs PIL ImageOps LUTs; chains mixing point and
stencil stages identical across the NHWC, planar and rows layouts;
row-split with zero-radius stages skipping the halo
exchange; registry/serving integration.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hipe_tpu.ops import blur as xblur
from hipe_tpu.models import pipelines as plib
from hipe_tpu.utils.images import checker_image


def _pil_point(img: np.ndarray, name: str) -> np.ndarray:
    from PIL import Image, ImageOps

    im = Image.fromarray(img, "RGB")
    if name.startswith("posterize"):
        out = ImageOps.posterize(im, int(name[len("posterize"):]))
    elif name == "invert":
        out = ImageOps.invert(im)
    else:
        assert name == "solarize"
        out = ImageOps.solarize(im)  # default threshold 128
    return np.asarray(out)


@pytest.mark.parametrize("name", sorted(xblur.POINT_STAGES))
def test_point_stage_matches_pil(name):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (40, 56, 3), np.uint8)
    got = np.asarray(xblur.FILTERS[name](jnp.asarray(img)))
    np.testing.assert_array_equal(got, _pil_point(img, name))
    # Rows layout agrees.
    rows = jnp.asarray(img.reshape(1, 40, 56 * 3))
    got_rows = np.asarray(
        xblur.ROWS_FILTERS[name](rows, 3)
    ).reshape(img.shape)
    np.testing.assert_array_equal(got_rows, got)
    assert xblur.FILTER_RADIUS[name] == 0


@pytest.mark.parametrize("names", [
    ("gaussian3", "solarize"),
    ("invert", "gaussian3", "posterize4"),
    ("solarize",),
    ("median", "invert"),
], ids=lambda n: "+".join(n))
def test_point_chains_identical_across_paths(names):
    """NHWC chain == planar chain == rows chain."""
    x = np.stack([checker_image(32, 48, 1, seed=s)[..., 0]
                  for s in range(4)])
    want = np.asarray(
        xblur.filter_chain(jnp.asarray(x)[..., None], names,
                           h_axis=-3, w_axis=-2)
    )[..., 0]
    got = np.asarray(xblur.filter_chain(
        jnp.asarray(x), names, h_axis=-2, w_axis=-1))
    np.testing.assert_array_equal(got, want)
    got_rows = np.asarray(xblur.filter_chain_rows(
        jnp.asarray(x), 1, names))
    np.testing.assert_array_equal(got_rows, want)


def test_point_chain_halo_mode():
    """Valid-mode (h_pad=False) slab chain with a zero-radius stage."""
    names = ("gaussian3", "solarize")
    x = np.stack([checker_image(40, 48, 1, seed=s)[..., 0]
                  for s in range(2)])
    r = xblur.chain_radius(names)
    assert r == 1
    want = np.asarray(
        xblur.filter_chain(jnp.asarray(x)[..., None], names,
                           h_axis=-3, w_axis=-2)
    )[..., 0][:, 8:-8]
    # Slab covering rows [8-r, 32+r): interior rows are halo-exact.
    slab = jnp.asarray(x[:, 8 - r : 32 + r])
    got = np.asarray(xblur.filter_chain(
        slab, names, h_axis=-2, w_axis=-1, h_pad=False))
    np.testing.assert_array_equal(got, want[:, : 32 - 8])


def test_row_split_chain_with_point_stage():
    """8-way H sharding of a mixed chain: point stages skip the halo
    exchange and the result is bit-identical to the unsplit chain."""
    from hipe_tpu.parallel.mesh import ROW_AXIS
    from hipe_tpu.parallel.row_split import make_row_split_fn
    from jax.sharding import Mesh

    devs = jax.devices("cpu")[:8]
    mesh = Mesh(np.array(devs), (ROW_AXIS,))
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (2, 64, 48, 3), np.uint8)
    names = ("invert", "gaussian3", "solarize")
    fn = make_row_split_fn(mesh, names)
    got = np.asarray(fn(jnp.asarray(x)))
    want = np.asarray(xblur.filter_chain(jnp.asarray(x), names))
    np.testing.assert_array_equal(got, want)
    # Rows layout variant too.
    fn_rows = make_row_split_fn(mesh, names, channels=3)
    got_rows = np.asarray(
        fn_rows(jnp.asarray(x.reshape(2, 64, 48 * 3)))
    ).reshape(x.shape)
    np.testing.assert_array_equal(got_rows, want)


def test_point_pipelines_registry_and_serving():
    pipe = plib.get("posterize")
    assert pipe.radius == 0 and pipe.filters == ("posterize4",)
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (32, 40, 3), np.uint8)
    np.testing.assert_array_equal(
        np.asarray(pipe(jnp.asarray(img))), _pil_point(img, "posterize4")
    )
    from hipe_tpu.io_ import jpeg
    from hipe_tpu.runtime.serve import ServingPipeline

    payload = jpeg.encode_bytes(img, 90)
    got = ServingPipeline("invert", use_pallas=False).process_batch(
        [payload], encode=False
    )[0]
    np.testing.assert_array_equal(
        got, _pil_point(jpeg.decode_bytes(payload), "invert")
    )


def test_engine_approach2_point_pipelines_seam_exact():
    """Two-lane row-split engine: halo 0 for point-only pipelines, halo 1
    for a mixed chain, both reassembled bit-exact."""
    from hipe_tpu.runtime.engine import Engine, EngineConfig

    devs = jax.devices("cpu")
    img = checker_image(64, 48, 3, seed=5)
    for pipe, halo in ((("invert",), 0), (("gaussian3", "solarize"), 1)):
        cfg = EngineConfig(approach=2, mode="both", gpu_ratio=0.5,
                           batch_size=4, num_images=8, pipeline=pipe)
        eng = Engine(cfg, cpu_device=devs[0], accel_device=devs[1])
        stats = eng.run(image=img)
        assert stats.halo == halo
        want = np.asarray(xblur.filter_chain(jnp.asarray(img), pipe))
        np.testing.assert_array_equal(eng.first_output[0], want)
