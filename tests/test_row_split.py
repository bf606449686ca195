"""Row-split + halo exchange over an 8-device mesh == unsplit output.

The reference's seam-correctness property (SURVEY.md §3.2), generalized to N
shards / halo=radius, verified on the virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hipe_tpu.ops import reference as oracle
from hipe_tpu.parallel import mesh as meshlib
from hipe_tpu.parallel.row_split import make_row_split_fn
from hipe_tpu.utils.images import checker_image


def _mesh(n):
    return meshlib.make_mesh(n, axis=meshlib.ROW_AXIS)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_row_split_blur_seam_exact(n_shards):
    mesh = _mesh(n_shards)
    batch = np.stack([checker_image(64, 48, 3, seed=s) for s in range(2)])
    fn = make_row_split_fn(mesh, ("gaussian3",))
    got = np.asarray(fn(jnp.asarray(batch)))
    want = np.stack([oracle.gaussian_blur_int_oracle(b) for b in batch])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [2, 3, 4])
def test_row_split_large_radius(radius):
    mesh = _mesh(4)
    batch = np.stack([checker_image(64, 48, 3, seed=7)])
    name = {2: "gaussian5", 3: "gaussian7", 4: "gaussian9"}[radius]
    fn = make_row_split_fn(mesh, (name,))
    got = np.asarray(fn(jnp.asarray(batch)))
    want = np.stack(
        [oracle.gaussian_blur_int_oracle(b, radius) for b in batch]
    )
    np.testing.assert_array_equal(got, want)


def test_row_split_filter_chain():
    mesh = _mesh(4)
    batch = np.stack([checker_image(64, 48, 3, seed=3)])
    fn = make_row_split_fn(mesh, ("gaussian3", "sharpen", "edge"))
    got = np.asarray(fn(jnp.asarray(batch)))
    want = np.stack(
        [
            oracle.sobel_edge_oracle(
                oracle.sharpen3x3_oracle(oracle.gaussian_blur_int_oracle(b))
            )
            for b in batch
        ]
    )
    np.testing.assert_array_equal(got, want)


def test_row_split_thin_shards():
    """Shards as thin as the radius still produce exact seams."""
    mesh = _mesh(8)
    batch = np.stack([checker_image(16, 48, 3, seed=1)])  # 2 rows per shard
    fn = make_row_split_fn(mesh, ("gaussian3",))
    got = np.asarray(fn(jnp.asarray(batch)))
    want = np.stack([oracle.gaussian_blur_int_oracle(b) for b in batch])
    np.testing.assert_array_equal(got, want)


def test_row_split_dp_2d_mesh():
    """Combined DP x row-split over a 2-D (data=2, rows=4) mesh."""
    mesh = meshlib.make_mesh_2d(2, 4)
    batch = np.stack([checker_image(32, 48, 3, seed=s) for s in range(4)])
    fn = make_row_split_fn(mesh, ("gaussian3",), batch_axis=meshlib.DATA_AXIS)
    got = np.asarray(fn(jnp.asarray(batch)))
    want = np.stack([oracle.gaussian_blur_int_oracle(b) for b in batch])
    np.testing.assert_array_equal(got, want)


def test_weighted_row_split_reference_ratio():
    """2-way weighted split at the reference's tuned ratio 0.837, H=240.

    The uneven analog of `split_image_blur.c:144-154` on an SPMD mesh:
    seam-exact vs the unsplit oracle for the reference geometry.
    """
    from hipe_tpu.parallel.row_split import make_weighted_row_split_fn

    mesh = _mesh(2)
    ratio = 0.837
    fn = make_weighted_row_split_fn(mesh, ("gaussian3",),
                                    weights=[1 - ratio, ratio])
    batch = np.stack([checker_image(240, 320, 3, seed=5)])
    got = np.asarray(fn(jnp.asarray(batch)))
    want = np.stack([oracle.gaussian_blur_int_oracle(b) for b in batch])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("names", [("gaussian3",),
                                   ("gaussian3", "sharpen", "edge")])
def test_weighted_row_split_8way_uneven(names):
    """8-way uneven weights (incl. a near-zero share) stay bit-exact."""
    from hipe_tpu.ops import blur as xblur
    from hipe_tpu.parallel.row_split import make_weighted_row_split_fn

    mesh = _mesh(8)
    weights = [0.001, 1, 2, 0.5, 3, 1, 0.25, 2]  # forces a 1-row shard
    fn = make_weighted_row_split_fn(mesh, names, weights=weights)
    batch = np.stack([checker_image(96, 64, 3, seed=s) for s in range(2)])
    got = np.asarray(fn(jnp.asarray(batch)))
    want = np.asarray(xblur.filter_chain(jnp.asarray(batch), names))
    np.testing.assert_array_equal(got, want)


def test_weighted_row_split_pallas_local_fn():
    """Weighted split with a Pipeline clamp-mode local fn (kernel path)."""
    from hipe_tpu.models import pipelines as plib
    from hipe_tpu.ops import blur as xblur
    from hipe_tpu.parallel.row_split import make_weighted_row_split_fn

    pipe = plib.PIPELINES["blur5"]
    mesh = _mesh(4)
    fn = make_weighted_row_split_fn(
        mesh, pipe.filters, weights=[1, 2, 3, 2],
        local_fn=pipe.nhwc_clamp_fn(use_pallas=True, interpret=True),
        radius=pipe.radius,
    )
    batch = np.stack([checker_image(64, 40, 3, seed=9)])
    got = np.asarray(fn(jnp.asarray(batch)))
    want = np.asarray(xblur.filter_chain(jnp.asarray(batch), pipe.filters))
    np.testing.assert_array_equal(got, want)


def test_row_split_randomized_geometries():
    """Randomized heights/shard-counts: seams stay exact everywhere."""
    rng = np.random.default_rng(0)
    for _ in range(4):
        n = int(rng.choice([2, 4, 8]))
        h = int(n * rng.integers(2, 7))  # shards of 2..6 rows
        w = int(rng.integers(9, 40))
        img = (rng.integers(0, 256, (h, w, 3))).astype(np.uint8)
        mesh = _mesh(n)
        fn = make_row_split_fn(mesh, ("gaussian3",))
        got = np.asarray(fn(jnp.asarray(img[None])))[0]
        np.testing.assert_array_equal(
            got, oracle.gaussian_blur_int_oracle(img)
        )


def test_weighted_row_split_single_shard():
    """n=1 mesh: no window machinery, just the exact clamp-mode chain."""
    from hipe_tpu.ops import blur as xblur
    from hipe_tpu.parallel.row_split import make_weighted_row_split_fn

    mesh = _mesh(1)
    names = ("gaussian3", "sharpen", "edge")
    fn = make_weighted_row_split_fn(mesh, names)
    batch = np.stack([checker_image(32, 16, 3, seed=2)])
    got = np.asarray(fn(jnp.asarray(batch)))
    want = np.asarray(xblur.filter_chain(jnp.asarray(batch), names))
    np.testing.assert_array_equal(got, want)


def test_weighted_row_split_extreme_weights_redistribute():
    """Weights the reference CLI accepts (ratio 0.99) must not crash:
    shares are capped so windows fit, and the output stays exact."""
    from hipe_tpu.ops import blur as xblur
    from hipe_tpu.parallel.row_split import make_weighted_row_split_fn

    mesh = _mesh(2)
    names = ("gaussian3", "sharpen", "edge")  # radius 3
    ratio = 0.99
    fn = make_weighted_row_split_fn(mesh, names, weights=[1 - ratio, ratio])
    batch = np.stack([checker_image(240, 64, 3, seed=8)])
    got = np.asarray(fn(jnp.asarray(batch)))
    want = np.asarray(xblur.filter_chain(jnp.asarray(batch), names))
    np.testing.assert_array_equal(got, want)


def test_weighted_row_split_randomized_properties():
    """Random geometry x weights x chains: redistribution keeps exactness."""
    from hipe_tpu.ops import blur as xblur
    from hipe_tpu.parallel.row_split import make_weighted_row_split_fn

    rng = np.random.default_rng(42)
    all_names = [("gaussian3",), ("gaussian5",),
                 ("gaussian3", "sharpen"), ("gaussian3", "sharpen", "edge")]
    for _ in range(5):
        n = int(rng.choice([2, 4, 8]))
        names = all_names[int(rng.integers(len(all_names)))]
        r = xblur.chain_radius(names)
        # H large enough for feasibility: n*(H-2R) >= H
        h = int(rng.integers(max(4 * r + 2, 24), 80))
        w = int(rng.integers(9, 40))
        weights = rng.random(n) + 0.01
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        mesh = _mesh(n)
        fn = make_weighted_row_split_fn(mesh, names, weights=list(weights))
        got = np.asarray(fn(jnp.asarray(img[None])))
        want = np.asarray(xblur.filter_chain(jnp.asarray(img[None]), names))
        np.testing.assert_array_equal(got, want, err_msg=str(
            (n, names, h, w, weights.round(3).tolist())
        ))


def test_row_split_median_and_denoise_seam_exact():
    # The nonlinear median shard-splits like any radius-1 stencil (the
    # halo machinery is tap-agnostic); seams and global edges must stay
    # exact, single stage and in the denoise chain, even and uneven.
    mesh = _mesh(4)
    batch = np.stack([checker_image(64, 48, 3, seed=s) for s in range(2)])
    want_m = np.stack([oracle.median3x3_oracle(b) for b in batch])
    got = np.asarray(make_row_split_fn(mesh, ("median",))(jnp.asarray(batch)))
    np.testing.assert_array_equal(got, want_m)
    want_d = np.stack(
        [oracle.gaussian_blur_int_oracle(oracle.median3x3_oracle(b))
         for b in batch]
    )
    got = np.asarray(
        make_row_split_fn(mesh, ("median", "gaussian3"))(jnp.asarray(batch))
    )
    np.testing.assert_array_equal(got, want_d)
    from hipe_tpu.parallel.row_split import make_weighted_row_split_fn

    wfn = make_weighted_row_split_fn(mesh, ("median", "gaussian3"),
                                     weights=[1, 2, 3, 2])
    np.testing.assert_array_equal(np.asarray(wfn(jnp.asarray(batch))), want_d)


def test_row_split_morphology_seam_exact():
    # erode/dilate shard like any radius-1 stencil; the open chain
    # (erode -> dilate) must stay exact at shard seams and global edges,
    # on even and weighted uneven shards.
    from hipe_tpu.parallel.row_split import make_weighted_row_split_fn

    mesh = _mesh(4)
    batch = np.stack([checker_image(64, 48, 3, seed=s) for s in range(2)])
    want_e = np.stack([oracle.erode3x3_oracle(b) for b in batch])
    got = np.asarray(make_row_split_fn(mesh, ("erode",))(jnp.asarray(batch)))
    np.testing.assert_array_equal(got, want_e)
    want_o = np.stack(
        [oracle.dilate3x3_oracle(oracle.erode3x3_oracle(b)) for b in batch]
    )
    got = np.asarray(
        make_row_split_fn(mesh, ("erode", "dilate"))(jnp.asarray(batch))
    )
    np.testing.assert_array_equal(got, want_o)
    wfn = make_weighted_row_split_fn(mesh, ("erode", "dilate"),
                                     weights=[1, 3, 2, 2])
    np.testing.assert_array_equal(np.asarray(wfn(jnp.asarray(batch))), want_o)
