"""Generalized rank filters — PIL RankFilter/MedianFilter(5)/MinFilter(5)/
MaxFilter(5) bit-exact (borders included: PIL rank filters replicate the
border, the engine's clamp-to-edge rule), via a pure min/max odd-even
transposition network in every layout."""

import numpy as np
import pytest

import jax.numpy as jnp

from hipe_tpu.ops import blur as xblur
from hipe_tpu.ops import reference as oracle


def _pil_rank(img, size, rank):
    from PIL import Image, ImageFilter

    pf = ImageFilter.RankFilter(size, rank)
    if img.ndim == 2:
        return np.asarray(Image.fromarray(img).filter(pf))
    return np.stack(
        [np.asarray(Image.fromarray(img[:, :, c]).filter(pf))
         for c in range(img.shape[2])], axis=-1)


@pytest.mark.parametrize("name,size,rank", [
    ("median5", 5, 12), ("erode5", 5, 0), ("dilate5", 5, 24),
    ("median7", 7, 24), ("median9", 9, 40),
])
def test_builtin_rank_filters_match_pil_all_layouts(name, size, rank):
    rng = np.random.default_rng(rank + 1)
    img = rng.integers(0, 256, (30, 36, 3)).astype(np.uint8)
    want = oracle.rank_oracle(img, size, rank)
    np.testing.assert_array_equal(want, _pil_rank(img, size, rank),
                                  err_msg=f"{name} vs PIL")
    got = np.asarray(xblur.FILTERS[name](jnp.asarray(img)))
    np.testing.assert_array_equal(got, want, err_msg=f"{name} hwc")
    rows = jnp.asarray(img[None].reshape(1, 30, 36 * 3))
    got_r = np.asarray(xblur.ROWS_FILTERS[name](rows, 3)).reshape(30, 36, 3)
    np.testing.assert_array_equal(got_r, want, err_msg=f"{name} rows")
    r = size // 2
    gh = np.asarray(xblur.FILTERS[name](jnp.asarray(img), h_pad=False))
    np.testing.assert_array_equal(gh, want[r:-r], err_msg=f"{name} halo")


def test_sorting_network_all_ranks_9():
    # The odd-even transposition network must realize every order
    # statistic exactly — checked against np.sort for all 9 ranks.
    rng = np.random.default_rng(3)
    vals = [jnp.asarray(rng.integers(0, 256, (11, 13), np.int32))
            for _ in range(9)]
    stacked = np.sort(np.stack([np.asarray(v) for v in vals]), axis=0)
    for rank in range(9):
        got = np.asarray(xblur._rank_select(vals, rank))
        np.testing.assert_array_equal(got, stacked[rank], err_msg=str(rank))


def test_custom_rank_registration_and_pil():
    xblur.register_rank_filter("rk_q", 5, 6)
    xblur.register_rank_filter("rk_q", 5, 6)  # idempotent
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (24, 28, 3)).astype(np.uint8)
    want = _pil_rank(img, 5, 6)
    got = np.asarray(xblur.FILTERS["rk_q"](jnp.asarray(img)))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="different spec"):
        xblur.register_rank_filter("rk_q", 5, 7)
    with pytest.raises(ValueError, match="size must be odd 3..9"):
        xblur.register_rank_filter("rk_bad", 4, 0)
    with pytest.raises(ValueError, match="size must be odd 3..9"):
        xblur.register_rank_filter("rk_bad11", 11, 24)
    with pytest.raises(ValueError, match="rank must be in"):
        xblur.register_rank_filter("rk_bad2", 3, 9)
    with pytest.raises(ValueError, match="builtin filter name"):
        xblur.register_rank_filter("median", 3, 4)
    # Size-7 custom registration (a non-median rank, vs PIL).
    xblur.register_rank_filter("rk_q7", 7, 10)
    img7 = np.random.default_rng(11).integers(
        0, 256, (26, 22, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(xblur.FILTERS["rk_q7"](jnp.asarray(img7))),
        _pil_rank(img7, 7, 10))


def _planar(x, names):
    return np.asarray(xblur.filter_chain(jnp.asarray(x), names, h_axis=-2,
                                         w_axis=-1))


def _rows(x, names):
    b, h, w = x.shape
    return np.asarray(xblur.filter_chain_rows(
        jnp.asarray(x.reshape(b, h, w)), 1, names)).reshape(x.shape)


def test_rank_filters_planar_rows_and_row_split():
    from hipe_tpu.parallel import mesh as meshlib
    from hipe_tpu.parallel.row_split import make_row_split_fn

    x = np.stack([np.random.default_rng(s).integers(0, 256, (32, 48))
                  .astype(np.uint8) for s in range(2)])
    want = np.stack(
        [oracle.rank_oracle(p[..., None], 5, 12)[..., 0] for p in x])
    np.testing.assert_array_equal(_planar(x, ("median5",)), want)
    np.testing.assert_array_equal(_rows(x, ("median5",)), want)
    # Radius-2 stage through the generic halo machinery, chained.
    mesh = meshlib.make_mesh(4, axis=meshlib.ROW_AXIS)
    batch = np.stack([np.random.default_rng(s).integers(
        0, 256, (64, 40, 3)).astype(np.uint8) for s in range(2)])
    want_c = np.stack([oracle.gaussian_blur_int_oracle(
        oracle.rank_oracle(b, 5, 12)) for b in batch])
    fn = make_row_split_fn(mesh, ("median5", "gaussian3"))
    np.testing.assert_array_equal(np.asarray(fn(jnp.asarray(batch))), want_c)


def test_rank79_planar_rows_and_row_split():
    # Size-7/9 (radius 3/4) through the planar and rows layouts and the
    # row-split halo exchange — all bit-exact vs the PIL-checked oracle.
    from hipe_tpu.parallel import mesh as meshlib
    from hipe_tpu.parallel.row_split import make_row_split_fn

    x = np.stack([np.random.default_rng(s).integers(0, 256, (32, 48))
                  .astype(np.uint8) for s in range(2)])
    want7 = np.stack(
        [oracle.rank_oracle(p[..., None], 7, 24)[..., 0] for p in x])
    np.testing.assert_array_equal(_planar(x, ("median7",)), want7)
    np.testing.assert_array_equal(_rows(x, ("median7",)), want7)
    # Radius-3 stage through the generic halo machinery (4-way split).
    mesh = meshlib.make_mesh(4, axis=meshlib.ROW_AXIS)
    batch = np.stack([np.random.default_rng(s).integers(
        0, 256, (64, 40, 3)).astype(np.uint8) for s in range(2)])
    want_c = np.stack([oracle.rank_oracle(b, 7, 24) for b in batch])
    fn = make_row_split_fn(mesh, ("median7",))
    np.testing.assert_array_equal(np.asarray(fn(jnp.asarray(batch))), want_c)
    # Radius-4: median9 through row-split (the widest supported halo).
    want_9 = np.stack([oracle.rank_oracle(b, 9, 40) for b in batch])
    fn9 = make_row_split_fn(mesh, ("median9",))
    np.testing.assert_array_equal(np.asarray(fn9(jnp.asarray(batch))), want_9)


def test_rank_wide_plane_planar():
    # A wide plane: XLA needs no tile sizing for the 25 live window views.
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (1, 48, 1400), np.uint8)
    want = oracle.rank_oracle(x[0][..., None], 5, 12)[..., 0]
    np.testing.assert_array_equal(_planar(x, ("median5",))[0], want)


def test_rank_extreme_width_planar():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (1, 16, 60000), np.uint8)
    want = oracle.rank_oracle(x[0][..., None], 5, 12)[..., 0]
    np.testing.assert_array_equal(_planar(x, ("median5",))[0], want)


def test_rank_size9_planar_and_rows():
    # Size 9 (81 live views, the bit-serial counting selection).
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, (1, 32, 640), np.uint8)
    want = oracle.rank_oracle(x[0][..., None], 9, 40)[..., 0]
    np.testing.assert_array_equal(_planar(x, ("median9",))[0], want)
    np.testing.assert_array_equal(_rows(x, ("median9",))[0], want)


def test_cli_rank_flag():
    from hipe_tpu.cli import _register_cli_ranks

    assert _register_cli_ranks(["rk_cli=5:3"]) is None
    assert xblur.RANK_STAGES["rk_cli"] == (5, 3)
    err = _register_cli_ranks(["nope"])
    assert err and "bad --rank" in err
    err = _register_cli_ranks(["rk_x=4:0"])
    assert err and "size must be odd 3..9" in err
