"""Static-LUT point stages: brightness (PIL-bit-exact), gamma, user LUTs.

The in-graph apply is the static comparison-sum (zero-diff thresholds
pruned at trace time), bit-identical to a gather; stages register into
POINT_STAGES so they compose on every path point stages do (MXU chains
included).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hipe_tpu.ops import blur as xblur


def _rand_img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("factor", [0.0, 0.5, 0.7, 1.0, 1.234, 1.9])
def test_brightness_matches_pil_imageenhance(factor):
    from PIL import Image, ImageEnhance

    img = _rand_img((32, 40, 3), seed=int(factor * 100))
    name = f"lt_b{int(factor * 1000)}"
    xblur.register_lut_filter(name, xblur.brightness_lut(factor))
    got = np.asarray(xblur.FILTERS[name](jnp.asarray(img)))
    want = np.asarray(
        ImageEnhance.Brightness(Image.fromarray(img)).enhance(factor))
    np.testing.assert_array_equal(got, want)
    rows = jnp.asarray(img[None].reshape(1, 32, 40 * 3))
    got_r = np.asarray(xblur.ROWS_FILTERS[name](rows, 3)).reshape(32, 40, 3)
    np.testing.assert_array_equal(got_r, want)


def test_gamma_lut_closed_form():
    lut = xblur.gamma_lut(2.2)
    v = np.arange(256, dtype=np.float64) / 255.0
    want = np.clip(np.round(255.0 * v ** 2.2), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(lut, want)
    assert lut[0] == 0 and lut[255] == 255
    assert (np.diff(lut.astype(int)) >= 0).all()


def test_lut_stage_equals_gather_for_arbitrary_lut():
    # Non-monotone arbitrary LUT: the pruned comparison-sum must still be
    # bit-identical to a plain table lookup.
    rng = np.random.default_rng(3)
    lut = rng.integers(0, 256, 256).astype(np.uint8)
    xblur.register_lut_filter("lt_rand", lut)
    img = _rand_img((24, 30, 3), seed=9)
    got = np.asarray(xblur.FILTERS["lt_rand"](jnp.asarray(img)))
    np.testing.assert_array_equal(got, lut[img])
    got_h = np.asarray(
        xblur.FILTERS["lt_rand"](jnp.asarray(img), h_pad=False))
    np.testing.assert_array_equal(got_h, lut[img])  # radius 0: same shape


def test_lut_stage_in_chain_planar_and_rows():
    xblur.register_lut_filter("lt_g22", xblur.gamma_lut(2.2))
    x = np.stack([_rand_img((32, 48), seed=s) for s in range(4)])
    mix = ("gaussian3", "lt_g22", "sharpen")
    want = np.asarray(xblur.filter_chain(
        jnp.asarray(x)[..., None], mix, h_axis=-3, w_axis=-2))[..., 0]
    got = np.asarray(xblur.filter_chain(
        jnp.asarray(x), mix, h_axis=-2, w_axis=-1))
    np.testing.assert_array_equal(got, want)
    got_r = np.asarray(xblur.filter_chain_rows(jnp.asarray(x), 1, mix))
    np.testing.assert_array_equal(got_r, want)
    lut = xblur.gamma_lut(2.2)
    got_p = np.asarray(xblur.filter_chain(
        jnp.asarray(x), ("lt_g22",), h_axis=-2, w_axis=-1))
    np.testing.assert_array_equal(got_p, lut[x])


def test_lut_stage_row_split_chain():
    from hipe_tpu.ops import reference as oracle
    from hipe_tpu.parallel import mesh as meshlib
    from hipe_tpu.parallel.row_split import make_row_split_fn

    xblur.register_lut_filter("lt_dim", xblur.brightness_lut(0.7))
    mesh = meshlib.make_mesh(4, axis=meshlib.ROW_AXIS)
    batch = np.stack([_rand_img((64, 40, 3), seed=s) for s in range(2)])
    lut = xblur.brightness_lut(0.7)
    want = np.stack(
        [oracle.gaussian_blur_int_oracle(lut[b]) for b in batch])
    got = np.asarray(
        make_row_split_fn(mesh, ("lt_dim", "gaussian3"))(jnp.asarray(batch)))
    np.testing.assert_array_equal(got, want)


def test_register_lut_filter_validation():
    with pytest.raises(ValueError, match="256 entries"):
        xblur.register_lut_filter("lt_bad1", np.arange(255))
    with pytest.raises(ValueError, match="in \\[0, 255\\]"):
        xblur.register_lut_filter("lt_bad2", np.arange(256) - 1)
    with pytest.raises(ValueError, match="builtin filter name"):
        xblur.register_lut_filter("invert", np.arange(256))
    xblur.register_lut_filter("lt_dup", np.arange(256))
    xblur.register_lut_filter("lt_dup", np.arange(256))  # idempotent
    with pytest.raises(ValueError, match="different entries"):
        xblur.register_lut_filter("lt_dup", 255 - np.arange(256))
    with pytest.raises(ValueError, match=">= 0"):
        xblur.brightness_lut(-0.5)
    with pytest.raises(ValueError, match="> 0"):
        xblur.gamma_lut(0)


def test_cli_lut_flag():
    from hipe_tpu.cli import _register_cli_luts

    assert _register_cli_luts(["lt_cli=brightness:0.8"]) is None
    assert "lt_cli" in xblur.LUT_STAGES
    assert _register_cli_luts(
        ["lt_cli2=" + ",".join(str(v) for v in range(256))]) is None
    np.testing.assert_array_equal(
        xblur.LUT_STAGES["lt_cli2"], np.arange(256, dtype=np.uint8))
    err = _register_cli_luts(["nope"])
    assert err and "bad --lut" in err
    err = _register_cli_luts(["lt_x=sigmoid:2"])
    assert err and "unknown LUT constructor" in err
    err = _register_cli_luts(["lt_y=gamma:0"])
    assert err and "> 0" in err


def test_solarize_lut_matches_pil():
    from PIL import Image, ImageOps

    rng = np.random.default_rng(71)
    img = rng.integers(0, 256, (20, 24), np.uint8)
    for t in (0, 64, 130, 255):
        want = np.asarray(ImageOps.solarize(Image.fromarray(img), t))
        np.testing.assert_array_equal(xblur.solarize_lut(t)[img], want)
    with pytest.raises(ValueError, match="\\[0, 256\\]"):
        xblur.solarize_lut(-1)
    from hipe_tpu.cli import _register_cli_luts

    assert _register_cli_luts(["lt_sol=solarize:100"]) is None
    np.testing.assert_array_equal(
        xblur.LUT_STAGES["lt_sol"], xblur.solarize_lut(100))
