"""Bilinear resize: bit-exact vs an independent numpy oracle.

The contract (half-pixel mapping, Q14 weights, per-pass rounding; see
ops/resize.py docstring) is re-implemented in ops/reference.py with
per-pixel gathers — no band matrices — so the banded-matmul formulation is
checked against straight-line integer arithmetic.
"""

import numpy as np
import pytest

from hipe_tpu.ops import reference as oracle
from hipe_tpu.ops import resize as rz


def _oracle(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    return oracle.resize_bilinear_oracle(img, oh, ow)


def _rand(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, c), dtype=np.uint8
    )


@pytest.mark.parametrize(
    "ih,iw,oh,ow",
    [
        (48, 64, 24, 32),    # exact /2
        (48, 64, 17, 23),    # awkward downscale
        (24, 32, 48, 64),    # exact x2 up
        (33, 29, 40, 51),    # upscale, odd dims
        (64, 48, 64, 20),    # W only
        (64, 48, 11, 48),    # H only
        (5, 7, 160, 3),      # extreme ratios both ways
    ],
)
def test_matches_oracle(ih, iw, oh, ow):
    img = _rand(ih, iw)
    got = np.asarray(rz.resize_bilinear(img, oh, ow))
    np.testing.assert_array_equal(got, _oracle(img, oh, ow))


def test_identity_and_batch_and_gray():
    img = _rand(20, 30)
    assert np.asarray(rz.resize_bilinear(img, 20, 30)) is not None
    np.testing.assert_array_equal(np.asarray(rz.resize_bilinear(img, 20, 30)),
                                  img)
    batch = np.stack([_rand(20, 30, seed=s) for s in range(3)])
    got = np.asarray(rz.resize_bilinear(batch, 9, 13))
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], _oracle(batch[i], 9, 13))
    gray = _rand(20, 30, c=1, seed=5)
    np.testing.assert_array_equal(
        np.asarray(rz.resize_bilinear(gray, 31, 7)), _oracle(gray, 31, 7))


def test_planar_matches_interleaved():
    img = _rand(24, 40)
    planes = np.moveaxis(img, -1, 0).copy()  # (C, H, W)
    got = np.asarray(rz.resize_bilinear_planar(planes, 15, 22))
    ref = np.moveaxis(_oracle(img, 15, 22), -1, 0)
    np.testing.assert_array_equal(got, ref)


def test_flat_field_invariance():
    # A constant image must stay constant at any size (weights sum to 2^14).
    img = np.full((13, 9, 3), 173, dtype=np.uint8)
    out = np.asarray(rz.resize_bilinear(img, 50, 4))
    assert (out == 173).all()


@pytest.mark.parametrize("planar", [False, True])
def test_dots_request_highest_precision(planar):
    # An fp32 dot may run in TF32 (10-bit mantissa) on a GPU unless the
    # caller asks for more; the Q14 products reach 2^22, so exactness
    # needs every resize dot at HIGHEST.
    import jax

    img = _rand(48, 64)
    if planar:
        fn = lambda x: rz.resize_bilinear_planar(x, 17, 23)  # noqa: E731
        img = np.moveaxis(img, -1, 0).copy()
    else:
        fn = lambda x: rz.resize_bilinear(x, 17, 23)  # noqa: E731
    eqns = jax.make_jaxpr(fn)(img).jaxpr.eqns
    dots = [e for e in eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None
        assert all(p == jax.lax.Precision.HIGHEST for p in prec), prec
