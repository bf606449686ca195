"""Oracle self-consistency: the float (OpenCL-semantics) and integer
formulations of every filter must agree bit-for-bit, and the 3x3 blur must
match a literal per-pixel walk of gaussian_kernel.cl:19-72."""

import numpy as np
import pytest

from hipe_tpu.ops import reference as oracle
from hipe_tpu.utils.images import checker_image


def _literal_cl_blur(img: np.ndarray) -> np.ndarray:
    """Direct per-pixel transliteration of the OpenCL kernel semantics."""
    H, W, C = img.shape
    k = np.array(
        [[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125], [0.0625, 0.125, 0.0625]],
        dtype=np.float32,
    )
    out = np.zeros_like(img)
    for y in range(H):
        for x in range(W):
            for c in range(C):
                s = np.float32(0.0)
                for ky in (-1, 0, 1):
                    for kx in (-1, 0, 1):
                        nx = min(max(x + kx, 0), W - 1)
                        ny = min(max(y + ky, 0), H - 1)
                        s += np.float32(img[ny, nx, c]) * k[ky + 1, kx + 1]
                out[y, x, c] = np.uint8(s)  # truncating cast
    return out


def test_float_oracle_matches_literal_cl_kernel():
    img = checker_image(12, 9, 3, seed=1)
    np.testing.assert_array_equal(
        oracle.gaussian_blur_float_oracle(img), _literal_cl_blur(img)
    )


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(16, 16, 3), (33, 21, 3), (64, 64)])
def test_int_oracle_bit_identical_to_float_oracle(radius, shape):
    img = checker_image(*shape) if len(shape) == 3 else checker_image(
        shape[0], shape[1], 1
    ).squeeze(-1)
    np.testing.assert_array_equal(
        oracle.gaussian_blur_int_oracle(img, radius),
        oracle.gaussian_blur_float_oracle(img, radius),
    )


def test_blur_constant_image_is_identity():
    img = np.full((20, 20, 3), 137, dtype=np.uint8)
    np.testing.assert_array_equal(oracle.gaussian_blur_int_oracle(img), img)


def test_blur_truncation_not_rounding():
    # A single 255 pixel in a zero field: center output is 255*4//16 = 63
    # (63.75 truncated), not 64.
    img = np.zeros((5, 5, 1), dtype=np.uint8)
    img[2, 2, 0] = 255
    out = oracle.gaussian_blur_int_oracle(img)
    assert out[2, 2, 0] == 63
    assert out[1, 2, 0] == 255 * 2 // 16  # 31, weight 2/16


def test_sharpen_and_edge_shapes_and_ranges():
    img = checker_image(17, 23, 3, seed=3)
    for fn in (oracle.sharpen3x3_oracle, oracle.sobel_edge_oracle):
        out = fn(img)
        assert out.shape == img.shape and out.dtype == np.uint8


def test_edge_flat_region_is_zero():
    img = np.full((10, 10, 3), 99, dtype=np.uint8)
    np.testing.assert_array_equal(
        oracle.sobel_edge_oracle(img), np.zeros_like(img)
    )
