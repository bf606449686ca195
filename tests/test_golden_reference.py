"""Golden check of the reference's numerics on its Approach-2 input geometry.

The reference kernel accumulates in fp32 and truncates on store
(`gaussian_kernel.cl:19-72`); `ops.reference.gaussian_blur_float_oracle`
walks exactly that arithmetic. The reference's own saved artifact
(`split_output.jpg`) is not part of this repository, so the golden output
here is that fp32 walk on a seeded 320x240 image — the Approach-2 input
size — and every implementation must equal it bit for bit: the integer
oracle, the XLA path, and the Pallas Triton kernel (interpreted on the
CPU)."""

import numpy as np
import pytest

import jax.numpy as jnp

from hipe_tpu.ops import blur as xblur
from hipe_tpu.ops import reference as oracle
from hipe_tpu.utils.images import REFERENCE_320, seeded_image


@pytest.fixture(scope="module")
def pair():
    inp = seeded_image(*REFERENCE_320, seed=837)
    return inp, oracle.gaussian_blur_float_oracle(inp, 1)


def test_oracle_matches_reference_golden(pair):
    inp, golden = pair
    np.testing.assert_array_equal(oracle.gaussian_blur_int_oracle(inp),
                                  golden)


def test_xla_blur_matches_reference_golden(pair):
    inp, golden = pair
    ours = np.asarray(xblur.gaussian_blur3x3(jnp.asarray(inp)))
    np.testing.assert_array_equal(ours, golden)


def test_pallas_blur_matches_reference_golden(pair):
    from hipe_tpu.ops import pallas_blur
    from hipe_tpu.utils.images import hwc_to_planar, planar_to_hwc

    inp, golden = pair
    planes = jnp.asarray(hwc_to_planar(inp[None]))
    ours = planar_to_hwc(
        np.asarray(
            pallas_blur.gaussian_blur_planar_pallas(planes, 1, interpret=True)
        ),
        3,
    )[0]
    np.testing.assert_array_equal(ours, golden)
