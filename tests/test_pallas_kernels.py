"""The Pallas Triton planar blur vs the oracle (interpreter on the CPU),
and the routing that decides where it runs."""

import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hipe_tpu.models import pipelines as plib
from hipe_tpu.ops import blur as xblur
from hipe_tpu.ops import pallas_blur
from hipe_tpu.ops import reference as oracle
from hipe_tpu.utils.images import checker_image, hwc_to_planar, planar_to_hwc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _planes(n=2, h=17, w=20, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, h, w), dtype=np.uint8)


@pytest.mark.parametrize("width", [20, 300], ids=["ragged", "two_col_tiles"])
@pytest.mark.parametrize("h_pad", [True, False], ids=["clamp", "halo"])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_triton_blur_bit_exact(radius, h_pad, width):
    # 17 rows: a ragged last row tile at every block height; width 20 is a
    # masked 32-wide tile, 300 spans two 256-wide column tiles.
    x = _planes(h=17, w=width, seed=radius)
    got = np.asarray(pallas_blur.gaussian_blur_planar_pallas(
        jnp.asarray(x), radius, h_pad=h_pad, interpret=True))
    want = np.asarray(xblur.gaussian_blur_planar(
        jnp.asarray(x), radius, h_pad=h_pad))
    assert got.shape == (2, 17 if h_pad else 17 - 2 * radius, width)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block_h", [4, 8, 16])
def test_triton_blur_launch_shapes(block_h):
    batch = np.stack([checker_image(24, 40, 3, seed=s) for s in range(2)])
    got = pallas_blur.gaussian_blur_planar_pallas(
        jnp.asarray(hwc_to_planar(batch)), 1, block_h=block_h,
        interpret=True)
    got = planar_to_hwc(np.asarray(got), 3)
    want = np.stack([oracle.gaussian_blur_int_oracle(b) for b in batch])
    np.testing.assert_array_equal(got, want)


def test_triton_blur_halo_mode_reassembles_slab():
    img = checker_image(48, 40, 3, seed=5)
    want = oracle.gaussian_blur_int_oracle(img)
    lo, hi = 8, 40
    slab = img[lo - 1: hi + 1]
    got = pallas_blur.gaussian_blur_planar_pallas(
        jnp.asarray(hwc_to_planar(slab[None])), 1, h_pad=False,
        interpret=True)
    np.testing.assert_array_equal(planar_to_hwc(np.asarray(got), 3)[0],
                                  want[lo:hi])


def test_triton_blur_rejects_bad_inputs():
    with pytest.raises(AssertionError):
        pallas_blur.gaussian_blur_planar_pallas(
            jnp.zeros((1, 8, 8), jnp.int32), 1, interpret=True)
    with pytest.raises(AssertionError):
        pallas_blur.gaussian_blur_planar_pallas(
            jnp.zeros((1, 8, 8), jnp.uint8), 1, block_h=6, interpret=True)


def _pallas_call_eqn(fn, *args):
    def walk(jaxpr):
        for e in jaxpr.eqns:
            if e.primitive.name == "pallas_call":
                return e
            for v in e.params.values():
                sub = getattr(v, "jaxpr", None)
                if sub is not None:
                    found = walk(sub)
                    if found is not None:
                        return found
        return None

    return walk(jax.make_jaxpr(fn)(*args).jaxpr)


def test_kernel_names_the_triton_route():
    # Tracing needs no GPU: the kernel must name the Triton backend and
    # carry Triton compiler params, never a Mosaic (TPU or GPU) route.
    eqn = _pallas_call_eqn(
        lambda x: pallas_blur.gaussian_blur_planar_pallas(x, 1),
        _planes())
    assert eqn is not None
    assert eqn.params["backend"] == "triton"
    assert set(eqn.params["compiler_params"]) == {"triton"}
    assert eqn.params["name"] == "gaussian3_planar"


def test_no_module_targets_a_tpu():
    offenders = []
    paths = [os.path.join(ROOT, f) for f in
             ("bench.py", "chip_smoke.py", "__graft_entry__.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "hipe_tpu")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            text = f.read()
        for needle in ("pallas.tpu", "pltpu", "vmem_limit", "int8_bands",
                       "int16_ranks"):
            if needle in text:
                offenders.append((os.path.relpath(path, ROOT), needle))
    assert not offenders, offenders


@pytest.mark.parametrize("platform,expected", [
    ("gpu", True), ("cpu", False), ("tpu", False), ("rocm", False),
])
def test_default_use_pallas_by_platform(platform, expected):
    dev = types.SimpleNamespace(platform=platform)
    assert plib.default_use_pallas(dev) is expected


def test_kernel_routing_by_family():
    for name, pipe in plib.PIPELINES.items():
        single_gauss = (len(pipe.filters) == 1
                        and pipe.filters[0].startswith("gaussian"))
        assert pipe.has_kernel is single_gauss, name
        want = (f"pallas-triton:{pipe.filters[0]}_planar" if single_gauss
                else "xla")
        assert pipe.kernel_name(True) == want, name
        assert pipe.kernel_name(False) == "xla", name


@pytest.mark.parametrize("name", ["blur3", "blur5", "blur7", "blur9"])
def test_pipeline_apply_planar_kernel_matches_xla(name):
    pipe = plib.PIPELINES[name]
    x = jnp.asarray(_planes(n=3, h=20, w=24, seed=len(name)))
    got = np.asarray(pipe.apply_planar(x, use_pallas=True, interpret=True))
    want = np.asarray(pipe.apply_planar(x, use_pallas=False))
    np.testing.assert_array_equal(got, want)


def test_runtime_lanes_route_by_device():
    # On a CPU device every runtime path picks XLA by default.
    from hipe_tpu.runtime.device_stream import DeviceStreamRunner
    from hipe_tpu.runtime.engine import _Lane
    from hipe_tpu.runtime.serve import ServingPipeline
    from hipe_tpu.profiling.events import DeviceCounters

    cpu = jax.devices("cpu")[0]
    img = checker_image(8, 16, 3, seed=1)
    runner = DeviceStreamRunner("blur3", num_images=2, image=img, device=cpu)
    assert runner.use_pallas is False and runner.kernel_name == "xla"
    assert ServingPipeline("blur3", device=cpu).use_pallas is False
    lane = _Lane("accel", cpu, plib.PIPELINES["blur3"],
                 DeviceCounters("accel"), path="pallas", profile=False)
    assert lane.path == "xla"
