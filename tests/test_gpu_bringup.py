"""Bring-up on the GPU: chip_smoke phases at tiny sizes, the no-GPU exits,
the compile-cache location, seeded inputs — and the card-only checks.

Tests marked ``gpu`` need a CUDA device and skip elsewhere; run them on a
card with ``HIPE_TESTS_ON_GPU=1 python -m pytest -m gpu tests/``.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

from hipe_tpu.ops import blur as xblur
from hipe_tpu.ops import reference as oracle
from hipe_tpu.utils.images import REFERENCE_320, seeded_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **extra)
    return env


def test_seeded_image_is_deterministic_and_photo_like():
    a = seeded_image(*REFERENCE_320, seed=3)
    assert a.shape == (240, 320, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, seeded_image(*REFERENCE_320, seed=3))
    assert not np.array_equal(a, seeded_image(*REFERENCE_320, seed=4))
    # Smooth content: neighbouring pixels are close on average.
    assert np.mean(np.abs(np.diff(a.astype(int), axis=1))) < 12


def test_phase_stream_cpu():
    res = chip_smoke.phase_stream(num_images=3, size=(16, 24),
                                  use_pallas=False, passes=1)
    assert res["ok"] and res["kernel"] == "xla"
    assert res["max_abs_err"] == {"xla": 0}
    assert set(res["per_pass_ms"]) == {"xla"}
    assert "argument_size_in_bytes" in res["memory_analysis"]


def test_phase_engine_cpu():
    devs = jax.devices("cpu")
    res = chip_smoke.phase_engine(num_images=12, size=(24, 32),
                                  a1=(0.5, 4), a2=(0.5, 4),
                                  cpu_device=devs[0], accel_device=devs[1])
    assert res["ok"]
    for key in ("approach1", "approach2"):
        assert res[key]["max_abs_err"] == 0
        assert res[key]["accel_kernel"] == "xla"  # CPU device: no kernel
        assert res[key]["cpu_units"] > 0 and res[key]["accel_units"] > 0


def test_phase_serve_resize_cpu():
    res = chip_smoke.phase_serve_resize(num_images=2, size=(36, 64),
                                        resize_to=(18, 30))
    assert res["ok"] and res["shape"] == [2, 18, 30, 3]


def test_phase_multi_cpu():
    devs = jax.devices("cpu")[:4]
    res = chip_smoke.phase_multi(num_images=8, size=(16, 16),
                                 frames=(2, 32, 48), devices=devs)
    assert res["ok"] and res["devices"] == 4
    for key in ("image_level", "row_split", "weighted_row_split"):
        assert res[key]["max_abs_err"] == 0
        assert res[key]["one_shard_per_device"]


def test_chip_smoke_and_bench_refuse_without_gpu(capsys):
    import bench

    assert chip_smoke.main([]) == 1
    assert bench.main() == 1
    out = capsys.readouterr().out
    assert out == ""  # no result line, no fallback run


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_location(tmp_path, env_set):
    code = (
        "import jax, jax.numpy as jnp\n"
        "from hipe_tpu.utils.cache import enable_compilation_cache\n"
        "print(enable_compilation_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    if env_set:
        code += (
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0)\n"
            "jax.config.update('jax_persistent_cache_min_entry_size_bytes',"
            " 0)\n"
            "jax.jit(lambda x: x * 2 + 1)(jnp.arange(4)).block_until_ready()\n"
        )
    cache = str(tmp_path / "cache")
    env = _cpu_env(**({"JAX_COMPILATION_CACHE_DIR": cache} if env_set
                      else {}))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.split()
    from hipe_tpu.utils.cache import DEFAULT_DIR

    want = cache if env_set else DEFAULT_DIR
    assert lines == [want, want]
    if env_set:
        assert os.listdir(cache)  # the compiled program landed there


# ---- card-only checks ----


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a CUDA device (run with HIPE_TESTS_ON_GPU=1)")
    return dev


@pytest.mark.gpu
@pytest.mark.parametrize("h_pad", [True, False])
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_triton_kernel_compiled_matches_xla(gpu, radius, h_pad):
    from hipe_tpu.ops import pallas_blur

    rng = np.random.default_rng(radius)
    for shape in ((300, 256, 256), (5, 17, 300), (2, 1080, 1920)):
        x = jax.device_put(rng.integers(0, 256, shape, dtype=np.uint8), gpu)
        got = pallas_blur.gaussian_blur_planar_pallas(x, radius, h_pad=h_pad)
        want = xblur.gaussian_blur_planar(x, radius, h_pad=h_pad)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
def test_resize_exact_on_gpu(gpu):
    from hipe_tpu.ops.resize import resize_bilinear

    img = seeded_image(1080, 1920, seed=1)
    got = np.asarray(resize_bilinear(jax.device_put(img, gpu), 540, 960))
    np.testing.assert_array_equal(
        got, oracle.resize_bilinear_oracle(img, 540, 960))


@pytest.mark.gpu
def test_chip_smoke_single_card_phases(gpu):
    res = chip_smoke.phase_stream(num_images=300, passes=2)
    assert res["ok"], json.dumps(res, default=str)
    assert res["kernel"].startswith(("pallas-triton", "xla"))
    assert chip_smoke.phase_serve_resize(num_images=2)["ok"]
