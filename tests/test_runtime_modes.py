"""Device-resident stream runner and the fused serving pipeline."""

import numpy as np

from hipe_tpu.io_.jpeg import decode_bytes, encode_bytes
from hipe_tpu.ops import reference as oracle
from hipe_tpu.runtime.device_stream import DeviceStreamRunner
from hipe_tpu.runtime.serve import ServingPipeline
from hipe_tpu.utils.images import checker_image


def test_device_stream_runner_verify_and_throughput():
    img = checker_image(32, 128, 3, seed=0)
    runner = DeviceStreamRunner("blur3", num_images=8, image=img,
                                use_pallas=False)
    assert runner.verify_max_abs_err() == 0
    res = runner.measure_throughput(passes=2, reps=1)
    assert res["img_per_s"] > 0 and res["per_pass_s"] > 0


def test_device_stream_runner_chain_pipeline():
    img = checker_image(32, 128, 3, seed=1)
    runner = DeviceStreamRunner("chain", num_images=4, image=img,
                                use_pallas=False)
    assert runner.verify_max_abs_err() == 0


def test_serving_pipeline_decode_filter_encode():
    img = checker_image(24, 32, 3, seed=2)
    payloads = [encode_bytes(img, quality=100)] * 5
    serve = ServingPipeline("blur3", use_pallas=False)
    out = serve.process_batch(payloads, encode=False)
    # The decoded input is JPEG-lossy; the filter itself must match the
    # oracle applied to the decoded pixels exactly.
    decoded = decode_bytes(payloads[0])
    want = oracle.gaussian_blur_int_oracle(decoded)
    np.testing.assert_array_equal(out[0], want)


def test_serving_pipeline_device_decode_matches_host_path():
    # decode_on_device (host entropy decode + on-device IDCT/upsample/color,
    # fused with the filter) must produce byte-identical batches to the
    # host-codec path for any pipeline.
    img = checker_image(24, 40, 3, seed=7)
    payloads = [encode_bytes(img, quality=85)] * 4
    host_serve = ServingPipeline("chain", use_pallas=False)
    dev_serve = ServingPipeline("chain", use_pallas=False,
                                decode_on_device=True)
    want = host_serve.process_batch(payloads, encode=False)
    got = dev_serve.process_batch(payloads, encode=False)
    np.testing.assert_array_equal(got, want)
    assert dev_serve.stats.images == 0  # process_batch doesn't count stream
    # Streaming mode with the same fused path.
    got_stream = list(dev_serve.run([payloads, payloads], encode=False))
    np.testing.assert_array_equal(got_stream[0], want)
    np.testing.assert_array_equal(got_stream[1], want)
    assert dev_serve.stats.images == 8
    assert len(dev_serve._fused_fns) == 1  # one geometry+qtable group


def test_serving_pipeline_streaming_mixed_resolution():
    a = checker_image(16, 24, 3, seed=3)
    b = checker_image(24, 32, 3, seed=4)
    batches = [
        [encode_bytes(a)] * 3,
        [encode_bytes(b)] * 2,
        [encode_bytes(a)] * 3,
    ]
    serve = ServingPipeline("blur3", use_pallas=False)
    results = list(serve.run(batches, encode=True))
    assert [len(r) for r in results] == [3, 2, 3]
    # outputs decode back to the right shapes
    assert decode_bytes(results[0][0]).shape == a.shape
    assert decode_bytes(results[1][0]).shape == b.shape
    assert serve.stats.images == 8
    assert serve.stats.wall_ms > 0
    # per-shape jit cache has exactly the two resolutions
    assert len(serve._fns) == 2


def test_autotune_kernel_failure_is_an_error(tmp_path):
    """A kernel config that cannot compile (the Triton kernel outside the
    interpreter, on this CPU backend) stops the sweep with its error; it
    is never recorded as a skip with XLA chosen in its place."""
    import pytest

    img = checker_image(16, 24, 3, seed=0)
    r = DeviceStreamRunner("blur3", num_images=1, image=img,
                           use_pallas=False,
                           tune_cache_path=str(tmp_path / "tune.json"))
    r.use_pallas = True  # as on a GPU device
    with pytest.raises(Exception):
        r.autotune(passes=1, reps=1)
    assert r.tuning is None


def test_autotune_cache_hit_skips_sweep(tmp_path, capsys, monkeypatch):
    """Second run re-verifies the persisted winner with one timing and
    skips the sweep; --retune forces a fresh sweep."""
    # The regression re-sweep is timing-triggered by design; under a
    # loaded CI host the microsecond-scale CPU timings here jitter well
    # past the production factor, so pin a huge one — the cache-hit
    # mechanics under test are timing-independent (the regression PATH
    # has its own test below).
    from hipe_tpu.runtime import device_stream as ds

    monkeypatch.setattr(ds, "_RETUNE_FACTOR", 1e9)
    img = checker_image(32, 128, 3, seed=0)
    path = str(tmp_path / "tune.json")
    r = DeviceStreamRunner("blur3", num_images=4, image=img,
                           use_pallas=False, tune_cache_path=path)
    first = r.autotune(passes=1, reps=1)
    assert r.tuning["cache_hit"] is False
    chosen = r.tuning["chosen"]
    assert len(first) >= 1

    r2 = DeviceStreamRunner("blur3", num_images=4, image=img,
                            use_pallas=False, tune_cache_path=path)
    second = r2.autotune(passes=1, reps=1)
    assert r2.tuning["cache_hit"] is True
    assert r2.tuning["chosen"] == chosen
    assert list(second) == [chosen]  # one timing, no sweep
    assert r2.path == r.path

    third = r2.autotune(passes=1, reps=1, retune=True)
    assert r2.tuning["cache_hit"] is False
    assert set(third) == set(first)


def test_autotune_cache_regression_resweeps(tmp_path):
    """A cached timing far below what the config now measures triggers a
    full re-sweep instead of silently accepting a regressed config."""
    import json

    img = checker_image(32, 128, 3, seed=0)
    path = str(tmp_path / "tune.json")
    r = DeviceStreamRunner("blur3", num_images=4, image=img,
                           use_pallas=False, tune_cache_path=path)
    r.autotune(passes=1, reps=1)
    with open(path) as f:
        data = json.load(f)
    (key,) = data["entries"]
    data["entries"][key]["per_pass_s"] = 1e-12  # impossible-to-match time
    with open(path, "w") as f:
        json.dump(data, f)

    r2 = DeviceStreamRunner("blur3", num_images=4, image=img,
                            use_pallas=False, tune_cache_path=path)
    r2.autotune(passes=1, reps=1)
    assert r2.tuning["cache_hit"] is False  # re-swept

    # Distinct workloads get distinct cache keys.
    r3 = DeviceStreamRunner("blur5", num_images=4, image=img,
                            use_pallas=False, tune_cache_path=path)
    r3.autotune(passes=1, reps=1)
    with open(path) as f:
        data = json.load(f)
    assert len(data["entries"]) == 2


def test_autotune_sweeps_xla_and_kernel_launches(monkeypatch, tmp_path):
    """With the kernel available, autotune times XLA and the kernel,
    keeps the faster, and each path is oracle-exact."""
    from hipe_tpu.models import pipelines as plib

    kernel = plib.pallas_blur.gaussian_blur_planar_pallas

    def interpreted(x, radius=1, **kw):
        return kernel(x, radius, **{**kw, "interpret": True})

    monkeypatch.setattr(plib.pallas_blur, "gaussian_blur_planar_pallas",
                        interpreted)
    img = checker_image(16, 24, 3, seed=5)
    r = DeviceStreamRunner("blur3", num_images=2, image=img,
                           use_pallas=True,
                           tune_cache_path=str(tmp_path / "tune.json"))
    assert r.kernel_name == "pallas-triton:gaussian3_planar"
    timings = r.autotune(passes=1, reps=1, cache=False)
    assert set(timings) == {"xla", "pallas"}
    assert r.tuning["chosen"] == min(timings, key=timings.get)
    r.set_path("pallas")
    assert r.verify_max_abs_err() == 0
    r.set_path("xla")
    assert r.verify_max_abs_err() == 0 and r.kernel_name == "xla"


def test_runner_default_routing_on_cpu():
    # The kernels compile for CUDA only: a CPU device defaults to XLA.
    img = checker_image(8, 16, 3, seed=3)
    r = DeviceStreamRunner("blur3", num_images=2, image=img)
    assert r.use_pallas is False
    assert r.path == "xla"
    res = r.measure_throughput(passes=1, reps=1)
    assert set(res) == {"per_pass_s", "img_per_s", "mpix_per_s", "gb_per_s"}


def test_stream_of_distinct_images_and_sampled_verify():
    """Slot i holds image i % K; verification samples the first, middle
    and last image, so a fault past the first image shows."""
    import jax.numpy as jnp

    imgs = np.stack([checker_image(16, 24, 3, seed=s) for s in range(3)])
    r = DeviceStreamRunner("blur3", num_images=7, image=imgs,
                           use_pallas=False)
    stream = np.asarray(r.stream).reshape(7, 3, 16, 24).transpose(0, 2, 3, 1)
    for i in range(7):
        np.testing.assert_array_equal(stream[i], imgs[i % 3])
    assert r.verify_max_abs_err() == 0

    good = r._one_pass

    def last_image_wrong(s):
        return good(s).at[-1].set(jnp.uint8(0))

    r._one_pass = last_image_wrong
    assert r.verify_max_abs_err() > 0
