"""Failure handling: fail-fast discovery, missing codec (SURVEY.md §5)."""

import pytest

from hipe_tpu.io_ import jpeg
from hipe_tpu.runtime.engine import Engine, EngineConfig
from hipe_tpu.utils.images import checker_image


def test_engine_fails_fast_without_accelerator(monkeypatch):
    """mode='both' with no accelerator aborts, like the reference's
    discovery hard-fail (heterogeneous_blur.c:181-184)."""
    from hipe_tpu.parallel import mesh as meshlib

    monkeypatch.setattr(
        meshlib,
        "discover",
        lambda: meshlib.DeviceInventory(
            cpu_devices=meshlib.discover.__wrapped__()
            if hasattr(meshlib.discover, "__wrapped__")
            else [],
            accel_devices=[],
            accel_platform=None,
        ),
    )
    # re-import to pick up the patched discover used inside Engine.__init__
    import jax

    cpu = jax.devices("cpu")[0]
    with pytest.raises(RuntimeError, match="no accel device"):
        Engine(EngineConfig(mode="both"), cpu_device=cpu)


def test_jpeg_pil_fallback(monkeypatch):
    """With the native codec unavailable there is no PIL fallback: every
    JPEG entry point raises one clear error naming what is missing."""
    img = checker_image(16, 16, 3, seed=0)
    payload = jpeg.encode_bytes(img, quality=95)
    monkeypatch.setattr(jpeg, "_load", lambda: None)
    for call in (lambda: jpeg.encode_bytes(img, quality=95),
                 lambda: jpeg.decode_bytes(payload),
                 lambda: jpeg.decode_batch([payload] * 3)):
        with pytest.raises(RuntimeError, match="libjpeg"):
            call()


def test_approach2_rejects_single_device_mode():
    with pytest.raises(AssertionError, match="approach 2"):
        EngineConfig(approach=2, mode="cpu").validate()


def _flaky_engine(elastic, *, both_lanes=False):
    import time

    import jax

    from hipe_tpu.runtime.engine import Engine, EngineConfig

    devs = jax.devices("cpu")
    cfg = EngineConfig(approach=1, mode="both", batch_size=4, num_images=20,
                       scheduler="greedy", accel_path="xla", elastic=elastic)
    eng = Engine(cfg, cpu_device=devs[0], accel_device=devs[1])

    def make_flaky(lane):
        def flaky(batch):
            # Fail on the lane's first batch so the path always exercises.
            raise RuntimeError("device lost")

        lane.process = flaky

    make_flaky(eng._lanes["accel"])
    if both_lanes:
        make_flaky(eng._lanes["cpu"])
    else:
        # Slow the healthy lane slightly so the flaky lane reliably pulls
        # at least one batch regardless of thread-start timing.
        orig = eng._lanes["cpu"].process

        def slow(batch):
            time.sleep(0.01)
            return orig(batch)

        eng._lanes["cpu"].process = slow
    return eng


def test_greedy_elastic_survives_lane_failure():
    """A lane dying mid-run redistributes its batch; the run completes."""
    from hipe_tpu.utils.images import checker_image

    eng = _flaky_engine(elastic=True)
    stats = eng.run(image=checker_image(16, 16, 3, seed=3))
    assert stats.cpu.images + stats.accel.images == 20
    assert hasattr(eng, "first_output")
    # The dead lane's aborted attempt must not pollute the timing report
    # (ratios would be computed from a batch that produced no output).
    assert stats.accel.images == 0 and stats.accel.total_ms == 0.0


def test_greedy_fail_fast_without_elastic():
    # Both lanes flaky: whichever thread pulls first raises — no
    # dependence on thread scheduling.
    import pytest

    from hipe_tpu.utils.images import checker_image

    eng = _flaky_engine(elastic=False, both_lanes=True)
    with pytest.raises(RuntimeError, match="device lost"):
        eng.run(image=checker_image(16, 16, 3, seed=3))


def test_elastic_without_greedy_warns_and_defaults():
    from hipe_tpu.runtime.engine import EngineConfig

    cfg = EngineConfig(approach=1, mode="both", elastic=True).validate()
    assert cfg.elastic is False
