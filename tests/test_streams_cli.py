"""Input streams and the CLI smoke path."""

import numpy as np
import pytest

from hipe_tpu.io_.jpeg import encode_bytes
from hipe_tpu.runtime.stream import (
    JpegStream,
    MixedResolutionStream,
    ReplicatedStream,
    batch_sizes,
)
from hipe_tpu.utils.images import (REFERENCE_256, REFERENCE_320,
                                   checker_image, seeded_image)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Seeded JPEG files at the reference assets' two geometries."""
    from hipe_tpu.io_.jpeg import encode_file

    d = tmp_path_factory.mktemp("assets")
    out = {}
    for key, size in (("256", REFERENCE_256), ("320", REFERENCE_320)):
        path = str(d / f"image_{size[1]}x{size[0]}.jpg")
        encode_file(seeded_image(*size, seed=int(key)), path, quality=90)
        out[key] = path
    return out


def test_batch_sizes_remainder():
    assert batch_sizes(5000, 35) == [35] * 142 + [30]
    assert batch_sizes(10, 4) == [4, 4, 2]


def test_replicated_stream():
    img = checker_image(8, 8, 3)
    batches = list(ReplicatedStream(img, 10, 4))
    assert [b.shape[0] for b in batches] == [4, 4, 2]
    np.testing.assert_array_equal(batches[0][3], img)


def test_jpeg_stream_decodes():
    img = checker_image(16, 16, 3, seed=2)
    payload = encode_bytes(img, quality=95)
    batches = list(JpegStream([payload] * 5, batch_size=2))
    assert [b.shape for b in batches] == [(2, 16, 16, 3)] * 2 + [(1, 16, 16, 3)]


def test_mixed_resolution_stream():
    a = checker_image(8, 8, 3, seed=0)
    b = checker_image(12, 16, 3, seed=1)
    shapes = [x.shape for x in MixedResolutionStream([a, b], 10, 3)]
    assert shapes == [(3, 8, 8, 3), (3, 12, 16, 3), (3, 8, 8, 3),
                      (1, 12, 16, 3)]


def test_cli_smoke(tmp_path, capsys):
    """Full CLI run on the virtual device pair with CSV output."""
    import jax

    if len(jax.devices("cpu")) < 2:
        import pytest

        pytest.skip("needs 2 virtual devices")
    # monkeypatch discovery to use two cpu devices as the hetero pair
    from hipe_tpu import cli
    from hipe_tpu.parallel import mesh as meshlib

    devs = jax.devices("cpu")
    orig = meshlib.discover

    def fake_discover():
        return meshlib.DeviceInventory(
            cpu_devices=[devs[0]], accel_devices=[devs[1]],
            accel_platform="cpu",
        )

    meshlib.discover = fake_discover
    try:
        csv_path = str(tmp_path / "run.csv")
        rc = cli.main([
            "approach1", "both", "0.5", "8", "--num-images", "16",
            "--accel-path", "xla", "--csv", csv_path,
        ])
    finally:
        meshlib.discover = orig
    assert rc == 0
    out = capsys.readouterr().out
    assert "PERFORMANCE RESULTS" in out
    assert "8. OPTIMAL RATIO RECOMMENDATION" in out
    import csv as csvlib

    with open(csv_path) as f:
        rows = list(csvlib.DictReader(f))
    assert len(rows) == 1 and rows[0]["images"] == "16"


def test_cli_mixed_resolution_smoke(capsys, assets):
    """Mixed-resolution stream through the CLI (BASELINE config 5)."""
    import jax

    from hipe_tpu import cli
    from hipe_tpu.parallel import mesh as meshlib

    devs = jax.devices("cpu")
    orig = meshlib.discover
    meshlib.discover = lambda: meshlib.DeviceInventory(
        cpu_devices=[devs[0]], accel_devices=[devs[1]], accel_platform="cpu"
    )
    try:
        rc = cli.main([
            "approach1", "both", "0.5", "8", "--num-images", "24",
            "--image", f"{assets['256']},{assets['320']}",
            "--accel-path", "xla",
        ])
    finally:
        meshlib.discover = orig
    assert rc == 0
    out = capsys.readouterr().out
    assert "256x256" in out and "320x240" in out
    assert "PERFORMANCE RESULTS" in out


def test_prefetcher_preserves_stream():
    from hipe_tpu.runtime.stream import Prefetcher, ReplicatedStream

    img = checker_image(8, 8, 3)
    base = list(ReplicatedStream(img, 10, 4))
    pre = Prefetcher(ReplicatedStream(img, 10, 4), depth=2)
    got = list(pre)
    assert len(got) == len(base)
    for a, b in zip(got, base):
        np.testing.assert_array_equal(a, b)
    # re-iterable
    assert len(list(pre)) == len(base)


def test_engine_with_prefetched_jpeg_stream():
    import jax

    from hipe_tpu.runtime.engine import Engine, EngineConfig
    from hipe_tpu.runtime.stream import JpegStream, Prefetcher

    devs = jax.devices("cpu")
    img = checker_image(24, 32, 3, seed=5)
    payloads = [encode_bytes(img, quality=95)] * 12
    eng = Engine(
        EngineConfig(approach=1, mode="both", gpu_ratio=0.5, batch_size=4,
                     num_images=12),
        cpu_device=devs[0], accel_device=devs[1],
    )
    stats = eng.run(stream=Prefetcher(JpegStream(payloads, batch_size=4)))
    assert stats.cpu.images + stats.accel.images == 12


def test_engine_trace_capture(tmp_path):
    import jax

    from hipe_tpu.runtime.engine import Engine, EngineConfig

    devs = jax.devices("cpu")
    trace_dir = str(tmp_path / "trace")
    eng = Engine(
        EngineConfig(approach=1, mode="both", batch_size=4, num_images=8,
                     trace_dir=trace_dir),
        cpu_device=devs[0], accel_device=devs[1],
    )
    eng.run(image=checker_image(16, 16, 3))
    import os

    assert os.path.isdir(trace_dir) and os.listdir(trace_dir)


def test_prefetcher_propagates_producer_errors():
    """A mid-stream decode failure must raise, not truncate the stream."""
    from hipe_tpu.runtime.stream import Prefetcher, ReplicatedStream

    img = checker_image(8, 8, 3)

    class FailingStream:
        def __iter__(self):
            yield from ReplicatedStream(img, 8, 4)
            raise ValueError("corrupt JPEG")

    pre = Prefetcher(FailingStream(), depth=2)
    it = iter(pre)
    got = [next(it), next(it)]
    assert len(got) == 2
    import pytest

    with pytest.raises(ValueError, match="corrupt JPEG"):
        next(it)


def test_engine_verbose_progress_lines(capsys):
    """Per-batch progress lines (reference heterogeneous_blur.c:420,599)."""
    import jax

    from hipe_tpu.runtime.engine import Engine, EngineConfig

    dev = jax.devices("cpu")[0]
    cfg = EngineConfig(approach=1, mode="cpu", batch_size=6, num_images=13,
                       verbose=True)
    eng = Engine(cfg, cpu_device=dev)
    eng.run(image=checker_image(16, 16, 3))
    out = capsys.readouterr().out
    assert "=== Processing Batch 1/3 ===" in out
    assert "=== Processing Batch 3/3 ===" in out
    assert "Batch 3 complete." in out

    # verbose=False keeps stdout clean
    cfg = EngineConfig(approach=1, mode="cpu", batch_size=6, num_images=13,
                       verbose=False)
    eng = Engine(cfg, cpu_device=dev)
    eng.run(image=checker_image(16, 16, 3))
    out = capsys.readouterr().out
    assert "Processing Batch" not in out and "complete." not in out


def test_cli_stream_mode(capsys):
    """Device-resident stream subcommand (runs on the CPU backend here)."""
    from hipe_tpu import cli

    rc = cli.main([
        "stream", "blur3", "--num-images", "8", "--passes", "2",
        "--no-autotune", "--json",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "DEVICE-STREAM RESULTS" in out
    assert "Max-abs error vs oracle: 0" in out
    import json as jsonlib

    last = out.strip().splitlines()[-1]
    payload = jsonlib.loads(last)
    assert payload["max_abs_err"] == 0 and payload["num_images"] == 8


def test_cli_stream_unknown_pipeline():
    from hipe_tpu import cli

    assert cli.main(["stream", "nosuch", "--num-images", "4"]) == 1


def test_cli_serve_mode(capsys):
    """Serving subcommand, host-decode and device-decode variants."""
    import json as jsonlib

    from hipe_tpu import cli

    for extra in ([], ["--decode-on-device"],
                  ["--decode-on-device", "--encode-on-device"]):
        encode_args = ["--no-encode"] if not extra else []
        rc = cli.main([
            "serve", "blur3", "--num-images", "6", "--batch-size", "4",
            "--quality", "85", *encode_args, "--json",
            *extra,
        ])
        assert rc == 0
        out = capsys.readouterr().out
        assert "SERVING RESULTS" in out
        payload = jsonlib.loads(out.strip().splitlines()[-1])
        assert payload["num_images"] == 6
        assert payload["decode_on_device"] == ("--decode-on-device" in extra)
        assert payload["encode_on_device"] == ("--encode-on-device" in extra)
        assert payload["img_per_s"] > 0


def test_cli_serve_unknown_pipeline():
    from hipe_tpu import cli

    assert cli.main(["serve", "nosuch", "--num-images", "4"]) == 1


def test_cli_serve_mixed_resolution_all_modes(capsys, assets):
    """Mixed --image a,b streams: uniform batches per source, every codec
    placement works (interleaving sizes within one batch crashed the
    host-decode path before the per-batch cycling fix)."""
    from hipe_tpu import cli

    imgs = f"{assets['256']},{assets['320']}"
    for extra in ([], ["--decode-on-device"],
                  ["--decode-on-device", "--encode-on-device"],
                  ["--no-encode"]):
        rc = cli.main([
            "serve", "blur3", "--num-images", "8", "--batch-size", "4",
            "--image", imgs, *extra,
        ])
        capsys.readouterr()
        assert rc == 0, extra


def test_cli_serve_thumbnail(capsys):
    """--thumbnail emits decodable half-size JPEGs."""
    from hipe_tpu import cli

    rc = cli.main([
        "serve", "blur3", "--num-images", "4", "--batch-size", "2",
        "--thumbnail", "--json",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "half-size thumbnails" in out


def test_cli_serve_decode_scale(capsys):
    """--decode-scale runs the whole pipeline at 1/N resolution."""
    from hipe_tpu import cli

    rc = cli.main([
        "serve", "blur3", "--num-images", "4", "--batch-size", "2",
        "--decode-scale", "4", "--decode-on-device", "--json",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Decode scale: 1/4" in out


def test_cli_transform_mode(tmp_path, capsys, assets):
    """Lossless transform subcommand: success, clean error paths."""
    from hipe_tpu import cli

    out = str(tmp_path / "rot.jpg")
    rc = cli.main(["transform", assets["320"],
                   "rot90", "-o", out])
    assert rc == 0
    text = capsys.readouterr().out
    assert "lossless" in text
    from hipe_tpu.io_ import jpeg

    assert jpeg.decode_bytes(open(out, "rb").read()).shape == (320, 240, 3)
    # Missing input: one clean Error line, exit 1.
    rc = cli.main(["transform", "/nonexistent.jpg", "rot90", "-o", out])
    assert rc == 1
    assert capsys.readouterr().out.startswith("Error:")
    # Imperfect geometry (320x240 not an iMCU multiple after... width 320
    # IS a multiple; craft a 33-wide file to refuse flip_h).
    import numpy as np

    bad = str(tmp_path / "bad.jpg")
    rng = np.random.default_rng(0)
    jpeg.encode_file(rng.integers(0, 256, (32, 33, 3), dtype=np.uint8), bad)
    rc = cli.main(["transform", bad, "flip_h", "-o", out])
    assert rc == 1
    assert "not lossless" in capsys.readouterr().out
