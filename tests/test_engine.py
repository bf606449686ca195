"""Heterogeneous engine end-to-end on two virtual CPU devices.

The reference validated heterogeneity with two OpenCL devices in one machine
(SURVEY.md §4); here two virtual host devices play the CPU/accelerator pair.
Correctness (outputs match the oracle) is checked via verify streams, and the
accounting/report contract is checked against the partitioner math.
"""

import numpy as np
import pytest

import jax

from hipe_tpu.ops import reference as oracle
from hipe_tpu.profiling.report import render_report, to_csv_row
from hipe_tpu.runtime.engine import Engine, EngineConfig
from hipe_tpu.utils.images import checker_image

# Header of the reference corpus's data/approach2/approach2/per_run.csv
# (the reference checkout is not part of this repository).
REFERENCE_PER_RUN_HEADER = (
    "batch_size_file,run,file,mode,gpu_ratio_cfg,cpu_ratio_cfg,images,"
    "batches,img_w,img_h,wg_w,wg_h,wall_ms,cpu_images,cpu_total_ms,"
    "cpu_in_ms,cpu_kernel_ms,cpu_out_ms,cpu_ms_per_img,gpu_images,"
    "gpu_total_ms,gpu_in_ms,gpu_kernel_ms,gpu_out_ms,gpu_ms_per_img,"
    "speedup_gpu_vs_cpu,imbalance_pct,bottleneck,bottleneck_delta_ms,"
    "mpix_per_sec,img_per_sec,recommended_gpu_ratio,batch_size_log"
).split(",")


def _devices():
    devs = jax.devices("cpu")
    return devs[0], devs[1]


def _engine(**kw):
    cpu, accel = _devices()
    cfg = EngineConfig(**kw)
    return Engine(cfg, cpu_device=cpu, accel_device=accel)


IMG = checker_image(24, 32, 3, seed=42)


def test_approach1_both_accounting():
    eng = _engine(approach=1, mode="both", gpu_ratio=0.728, batch_size=35,
                  num_images=200)
    stats = eng.run(image=IMG)
    assert stats.cpu.images + stats.accel.images == 200
    # per-batch floor split: 35*0.728 -> 25 accel / 10 cpu; last batch 25
    # images -> 18 accel / 7 cpu
    assert stats.accel.images == 25 * 5 + 18
    assert stats.wall_ms > 0
    assert stats.cpu.total_ms > 0 and stats.accel.total_ms > 0


@pytest.mark.parametrize("mode", ["cpu", "gpu", "tpu"])
def test_approach1_single_device(mode):
    eng = _engine(approach=1, mode=mode, batch_size=16, num_images=32)
    stats = eng.run(image=IMG)
    active = stats.cpu if mode == "cpu" else stats.accel
    idle = stats.accel if mode == "cpu" else stats.cpu
    assert active.images == 32 and idle.images == 0


def test_approach2_split_accounting():
    eng = _engine(approach=2, mode="both", gpu_ratio=0.837, batch_size=10,
                  num_images=30)
    stats = eng.run(image=checker_image(240, 32, 3, seed=1))
    # split_row = floor(240*0.163) = 39 (matches 2_35_run_1.txt geometry)
    assert stats.split_row == 39
    assert stats.cpu.images == 30 and stats.accel.images == 30
    assert stats.cpu.units == 30 * 39
    assert stats.accel.units == 30 * 201


def test_approach2_output_correct(tmp_path):
    """Reassembled split output == oracle blur bit-exact (seam exactness e2e),
    and the SAVE_IMAGE analog writes a decodable JPEG of the right shape."""
    out_path = str(tmp_path / "split_output.jpg")
    img = checker_image(64, 48, 3, seed=5)
    eng = _engine(approach=2, mode="both", gpu_ratio=0.5, batch_size=4,
                  num_images=8, save_output=out_path)
    eng.run(image=img)
    want = oracle.gaussian_blur_int_oracle(img)
    np.testing.assert_array_equal(eng.first_output[0], want)
    from hipe_tpu.io_.jpeg import decode_file

    assert decode_file(out_path).shape == want.shape


def test_approach1_output_correct():
    img = checker_image(24, 32, 3, seed=6)
    eng = _engine(approach=1, mode="both", gpu_ratio=0.6, batch_size=8,
                  num_images=16)
    eng.run(image=img)
    want = oracle.gaussian_blur_int_oracle(img)
    assert eng.first_output.shape == (8,) + want.shape
    for i in range(8):
        np.testing.assert_array_equal(eng.first_output[i], want)


def test_approach2_chain_pipeline():
    img = checker_image(32, 48, 3, seed=2)
    eng = _engine(approach=2, mode="both", gpu_ratio=0.5, batch_size=4,
                  num_images=8, pipeline="chain")
    stats = eng.run(image=img)
    assert stats.halo == 3  # blur(1) + sharpen(1) + edge(1)
    # compute-then-discard slab semantics stay exact for chains
    want = oracle.sobel_edge_oracle(
        oracle.sharpen3x3_oracle(oracle.gaussian_blur_int_oracle(img))
    )
    np.testing.assert_array_equal(eng.first_output[0], want)


def test_report_renders_all_sections():
    eng = _engine(approach=1, mode="both", gpu_ratio=0.5, batch_size=16,
                  num_images=32)
    stats = eng.run(image=IMG)
    text = render_report(stats, accel_name="GPU")
    for section in ["1. OVERALL", "2. CPU DEVICE", "3. GPU DEVICE",
                    "4. DEVICE COMPARISON", "5. WORKLOAD BALANCE",
                    "6. BOTTLENECK", "7. THROUGHPUT",
                    "8. OPTIMAL RATIO RECOMMENDATION"]:
        assert section in text, section


def test_csv_row_schema():
    eng = _engine(approach=1, mode="both", batch_size=16, num_images=32)
    stats = eng.run(image=IMG)
    row = to_csv_row(stats, run=1)
    from hipe_tpu.profiling.report import CSV_COLUMNS

    assert list(row.keys()) == CSV_COLUMNS
    assert row["images"] == 32
    assert row["img_per_sec"] > 0
    # The work-group columns carry the per-lane execution config (the
    # analog of the reference's 16x16 local size) — never blank.
    assert row["wg_w"] == "xla"  # cpu lane
    assert row["wg_h"]  # accel lane path label


def test_invalid_config_falls_back():
    eng = _engine(approach=1, mode="both", gpu_ratio=7.0, batch_size=-3,
                  num_images=16)
    assert eng.config.gpu_ratio == 0.5
    assert eng.config.batch_size == 500


def test_verify_outputs_against_oracle():
    """Both lanes produce oracle-exact pixels (checked via direct lane use)."""
    eng = _engine(approach=1, mode="both", gpu_ratio=0.5, batch_size=8,
                  num_images=8)
    batch = np.stack([checker_image(24, 32, 3, seed=s) for s in range(8)])
    out_cpu = eng._lanes["cpu"].process(batch[:4])
    out_acc = eng._lanes["accel"].process(batch[4:])
    want = np.stack([oracle.gaussian_blur_int_oracle(b) for b in batch])
    np.testing.assert_array_equal(out_cpu, want[:4])
    np.testing.assert_array_equal(out_acc, want[4:])


def test_csv_schema_matches_reference_header():
    """Our CSV contract == the reference corpus header, column for column."""
    from hipe_tpu.profiling.report import CSV_COLUMNS

    assert CSV_COLUMNS == REFERENCE_PER_RUN_HEADER


def test_approach2_mixed_resolution_stream():
    """A2 handles per-batch geometry changes (mixed-resolution stream)."""
    from hipe_tpu.runtime.stream import MixedResolutionStream

    a = checker_image(32, 24, 3, seed=0)
    b = checker_image(48, 40, 3, seed=1)
    eng = _engine(approach=2, mode="both", gpu_ratio=0.5, batch_size=4,
                  num_images=12)
    stream = MixedResolutionStream([a, b], 12, 4)
    stats = eng.run(stream=stream)
    assert stats.cpu.images == 12 and stats.accel.images == 12
    # first batch (image a) reassembles exactly
    want = oracle.gaussian_blur_int_oracle(a)
    np.testing.assert_array_equal(eng.first_output[0], want)


@pytest.mark.parametrize("approach", [1, 2])
def test_pipelined_depth2_equivalent(approach):
    """pipeline_depth=2 keeps accounting and outputs identical to depth=1."""
    img = checker_image(32, 48, 3, seed=8)
    kw = dict(approach=approach, mode="both", gpu_ratio=0.5, batch_size=4,
              num_images=16)
    eng1 = _engine(**kw)
    eng2 = _engine(**kw, pipeline_depth=2)
    s1 = eng1.run(image=img)
    s2 = eng2.run(image=img)
    assert (s1.cpu.images, s1.accel.images, s1.cpu.units, s1.accel.units) == \
           (s2.cpu.images, s2.accel.images, s2.cpu.units, s2.accel.units)
    np.testing.assert_array_equal(eng1.first_output, eng2.first_output)
    want = oracle.gaussian_blur_int_oracle(img)
    np.testing.assert_array_equal(eng2.first_output[0], want)


def test_greedy_scheduler_processes_all_and_exact():
    """Work-stealing scheduler: full coverage, exact output, ~1-batch skew."""
    import jax

    from hipe_tpu.ops import reference as oracle
    from hipe_tpu.runtime.engine import Engine, EngineConfig
    from hipe_tpu.utils.images import checker_image

    devs = jax.devices("cpu")
    img = checker_image(24, 32, 3, seed=5)
    cfg = EngineConfig(approach=1, mode="both", batch_size=4, num_images=18,
                       scheduler="greedy", accel_path="xla")
    eng = Engine(cfg, cpu_device=devs[0], accel_device=devs[1])
    stats = eng.run(image=img)
    assert stats.cpu.images + stats.accel.images == 18
    assert stats.cpu.units + stats.accel.units == 18
    # batch 0's output was captured by whichever lane took it
    want = oracle.gaussian_blur_int_oracle(img)
    np.testing.assert_array_equal(eng.first_output[0], want)
    assert "PERFORMANCE RESULTS" in eng.report()


def test_greedy_scheduler_warns_and_defaults_off_contract():
    from hipe_tpu.runtime.engine import EngineConfig

    cfg = EngineConfig(approach=2, mode="both", scheduler="greedy").validate()
    assert cfg.scheduler == "static"
    cfg = EngineConfig(approach=1, mode="cpu", scheduler="greedy").validate()
    assert cfg.scheduler == "static"


def test_greedy_scheduler_raises_on_stream_error():
    """A mid-stream producer error must raise, not truncate silently."""
    import jax
    import pytest

    from hipe_tpu.runtime.engine import Engine, EngineConfig
    from hipe_tpu.runtime.stream import ReplicatedStream
    from hipe_tpu.utils.images import checker_image

    img = checker_image(16, 16, 3, seed=1)

    class FailingStream:
        num_images = 12

        def __iter__(self):
            yield from ReplicatedStream(img, 4, 4)
            raise ValueError("corrupt JPEG mid-stream")

        def batch_shapes(self):
            return ReplicatedStream(img, 12, 4).batch_shapes()

    devs = jax.devices("cpu")
    cfg = EngineConfig(approach=1, mode="both", batch_size=4, num_images=12,
                       scheduler="greedy", accel_path="xla")
    eng = Engine(cfg, cpu_device=devs[0], accel_device=devs[1])
    with pytest.raises(ValueError, match="corrupt JPEG"):
        eng.run(stream=FailingStream())


def test_greedy_scheduler_depth_warns_and_defaults():
    from hipe_tpu.runtime.engine import EngineConfig

    cfg = EngineConfig(approach=1, mode="both", scheduler="greedy",
                       pipeline_depth=2).validate()
    assert cfg.pipeline_depth == 1
