"""The heterogeneous execution engine (CPU + accelerator lanes).

This is the JAX re-architecture of the reference's two host programs
(`heterogeneous_blur.c`, `split_image_blur.c`): one engine,
two partitioning strategies, three device modes. The reference pairs a CPU
OpenCL device with a GPU OpenCL device and balances them with a tunable
ratio; here the fast device is the accelerator (JAX default backend, a
GPU) and the slow device is the host CPU backend — a real heterogeneous
pair, preserving the ratio/calibration capability the reference is built
around:

- approach 1 (image-level): the first ``batch - floor(batch*ratio)`` images
  of each batch go to the CPU lane, the rest to the accelerator lane
  (`heterogeneous_blur.c:449-458,489-497`);
- approach 2 (row-split): every image is split at
  ``split_row = floor(H*(1-ratio))`` with `radius` halo rows; both lanes run
  the same slice-oblivious clamped kernel on their slab and the halo rows
  are computed-then-discarded at reassembly, generalized from the
  reference's halo=1 (`split_image_blur.c:144-173,516,526,537-539`);
- modes: 'both' | 'cpu' | 'gpu' (single-device baselines — the reference's
  missing `gaussian_blur.c` Lab-5 baseline, `heterogeneous_blur.c:52-58`).

Lanes run concurrently on worker threads (the analog of the two in-order
OpenCL command queues); with ``profile=True`` each lane stage-times
transfer-in / kernel / transfer-out with explicit synchronization — the
analog of CL_QUEUE_PROFILING_ENABLE event timing (`:201-212,544-579`).

Pure multi-chip SPMD scaling (no CPU lane) lives in
:mod:`hipe_tpu.parallel.image_level` / :mod:`hipe_tpu.parallel.row_split`.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import jax
import numpy as np

from hipe_tpu.models import pipelines as plib
from hipe_tpu.parallel import mesh as meshlib
from hipe_tpu.parallel import partitioner as pt
from hipe_tpu.profiling.events import DeviceCounters, RunStats, StageClock, now_ms
from hipe_tpu.profiling.report import render_report
from hipe_tpu.runtime import stream as streamlib


@dataclasses.dataclass
class EngineConfig:
    """CLI-visible knobs, with the reference's defaults and validation."""

    approach: int = 1
    mode: str = "both"  # 'both' | 'cpu' | 'gpu' ('tpu'/'accel': aliases)
    gpu_ratio: float = pt.DEFAULT_RATIO  # fraction of work on the accel lane
    batch_size: int = pt.DEFAULT_BATCH
    num_images: int = pt.NUM_IMAGES
    pipeline: str | Sequence[str] = "blur3"
    profile: bool = True  # stage-timed lanes (profiling queues analog)
    # 'pallas' lets a GPU lane take a pipeline's rows-layout kernel where
    # one exists (none does today: every lane runs XLA); 'xla' never does.
    accel_path: str = "pallas"
    save_output: str | None = None  # A2: save batch-0 image 0 (SAVE_IMAGE)
    trace_dir: str | None = None  # capture a jax.profiler trace of the run
    # Batches in flight per lane. 1 reproduces the reference's per-batch
    # clFinish barrier (heterogeneous_blur.c:538-539); 2+ overlaps batch
    # k+1's transfers with batch k's compute (double buffering).
    pipeline_depth: int = 1
    verbose: bool = False
    # 'static' = the reference's fixed-ratio split per batch; 'greedy' =
    # batch-level work stealing (approach 1, mode 'both'): each lane pulls
    # the next whole batch when free, so load balance adapts to measured
    # lane speed at run time (imbalance bounded by ~one batch) without any
    # ratio tuning — and without per-batch shape changes, which would
    # recompile (the full-scale corpus shows static-ratio imbalance
    # drifting to 25-60% when lane speeds shift with scale).
    scheduler: str = "static"
    # Elastic recovery (greedy scheduler only): when a lane fails mid-run
    # (e.g. an accelerator drops out), its batch is requeued and surviving
    # lanes finish the stream; the run raises only if every lane is dead
    # or the same batch fails on a second lane (data, not device, fault).
    # Off by default — the reference is fail-fast (heterogeneous_blur.c:
    # 25-30), and silent capacity loss should be an explicit opt-in.
    elastic: bool = False

    def validate(self) -> "EngineConfig":
        self.gpu_ratio = pt.validate_ratio(self.gpu_ratio)
        self.batch_size = pt.validate_batch(self.batch_size, self.num_images)
        assert self.approach in (1, 2)
        assert self.mode in ("both", "cpu", "tpu", "gpu", "accel")
        assert self.scheduler in ("static", "greedy")
        if self.mode in ("tpu", "accel"):
            self.mode = "gpu"
        if self.scheduler == "greedy" and (
            self.approach != 1 or self.mode != "both"
        ):
            # Warn-and-default, like the reference's CLI validation.
            import sys

            print(
                "Warning: greedy scheduling applies to approach 1 mode "
                "'both'; using static",
                file=sys.stderr,
            )
            self.scheduler = "static"
        if self.scheduler == "greedy" and self.pipeline_depth != 1:
            import sys

            print(
                "Warning: pipeline_depth has no effect under the greedy "
                "scheduler (lanes are self-paced); using 1",
                file=sys.stderr,
            )
            self.pipeline_depth = 1
        if self.elastic and self.scheduler != "greedy":
            import sys

            print(
                "Warning: elastic recovery requires the greedy scheduler; "
                "running fail-fast",
                file=sys.stderr,
            )
            self.elastic = False
        if self.approach == 2:
            # The reference's split-image program is inherently two-device.
            assert self.mode == "both", "approach 2 requires mode='both'"
        return self


class _Lane:
    """One device lane: transfer-in -> jitted pipeline -> transfer-out."""

    def __init__(self, name: str, device, pipeline: plib.Pipeline,
                 counters: DeviceCounters, path: str, profile: bool):
        self.name = name
        self.device = device
        self.counters = counters
        self.clock = StageClock(counters)
        self.profile = profile
        # Lanes move interleaved rows, and no pipeline has a rows-layout
        # kernel: kernel_name reports the XLA path that runs.
        use_pallas = path == "pallas" and plib.default_use_pallas(device)
        self.path = pipeline.kernel_name(use_pallas, layout="rows")
        # Device data travels in interleaved-rows layout (B, H, W*C): a free
        # host-side reshape of the interleaved RGB batch.
        self.fn = jax.jit(
            lambda rows, c: pipeline.apply_rows(
                rows, c, use_pallas=use_pallas
            ),
            static_argnums=1,
        )

    def warmup(self, shape: tuple) -> None:
        """Compile outside the wall clock (the clBuildProgram analog)."""
        b, h, w, c = shape
        rows = jax.device_put(np.zeros((b, h, w * c), np.uint8), self.device)
        np.asarray(self.fn(rows, c))

    def process(self, host_batch: np.ndarray) -> np.ndarray:
        b, h, w, c = host_batch.shape
        rows = np.asarray(host_batch).reshape(b, h, w * c)
        if self.profile:
            with self.clock.stage("in"):
                x = jax.device_put(rows, self.device)
                x.block_until_ready()
            with self.clock.stage("kernel"):
                y = self.fn(x, c)
                y.block_until_ready()
            with self.clock.stage("out"):
                return np.asarray(y).reshape(b, h, w, c)
        # Fast path: async dispatch, single sync at read-back; attribute
        # everything to the kernel counter.
        with self.clock.stage("kernel"):
            x = jax.device_put(rows, self.device)
            return np.asarray(self.fn(x, c)).reshape(b, h, w, c)


def run_greedy_lanes(
    lanes: dict[str, "_Lane"],
    stream,
    *,
    n_batches: int,
    elastic: bool = False,
    progress=None,
):
    """Batch-level work stealing over N named lanes, with optional elastic
    lane-failure recovery. Shared by the two-lane :class:`Engine` and the
    N-lane :class:`hipe_tpu.runtime.fleet.FleetEngine`.

    Each lane pulls the next whole batch when free: dynamic load balancing
    with zero shape churn (lanes keep their compiled full-batch/remainder
    shapes); the work split emerges from measured speed instead of a
    pre-tuned ratio. Final imbalance is bounded by roughly one batch per
    lane. Replaces the reference's static-ratio dispatch + manual
    calibration loop (heterogeneous_blur.c:449-497,
    README.md:87-93) with self-balancing.

    With ``elastic=True`` a failing lane's orphaned batch is requeued for
    the surviving lanes (a device fault kills one lane, not the run); a
    second failure of the same batch, or no survivors, raises.

    Returns batch 0's output (or None if another accounting path kept it).
    """
    import threading

    notify = progress or (lambda msg: None)
    # Prefetch so batch production (e.g. JPEG decode) runs in its own
    # thread; the lock below then only guards a fast queue pop instead
    # of serializing decode with the lanes' work acquisition.
    pf_iter = iter(streamlib.Prefetcher(stream, depth=2))
    it = iter(enumerate(pf_iter))
    lock = threading.Lock()
    errors: list[BaseException] = []
    retry: list[tuple] = []  # batches orphaned by a failed lane
    alive = {name: True for name in lanes}
    result: dict = {"first": None}

    def account(batch_idx: int, host_batch, out, lane: "_Lane") -> None:
        bc = host_batch.shape[0]
        lane.counters.images += bc
        lane.counters.units += bc
        if batch_idx == 0:
            result["first"] = out
        notify(f"Batch {batch_idx + 1} complete.")

    def worker(name: str, lane: "_Lane") -> None:
        while not errors:
            item = None
            try:
                with lock:
                    if retry:
                        item = retry.pop()
                    else:
                        item = next(it, None)
                if item is None:
                    return
                batch_idx, host_batch, *attempt = item
                notify(
                    f"=== Processing Batch {batch_idx + 1}/{n_batches} ==="
                )
                out = lane.process(host_batch)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                # Covers lane failures and stream-producer errors (e.g.
                # a corrupt JPEG mid-stream). Elastic mode requeues the
                # orphaned batch for surviving lanes (a device fault
                # kills one lane, not the run); a second failure of the
                # same batch means the batch itself is bad — raise.
                alive[name] = False
                second_try = bool(item) and bool(item[2:])
                if (not elastic or item is None or second_try
                        or not any(alive.values())):
                    errors.append(e)
                    return
                import sys

                print(
                    f"Warning: lane '{name}' failed "
                    f"({type(e).__name__}); redistributing its batch "
                    "to surviving lanes",
                    file=sys.stderr,
                )
                with lock:
                    retry.append((item[0], item[1], 1))
                return
            account(batch_idx, host_batch, out, lane)

    threads = [
        threading.Thread(target=worker, args=(name, lane), daemon=True)
        for name, lane in lanes.items()
    ]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        # On an error exit the producer thread would otherwise stay
        # blocked in q.put holding staged batches for the process
        # lifetime; closing the generator releases it.
        close = getattr(pf_iter, "close", None)
        if close is not None:
            close()
    if not errors and retry:
        # Every healthy lane exited before draining the requeue (e.g.
        # the failure happened as the stream ran dry): finish inline.
        survivors = [n for n, ok in alive.items() if ok]
        if not survivors:
            raise RuntimeError("all lanes failed")
        lane = lanes[survivors[0]]
        while retry:
            batch_idx, host_batch, *_ = retry.pop()
            out = lane.process(host_batch)
            account(batch_idx, host_batch, out, lane)
    if errors:
        raise errors[0]
    return result["first"]


class Engine:
    """Heterogeneous CPU+accelerator image-processing engine."""

    def __init__(self, config: EngineConfig | None = None,
                 cpu_device=None, accel_device=None, **kw):
        self.config = (config or EngineConfig(**kw)).validate()
        cfg = self.config
        self.pipeline = plib.get(cfg.pipeline)

        inv = meshlib.discover()
        if cpu_device is None and cfg.mode in ("both", "cpu"):
            cpu_device = meshlib.require_device(inv, "cpu")
        if accel_device is None and cfg.mode in ("both", "gpu"):
            # Hard-fail when the accelerator is missing, like the
            # reference's device discovery (heterogeneous_blur.c:181-184).
            accel_device = meshlib.require_device(inv, "accel")
        self.cpu_device = cpu_device
        self.accel_device = accel_device

        self.stats = RunStats(
            approach=cfg.approach, mode=cfg.mode, gpu_ratio=cfg.gpu_ratio,
            batch_size=cfg.batch_size, num_images=cfg.num_images,
            num_batches=pt.num_batches(cfg.num_images, cfg.batch_size),
            width=0, height=0, channels=0, pipeline=self.pipeline.name,
            cpu_exec="xla", accel_exec=cfg.accel_path,
        )
        self._lanes: dict[str, _Lane] = {}
        if cfg.mode in ("both", "cpu"):
            self._lanes["cpu"] = _Lane(
                "cpu", cpu_device, self.pipeline, self.stats.cpu,
                path="xla", profile=cfg.profile,
            )
        if cfg.mode in ("both", "gpu"):
            self._lanes["accel"] = _Lane(
                "accel", accel_device, self.pipeline, self.stats.accel,
                path=cfg.accel_path, profile=cfg.profile,
            )
        if "accel" in self._lanes:
            self.stats.accel_exec = self._lanes["accel"].path
        depth = max(1, self.config.pipeline_depth)
        self._pool = ThreadPoolExecutor(max_workers=2 * depth)

    def _progress(self, msg: str) -> None:
        """Per-batch progress lines (reference heterogeneous_blur.c:420,599)."""
        if self.config.verbose:
            print(msg, flush=True)

    def _drain(self, window, limit: int) -> None:
        """Wait for the oldest in-flight batch(es) beyond `limit`."""
        while len(window) > limit:
            batch_idx, futures, finalize = window.pop(0)
            outs = [f.result() for f in futures]
            if finalize is not None:
                finalize(outs)
            self._progress(f"Batch {batch_idx + 1} complete.")

    # ---- approach 1: image-level distribution ----

    def _run_approach1(self, stream) -> None:
        cfg = self.config
        depth = max(1, cfg.pipeline_depth)
        window: list = []
        for batch_idx, host_batch in enumerate(stream):
            self._progress(
                f"=== Processing Batch {batch_idx + 1}/"
                f"{self.stats.num_batches} ==="
            )
            bc = host_batch.shape[0]
            if cfg.mode == "both":
                num_cpu, num_acc = pt.split_images(bc, cfg.gpu_ratio)
            elif cfg.mode == "cpu":
                num_cpu, num_acc = bc, 0
            else:
                num_cpu, num_acc = 0, bc
            futures = []
            if num_cpu:
                lane = self._lanes["cpu"]
                futures.append(
                    self._pool.submit(lane.process, host_batch[:num_cpu])
                )
                lane.counters.images += num_cpu
                lane.counters.units += num_cpu
            if num_acc:
                lane = self._lanes["accel"]
                futures.append(
                    self._pool.submit(lane.process, host_batch[num_cpu:])
                )
                lane.counters.images += num_acc
                lane.counters.units += num_acc

            def finalize(outs, batch_idx=batch_idx):
                if batch_idx == 0:
                    # Keep batch 0's output for verification / inspection.
                    self.first_output = np.concatenate(outs, axis=0)

            window.append((batch_idx, futures, finalize))
            self._drain(window, depth - 1)
        self._drain(window, 0)

    # ---- approach 1, greedy scheduler: batch-level work stealing ----

    def _run_greedy(self, stream) -> None:
        """Each lane pulls the next whole batch when free (shared impl,
        :func:`run_greedy_lanes`)."""
        first = run_greedy_lanes(
            self._lanes, stream, n_batches=self.stats.num_batches,
            elastic=self.config.elastic, progress=self._progress,
        )
        if first is not None:
            self.first_output = first

    # ---- approach 2: split-image distribution ----

    def _run_approach2(self, stream) -> None:
        cfg = self.config
        depth = max(1, cfg.pipeline_depth)
        window: list = []
        for batch_idx, host_batch in enumerate(stream):
            self._progress(
                f"=== Processing Batch {batch_idx + 1}/"
                f"{self.stats.num_batches} ==="
            )
            bc, h, w, c = host_batch.shape
            rs = pt.row_split(h, cfg.gpu_ratio, halo=self.pipeline.radius)
            self.stats.split_row = rs.split_row
            self.stats.halo = rs.halo
            cpu_slab = host_batch[:, rs.cpu_in[0] : rs.cpu_in[1]]
            acc_slab = host_batch[:, rs.gpu_in[0] : rs.gpu_in[1]]
            futures = [
                self._pool.submit(self._lanes["cpu"].process, cpu_slab),
                self._pool.submit(self._lanes["accel"].process, acc_slab),
            ]
            self.stats.cpu.images += bc
            self.stats.accel.images += bc
            self.stats.cpu.units += bc * rs.cpu_output_rows
            self.stats.accel.units += bc * rs.gpu_output_rows

            def finalize(outs, batch_idx=batch_idx, rs=rs):
                if batch_idx != 0:
                    return
                cpu_out, acc_out = outs
                # Reassemble batch 0 (split_image_blur.c:548-553): each side
                # drops its computed-but-discarded halo rows.
                top = cpu_out[:, : rs.cpu_output_rows]
                bottom = acc_out[:, rs.gpu_out[0] - rs.gpu_in[0] :]
                self.first_output = np.concatenate([top, bottom], axis=1)
                if cfg.save_output:
                    from hipe_tpu.io_.jpeg import encode_file

                    encode_file(self.first_output[0], cfg.save_output)

            window.append((batch_idx, futures, finalize))
            self._drain(window, depth - 1)
        self._drain(window, 0)

    # ---- driver ----

    def run(self, image: np.ndarray | None = None, stream=None) -> RunStats:
        cfg = self.config
        if stream is None:
            if image is None:
                from hipe_tpu.utils.images import load_test_image

                image = load_test_image()
            stream = streamlib.ReplicatedStream(
                image, cfg.num_images, cfg.batch_size
            )
        if not hasattr(stream, "batch_shapes"):
            # One-shot iterables (generators) would be exhausted by the
            # geometry scan + warmup below; materialize once so those
            # passes and the timed loop all see the same batches.
            stream = list(stream)
        # Record geometry from the first batch shape.
        _, h, w, c = self._stream_shapes(stream)[0]
        self.stats.height, self.stats.width, self.stats.channels = h, w, c

        self._warmup(stream)
        trace_ctx = None
        if cfg.trace_dir:
            # The deep-profiling analog of the reference's event timing:
            # a full XLA device trace viewable in TensorBoard/Perfetto.
            import jax.profiler

            trace_ctx = jax.profiler.trace(cfg.trace_dir)
            trace_ctx.__enter__()
        t0 = now_ms()
        try:
            if cfg.approach == 1 and cfg.scheduler == "greedy":
                self._run_greedy(stream)
            elif cfg.approach == 1:
                self._run_approach1(stream)
            else:
                self._run_approach2(stream)
        finally:
            self.stats.wall_ms = now_ms() - t0
            if trace_ctx is not None:
                trace_ctx.__exit__(None, None, None)
        return self.stats

    @staticmethod
    def _stream_shapes(stream) -> list[tuple]:
        """Batch shapes, preferring the cheap path (no decode/materialize)."""
        if hasattr(stream, "batch_shapes"):
            return stream.batch_shapes()
        return [b.shape for b in stream]

    def _warmup(self, stream) -> None:
        """Compile every (lane, shape) pair before the wall clock starts."""
        cfg = self.config
        shapes = set(self._stream_shapes(stream))
        lane_shapes: set[tuple[str, tuple]] = set()
        for shape in shapes:
            bc, h, w, c = shape
            if cfg.approach == 1 and cfg.scheduler == "greedy":
                # Any lane may take any batch (incl. the remainder batch).
                for lane_name in self._lanes:
                    lane_shapes.add((lane_name, (bc, h, w, c)))
            elif cfg.approach == 1:
                if cfg.mode == "both":
                    num_cpu, num_acc = pt.split_images(bc, cfg.gpu_ratio)
                elif cfg.mode == "cpu":
                    num_cpu, num_acc = bc, 0
                else:
                    num_cpu, num_acc = 0, bc
                if num_cpu:
                    lane_shapes.add(("cpu", (num_cpu, h, w, c)))
                if num_acc:
                    lane_shapes.add(("accel", (num_acc, h, w, c)))
            else:
                rs = pt.row_split(h, cfg.gpu_ratio, halo=self.pipeline.radius)
                lane_shapes.add(("cpu", (bc, rs.cpu_input_rows, w, c)))
                lane_shapes.add(("accel", (bc, rs.gpu_input_rows, w, c)))
        for lane_name, shape in sorted(lane_shapes):
            self._lanes[lane_name].warmup(shape)

    def report(self, accel_name: str | None = None) -> str:
        if accel_name is None:
            dev = self.accel_device
            accel_name = (
                getattr(dev, "platform", "gpu").upper() if dev else "GPU"
            )
        return render_report(self.stats, accel_name=accel_name)
