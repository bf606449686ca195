"""N-lane heterogeneous fleet executor.

The reference pairs exactly two devices (CPU + GPU OpenCL) and balances
them with one ratio. This module generalizes that capability to arbitrary
device fleets — any mix of host-CPU and accelerator devices, each lane
weighted by its work share — while keeping the reference's semantics:

- approach 1: images apportioned to lanes by weight (largest-remainder
  generalization of `heterogeneous_blur.c:449-458`);
- approach 2: image rows partitioned by cumulative weight with per-side
  halo slabs, computed-then-discarded at reassembly
  (`split_image_blur.c:144-173` generalized to N segments);
- measured-feedback balancing: `weights_i ∝ 1/t_i` per work unit, which
  reduces to the reference's `ratio* = T_cpu/(T_cpu+T_gpu)` for two lanes;
- greedy scheduling (approach 1): batch-level work stealing across all N
  lanes with optional elastic lane-failure recovery, sharing the two-lane
  engine's implementation (`engine.run_greedy_lanes`).

The two-lane :class:`hipe_tpu.runtime.engine.Engine` remains the
reference-parity implementation (exact CLI/report contract); FleetEngine is
the scale-out form.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from hipe_tpu.models import pipelines as plib
from hipe_tpu.parallel import partitioner as pt
from hipe_tpu.profiling.events import DeviceCounters, now_ms
from hipe_tpu.runtime import stream as streamlib
from hipe_tpu.runtime.engine import _Lane


@dataclasses.dataclass
class LaneSpec:
    device: object
    weight: float = 1.0
    name: str = ""
    path: str = "auto"  # 'auto': the GPU kernel on CUDA lanes, else XLA


@dataclasses.dataclass
class FleetStats:
    approach: int
    batch_size: int
    num_images: int
    width: int = 0
    height: int = 0
    channels: int = 0
    wall_ms: float = 0.0
    lanes: list[DeviceCounters] = dataclasses.field(default_factory=list)

    @property
    def images_per_sec(self) -> float:
        return self.num_images / (self.wall_ms / 1000.0) if self.wall_ms else 0.0

    def imbalance_pct(self) -> float:
        totals = [c.total_ms for c in self.lanes if c.units]
        if not totals or max(totals) <= 0:
            return 0.0
        return (max(totals) - min(totals)) / max(totals) * 100.0

    def recommended_weights(self) -> list[float]:
        """Inverse-per-unit-time weights over the lanes that measured.

        Lanes that processed nothing (weight 0, or starved by the greedy
        scheduler on a short stream) have no measurement; they get 0.0
        rather than letting the old t<=0 guard collapse EVERY lane to
        uniform and discard the real measurements.
        """
        times = [c.per_unit_ms() for c in self.lanes]
        measured = [t for t in times if t > 0]
        if not measured:
            return pt.recommend_weights(times)
        rec = iter(pt.recommend_weights(measured))
        return [next(rec) if t > 0 else 0.0 for t in times]


class FleetEngine:
    """Weighted N-lane heterogeneous executor."""

    def __init__(
        self,
        lanes: Sequence[LaneSpec],
        *,
        pipeline: str | Sequence[str] = "blur3",
        approach: int = 1,
        batch_size: int = pt.DEFAULT_BATCH,
        num_images: int = pt.NUM_IMAGES,
        profile: bool = True,
        pipeline_depth: int = 1,
        scheduler: str = "static",
        elastic: bool = False,
    ):
        assert lanes, "need at least one lane"
        assert approach in (1, 2)
        assert scheduler in ("static", "greedy")
        if scheduler == "greedy" and approach != 1:
            import sys

            print(
                "Warning: greedy scheduling applies to approach 1 only "
                "(approach 2 sends every image to every lane); using "
                "static",
                file=sys.stderr,
            )
            scheduler = "static"
        if elastic and scheduler != "greedy":
            import sys

            print(
                "Warning: elastic recovery requires the greedy scheduler; "
                "disabling",
                file=sys.stderr,
            )
            elastic = False
        self.scheduler = scheduler
        self.elastic = elastic
        self._specs = list(lanes)
        self.approach = approach
        self.batch_size = pt.validate_batch(batch_size, num_images)
        self.num_images = num_images
        self.pipeline = plib.get(pipeline)
        self.weights = [spec.weight for spec in lanes]
        self.stats = FleetStats(
            approach=approach, batch_size=self.batch_size,
            num_images=num_images,
        )
        self._lanes: list[_Lane] = []
        for i, spec in enumerate(lanes):
            counters = DeviceCounters(spec.name or f"lane{i}")
            self.stats.lanes.append(counters)
            # 'auto' == 'pallas': the lane itself keeps the GPU kernel to
            # CUDA devices and runs XLA everywhere else.
            path = "xla" if spec.path == "xla" else "pallas"
            self._lanes.append(
                _Lane(counters.name, spec.device, self.pipeline, counters,
                      path=path, profile=profile)
            )
        self.pipeline_depth = max(1, pipeline_depth)
        self._pool = ThreadPoolExecutor(
            max_workers=len(self._lanes) * self.pipeline_depth
        )

    def _drain(self, window: list, limit: int) -> None:
        while len(window) > limit:
            futures, finalize = window.pop(0)
            outs = [f.result() for f in futures]
            if finalize is not None:
                finalize(outs)

    # ---- drivers ----

    def run(self, image: np.ndarray | None = None, stream=None) -> FleetStats:
        if stream is None:
            assert image is not None
            stream = streamlib.ReplicatedStream(
                image, self.num_images, self.batch_size
            )
        from hipe_tpu.runtime.engine import Engine

        if not hasattr(stream, "batch_shapes"):
            # One-shot iterables would be exhausted by the geometry scan
            # + warmup; materialize once (same contract as Engine.run).
            stream = list(stream)
        _, h, w, c = Engine._stream_shapes(stream)[0]
        self.stats.height, self.stats.width, self.stats.channels = h, w, c
        self._warmup(stream)
        t0 = now_ms()
        if self.approach == 1 and self.scheduler == "greedy":
            self._run_greedy(stream)
        elif self.approach == 1:
            self._run_images(stream)
        else:
            self._run_rows(stream)
        self.stats.wall_ms = now_ms() - t0
        return self.stats

    def _run_greedy(self, stream) -> None:
        """N-lane batch-level work stealing (+ elastic lane recovery)."""
        from hipe_tpu.runtime.engine import run_greedy_lanes

        lanes = {lane.counters.name: lane for lane in self._lanes}
        assert len(lanes) == len(self._lanes), "lane names must be unique"
        first = run_greedy_lanes(
            lanes, stream,
            n_batches=pt.num_batches(self.num_images, self.batch_size),
            elastic=self.elastic,
        )
        if first is not None:
            self.first_output = first

    def _split_counts(self, bc: int) -> list[int]:
        return pt.apportion(bc, self.weights)

    def _run_images(self, stream) -> None:
        window: list = []
        for batch_idx, host_batch in enumerate(stream):
            counts = self._split_counts(host_batch.shape[0])
            futures, start = [], 0
            for lane, cnt, counters in zip(
                self._lanes, counts, self.stats.lanes
            ):
                if not cnt:
                    continue
                futures.append(
                    self._pool.submit(lane.process,
                                      host_batch[start : start + cnt])
                )
                counters.images += cnt
                counters.units += cnt
                start += cnt

            def finalize(outs, batch_idx=batch_idx):
                if batch_idx == 0:
                    self.first_output = np.concatenate(outs, axis=0)

            window.append((futures, finalize))
            self._drain(window, self.pipeline_depth - 1)
        self._drain(window, 0)

    def _run_rows(self, stream) -> None:
        halo = self.pipeline.radius
        window: list = []
        for batch_idx, host_batch in enumerate(stream):
            bc, h, w, c = host_batch.shape
            segs = pt.row_partition(h, self.weights, halo=halo)
            futures = []
            for lane, seg, counters in zip(
                self._lanes, segs, self.stats.lanes
            ):
                slab = host_batch[:, seg.inp[0] : seg.inp[1]]
                futures.append(self._pool.submit(lane.process, slab))
                counters.images += bc
                counters.units += bc * seg.out_rows

            def finalize(outs, batch_idx=batch_idx, segs=segs):
                if batch_idx != 0:
                    return
                parts = []
                for seg, out in zip(segs, outs):
                    lo = seg.out[0] - seg.inp[0]
                    parts.append(out[:, lo : lo + seg.out_rows])
                self.first_output = np.concatenate(parts, axis=1)

            window.append((futures, finalize))
            self._drain(window, self.pipeline_depth - 1)
        self._drain(window, 0)

    def _warmup(self, stream) -> None:
        from hipe_tpu.runtime.engine import Engine

        shapes = set(Engine._stream_shapes(stream))
        # Only the row-split fleet needs a halo; image-level fleets must
        # work for radius-less pipelines too (the global-statistics ops
        # raise on .radius by design).
        halo = self.pipeline.radius if self.approach == 2 else 0
        seen: set[tuple[int, tuple]] = set()
        for shape in shapes:
            bc, h, w, c = shape
            if self.approach == 1 and self.scheduler == "greedy":
                # Any lane may take any batch (incl. the remainder batch).
                for i, lane in enumerate(self._lanes):
                    if (i, (bc, h, w, c)) not in seen:
                        seen.add((i, (bc, h, w, c)))
                        lane.warmup((bc, h, w, c))
            elif self.approach == 1:
                counts = self._split_counts(bc)
                for i, cnt in enumerate(counts):
                    if cnt and (i, (cnt, h, w, c)) not in seen:
                        seen.add((i, (cnt, h, w, c)))
                        self._lanes[i].warmup((cnt, h, w, c))
            else:
                for i, seg in enumerate(
                    pt.row_partition(h, self.weights, halo=halo)
                ):
                    key = (i, (bc, seg.in_rows, w, c))
                    if key not in seen:
                        seen.add(key)
                        self._lanes[i].warmup((bc, seg.in_rows, w, c))

    def to_run_stats(self):
        """Two-group RunStats view for the report/CSV metric contract.

        The reference's metric schema is two-device (cpu_* / gpu_* columns,
        `data/approach2/approach2/per_run.csv`); an N-lane fleet maps onto
        it by aggregating host-CPU lanes into the cpu group and accelerator
        lanes into the gpu group (gpu_ratio := accelerator share of the
        weights). For the canonical CPU+GPU two-lane fleet this is exact.
        """
        from hipe_tpu.profiling.events import RunStats

        cpu = DeviceCounters("cpu")
        acc = DeviceCounters("accel")
        acc_weight = 0.0
        cpu_paths: set[str] = set()
        acc_paths: set[str] = set()
        for spec, lane, counters in zip(
            self._specs, self._lanes, self.stats.lanes
        ):
            is_cpu = getattr(spec.device, "platform", "cpu") == "cpu"
            (cpu if is_cpu else acc).merge(counters)
            (cpu_paths if is_cpu else acc_paths).add(lane.path)
            if not is_cpu:
                acc_weight += spec.weight
        total_w = sum(spec.weight for spec in self._specs)
        mode = "both" if (cpu.units and acc.units) else (
            "cpu" if cpu.units else "gpu"
        )
        rs = RunStats(
            approach=self.approach,
            mode=mode,
            gpu_ratio=acc_weight / total_w if total_w else 0.0,
            batch_size=self.batch_size,
            num_images=self.num_images,
            num_batches=pt.num_batches(self.num_images, self.batch_size),
            width=self.stats.width,
            height=self.stats.height,
            channels=self.stats.channels,
            pipeline=self.pipeline.name,
            wall_ms=self.stats.wall_ms,
            cpu=cpu,
            accel=acc,
            cpu_exec="/".join(sorted(cpu_paths)) or "xla",
            accel_exec="/".join(sorted(acc_paths)) or "xla",
        )
        return rs

    def to_csv_row(self, run: int = 1, file: str = "") -> dict:
        """One per_run.csv-schema row (same contract as Engine runs)."""
        from hipe_tpu.profiling.report import to_csv_row

        return to_csv_row(self.to_run_stats(), run=run, file=file)

    def report(self) -> str:
        s = self.stats
        lines = ["\n========== FLEET PERFORMANCE RESULTS =========\n"]
        lines.append(f"Approach: {s.approach}  Batch: {s.batch_size}  "
                     f"Images: {s.num_images}")
        lines.append(f"Wall: {s.wall_ms:.2f} ms  "
                     f"({s.images_per_sec:.1f} img/s)\n")
        for c in s.lanes:
            lines.append(
                f"  {c.name}: {c.images} imgs, {c.units} units, "
                f"{c.total_ms:.1f} ms "
                f"(in {c.in_ms:.1f} / kernel {c.kernel_ms:.1f} / "
                f"out {c.out_ms:.1f}), {c.per_unit_ms():.4f} ms/unit"
            )
        lines.append(f"\nImbalance (max-min/max): {s.imbalance_pct():.1f}%")
        rec = ", ".join(f"{wt:.3f}" for wt in s.recommended_weights())
        lines.append(f"Recommended weights: [{rec}]")
        return "\n".join(lines)
