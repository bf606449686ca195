"""The 8-section performance report and CSV metric contract.

Mirrors the reference's PERFORMANCE RESULTS report
(`heterogeneous_blur.c:611-724`): overall wall time,
per-device totals with in/kernel/out percentage splits, device comparison,
workload imbalance, bottleneck identification (communication vs computation),
throughput (Mpix/s, img/s), and the optimal-ratio recommendation. The
machine-parseable CSV row follows the reference's aggregate schema
(`data/approach2/approach2/per_run.csv` header) so existing analysis tooling
ports over directly.
"""

from __future__ import annotations

from hipe_tpu.parallel.partitioner import imbalance_pct, recommend_ratio
from hipe_tpu.profiling.events import DeviceCounters, RunStats

CSV_COLUMNS = [
    "batch_size_file", "run", "file", "mode", "gpu_ratio_cfg",
    "cpu_ratio_cfg", "images", "batches", "img_w", "img_h", "wg_w", "wg_h",
    "wall_ms", "cpu_images", "cpu_total_ms", "cpu_in_ms", "cpu_kernel_ms",
    "cpu_out_ms", "cpu_ms_per_img", "gpu_images", "gpu_total_ms",
    "gpu_in_ms", "gpu_kernel_ms", "gpu_out_ms", "gpu_ms_per_img",
    "speedup_gpu_vs_cpu", "imbalance_pct", "bottleneck",
    "bottleneck_delta_ms", "mpix_per_sec", "img_per_sec",
    "recommended_gpu_ratio", "batch_size_log",
]


def _device_section(idx: int, label: str, c: DeviceCounters, extra: str) -> str:
    return (
        f"{idx}. {label} (processed {c.images} images{extra})\n"
        f"   Total {c.name.upper()} time:        {c.total_ms:.2f} ms\n"
        f"   - Transfer IN:         {c.in_ms:.2f} ms ({c.pct(c.in_ms):.1f}%)\n"
        f"   - Kernel execution:    {c.kernel_ms:.2f} ms ({c.pct(c.kernel_ms):.1f}%)\n"
        f"   - Transfer OUT:        {c.out_ms:.2f} ms ({c.pct(c.out_ms):.1f}%)\n"
        f"   Average per image:     {c.per_image_ms():.2f} ms\n"
    )


def _bottleneck_kind(c: DeviceCounters) -> tuple[str, float]:
    """COMMUNICATION iff in+out > kernel (heterogeneous_blur.c:683-698)."""
    comm = c.in_ms + c.out_ms
    if comm > c.kernel_ms:
        return "COMMUNICATION", c.pct(comm)
    return "COMPUTATION", c.pct(c.kernel_ms)


def recommended_ratio(stats: RunStats) -> float:
    """ratio* from measured per-unit times (per image A1 / per row A2)."""
    return recommend_ratio(stats.cpu.per_unit_ms(), stats.accel.per_unit_ms())


def render_report(stats: RunStats, accel_name: str = "GPU") -> str:
    """The 8-section PERFORMANCE RESULTS report."""
    s = stats
    lines = ["\n========== PERFORMANCE RESULTS ==========\n"]
    lines.append(f"BATCH SIZE : {s.batch_size}")
    lines.append("1. OVERALL EXECUTION TIME")
    lines.append(
        f"   Total wall-clock time: {s.wall_ms:.2f} ms "
        f"({s.wall_ms / 1000.0:.2f} seconds)"
    )
    lines.append(f"   Total images processed: {s.num_images}\n")

    both = s.mode == "both"
    extra_cpu = extra_acc = ""
    if s.approach == 2 and s.split_row is not None:
        extra_cpu = f" - top {s.split_row} rows each"
        extra_acc = f" - bottom {s.height - s.split_row} rows each"
    if both or s.mode == "cpu":
        lines.append(_device_section(2, "CPU DEVICE", s.cpu, extra_cpu))
    if both or s.mode != "cpu":
        lines.append(
            _device_section(3, f"{accel_name} DEVICE", s.accel, extra_acc)
        )

    if both:
        lines.append("====================")
        lines.append("4. DEVICE COMPARISON")
        cpu_t, acc_t = s.cpu.total_ms, s.accel.total_ms
        cpu_per, acc_per = s.cpu.per_unit_ms(), s.accel.per_unit_ms()
        if acc_per > 0 and cpu_per > 0:
            if acc_per < cpu_per:
                lines.append(
                    f"   {accel_name} is {cpu_per / acc_per:.2f}x FASTER than "
                    f"CPU (per work unit)"
                )
            else:
                lines.append(
                    f"   CPU is {acc_per / cpu_per:.2f}x FASTER than "
                    f"{accel_name} (per work unit)"
                )
        if acc_t > 0:
            lines.append(f"   CPU/{accel_name} time ratio: {cpu_t / acc_t:.2f}\n")

        lines.append("5. WORKLOAD BALANCE")
        imb = imbalance_pct(cpu_t, acc_t)
        lines.append(f"   Workload imbalance: {imb:.1f}%")
        slow = "CPU" if cpu_t > acc_t else accel_name
        lines.append(
            f"   {slow} is the BOTTLENECK ({abs(cpu_t - acc_t):.2f} ms slower)\n"
        )

        lines.append("6. BOTTLENECK IDENTIFICATION")
        for label, c in (("CPU", s.cpu), (accel_name, s.accel)):
            kind, pct = _bottleneck_kind(c)
            lines.append(f"   {label} bottleneck: {kind} ({pct:.1f}% of time)")
        lines.append("")

    lines.append("7. THROUGHPUT")
    lines.append(f"   Overall throughput: {s.mpix_per_sec:.2f} Megapixels/sec")
    lines.append(f"   Images per second: {s.images_per_sec:.2f}\n")
    lines.append("=========================================\n")

    if both:
        unit = "image" if s.approach == 1 else "row"
        rec = recommended_ratio(s)
        lines.append("8. OPTIMAL RATIO RECOMMENDATION")
        lines.append("   Based on measured performance:")
        lines.append(f"   CPU: {s.cpu.per_unit_ms():.3f} ms/{unit}")
        lines.append(f"   {accel_name}: {s.accel.per_unit_ms():.3f} ms/{unit}")
        lines.append(f"   Recommended {accel_name} ratio: {rec * 100.0:.1f}%")
        prog = "approach1 both" if s.approach == 1 else "approach2"
        lines.append(
            f"   Run with: python -m hipe_tpu.cli {prog} {rec:.3f} "
            f"{s.batch_size}"
        )
    return "\n".join(lines)


def to_csv_row(stats: RunStats, run: int = 1, file: str = "") -> dict:
    """One per_run.csv-schema row (reference metric contract)."""
    s = stats
    cpu_t, acc_t = s.cpu.total_ms, s.accel.total_ms
    slower = "CPU" if cpu_t > acc_t else "GPU"
    kind = {1: "both", 2: "split"}[s.approach]
    return {
        "batch_size_file": s.batch_size,
        "run": run,
        "file": file,
        "mode": f"{kind}:{s.mode}",
        "gpu_ratio_cfg": s.gpu_ratio,
        "cpu_ratio_cfg": 1.0 - s.gpu_ratio,
        "images": s.num_images,
        "batches": s.num_batches,
        "img_w": s.width,
        "img_h": s.height,
        # No OpenCL 16x16 work-groups here (the reference writes "16,16");
        # the analog is the per-lane kernel execution config, recorded so
        # tooling reading these columns sees the chosen path, not blanks.
        "wg_w": s.cpu_exec,
        "wg_h": s.accel_exec,
        "wall_ms": round(s.wall_ms, 2),
        "cpu_images": s.cpu.images,
        "cpu_total_ms": round(cpu_t, 2),
        "cpu_in_ms": round(s.cpu.in_ms, 2),
        "cpu_kernel_ms": round(s.cpu.kernel_ms, 2),
        "cpu_out_ms": round(s.cpu.out_ms, 2),
        "cpu_ms_per_img": round(s.cpu.per_image_ms(), 4),
        "gpu_images": s.accel.images,
        "gpu_total_ms": round(acc_t, 2),
        "gpu_in_ms": round(s.accel.in_ms, 2),
        "gpu_kernel_ms": round(s.accel.kernel_ms, 2),
        "gpu_out_ms": round(s.accel.out_ms, 2),
        "gpu_ms_per_img": round(s.accel.per_image_ms(), 4),
        "speedup_gpu_vs_cpu": round(cpu_t / acc_t, 2) if acc_t else "",
        "imbalance_pct": round(imbalance_pct(cpu_t, acc_t), 1),
        "bottleneck": slower,
        "bottleneck_delta_ms": round(abs(cpu_t - acc_t), 2),
        "mpix_per_sec": round(s.mpix_per_sec, 2),
        "img_per_sec": round(s.images_per_sec, 2),
        "recommended_gpu_ratio": round(recommended_ratio(s), 3),
        "batch_size_log": s.batch_size,
    }
