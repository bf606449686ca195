"""Flagship benchmark: img/s on the 5000-image 256x256 blur stream, one GPU.

The reference's headline metric is whole-stream throughput of a 3x3 Gaussian
blur over a simulated 5000-image stream (the reference's `README.md:71-85`,
best: 8568 img/s on i7-12700 + UHD770). The equivalent measured here: a
seeded photo-like 256x256 RGB image is replicated into a device-resident
5000-image stream (the reference's host-side memcpy stream simulation,
`heterogeneous_blur.c:431-442`, moved to device memory), and the blur runs
over the whole stream; every pass reads and writes 983 MB of distinct
device buffers.

Timing uses pass-count differencing — time(K+1 passes) - time(1 pass), each
ended by ``block_until_ready`` — so dispatch and launch latency cancel and
the quotient is steady-state per-pass time. Chained passes feed each output
into the next pass's input, so XLA cannot hoist or elide any work.

Exits non-zero, with no result, when JAX finds no GPU. Otherwise prints ONE
JSON line on stdout (details on stderr):
  {"metric": ..., "value": img_per_s, "unit": "img/s", "vs_baseline": ...,
   "platform": "gpu", "device_kind": ..., "device_count": ...}
vs_baseline is relative to the reference's own best (8568 img/s,
BASELINE.md). Correctness (max-abs pixel error vs the oracle; must be 0) is
verified in the same run.
"""

from __future__ import annotations

import json
import sys

REFERENCE_BEST_IMG_S = 8568.1  # reference README.md:74 / data/approach1/35_run_1.txt
NUM_IMAGES = 5000


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        log(f"error: no GPU found (JAX default device: {dev})")
        return 1
    from hipe_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from hipe_tpu.runtime.device_stream import DeviceStreamRunner
    from hipe_tpu.utils.images import seeded_image

    log(f"platform={dev.platform} device_kind={dev.device_kind} "
        f"device_count={len(devs)} num_images={NUM_IMAGES}")
    runner = DeviceStreamRunner("blur3", num_images=NUM_IMAGES,
                                image=seeded_image(256, 256, 3, seed=0))

    # Measured fastest-path selection (XLA vs the Triton kernel's launch
    # shapes) — the calibration-loop analog, never assumed. The winner
    # persists in .jax_cache/autotune.json; a cached config is re-verified
    # with one timing and the sweep only re-runs on regression or --retune.
    timings = runner.autotune(passes=4, reps=2, retune="--retune" in sys.argv)
    for label, t in sorted(timings.items(), key=lambda kv: kv[1]):
        log(f"  autotune {label:24s} {t * 1e3:8.3f} ms/pass")
    cache_hit = bool(runner.tuning.get("cache_hit"))
    log(f"chosen config: {runner.tuning['chosen']} ({runner.kernel_name})"
        + (" (cache hit, sweep skipped)" if cache_hit else ""))

    max_abs_err = runner.verify_max_abs_err()
    log(f"max_abs_err vs oracle: {max_abs_err}")

    sessions = []
    for i in range(3):
        res = runner.measure_throughput(passes=10, reps=3)
        sessions.append(res)
        log(f"session {i}: per-pass {res['per_pass_s'] * 1e3:.3f} ms -> "
            f"{res['img_per_s']:,.0f} img/s (~{res['gb_per_s']:.0f} GB/s)")
    rates = sorted(r["img_per_s"] for r in sessions)
    img_per_s = rates[len(rates) // 2]  # median of 3

    print(json.dumps({
        "metric": "img_per_s_5000x256x256_blur3_stream",
        "value": img_per_s,
        "unit": "img/s",
        "vs_baseline": img_per_s / REFERENCE_BEST_IMG_S,
        "reference_best_img_s": REFERENCE_BEST_IMG_S,
        "max_abs_err": max_abs_err,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(devs),
        "num_images": NUM_IMAGES,
        "sessions_img_s": rates,
        "chosen_config": runner.tuning["chosen"],
        "kernel": runner.kernel_name,
        "autotune_cache_hit": cache_hit,
        "autotune_ms_per_pass": {k: v * 1e3 for k, v in timings.items()},
    }))
    return 0 if max_abs_err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
