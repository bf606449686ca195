"""Generate the benchmark corpus on real hardware.

Reproduces the reference's benchmarking methodology (SURVEY.md L7 / §6):
calibrate the ratio with a 50/50 run, then sweep batch sizes with N runs
each at the tuned ratio, for both approaches, writing per-run report logs
plus per_run.csv / avg_by_batch.csv aggregates per approach.

The reference swept 5000 images x {35..1200} x 3 runs on a desktop with
PCIe-attached devices; here the pair is the host CPU backend and the GPU.
Without --image the input is a seeded image of the reference's 320x240
size.

Usage: python benchmarks/run_corpus.py [--num-images N] [--runs R]
           [--out benchmarks/corpus]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-images", type=int, default=1000)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--batch-sizes", type=int, nargs="+",
                    default=[35, 50, 100, 200, 500])
    ap.add_argument("--image", default=None,
                    help="input JPEG (default: a seeded 320x240 image)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="benchmarks/corpus")
    ap.add_argument("--single-lane-batches", type=int, nargs="*",
                    default=None, metavar="B",
                    help="also run mode=cpu / mode=gpu single-device "
                         "baselines (the reference's missing "
                         "gaussian_blur.c analog, heterogeneous_blur.c:"
                         "52-58) at these batch sizes")
    ap.add_argument("--single-only", action="store_true",
                    help="run only the single-lane baselines (skip the "
                         "heterogeneous approach sweeps)")
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print("error: no GPU found", file=sys.stderr)
        return 1
    from hipe_tpu.parallel.autotune import calibrate_ratio, sweep_batch_sizes
    from hipe_tpu.profiling.corpus import write_corpus
    from hipe_tpu.runtime.engine import EngineConfig
    from hipe_tpu.utils.images import REFERENCE_320, load_test_image

    image = np.ascontiguousarray(load_test_image(
        args.image, size=REFERENCE_320, seed=args.seed))

    if args.single_lane_batches:
        # Single-device baselines: the heterogeneous-vs-single-device
        # comparison row (reference README.md:84 claims 1.58x vs GPU-only).
        for mode in ("cpu", "gpu"):
            cfg = EngineConfig(approach=1, mode=mode, batch_size=100,
                               num_images=args.num_images)
            print(f"[single {mode}] sweeping...", file=sys.stderr)
            stats = sweep_batch_sizes(
                cfg, image, batch_sizes=args.single_lane_batches,
                runs=args.runs,
            )
            out_dir = f"{args.out}/single_{mode}"
            write_corpus(stats, out_dir)
            best = max(stats, key=lambda s: s.images_per_sec)
            print(f"[single {mode}] best: batch={best.batch_size} "
                  f"{best.images_per_sec:.0f} img/s", file=sys.stderr)

    if args.single_only:
        return 0

    for approach in (1, 2):
        base = EngineConfig(approach=approach, mode="both", batch_size=100,
                            num_images=args.num_images)
        print(f"[approach {approach}] calibrating ratio...", file=sys.stderr)
        tuned = calibrate_ratio(
            base, image, max_iters=3, tol_pct=3.0,
            num_images=min(args.num_images, 300),
        )
        print(f"[approach {approach}] tuned ratio {tuned.ratio:.3f} "
              f"(history {tuned.history})", file=sys.stderr)
        cfg = dataclasses.replace(base, gpu_ratio=tuned.ratio)
        stats = sweep_batch_sizes(cfg, image, batch_sizes=args.batch_sizes,
                                  runs=args.runs)
        out_dir = f"{args.out}/approach{approach}"
        per_run, avg = write_corpus(stats, out_dir)
        print(f"[approach {approach}] wrote {per_run} and {avg}",
              file=sys.stderr)
        best = max(stats, key=lambda s: s.images_per_sec)
        print(f"[approach {approach}] best: batch={best.batch_size} "
              f"{best.images_per_sec:.0f} img/s "
              f"({best.mpix_per_sec:.0f} Mpix/s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
