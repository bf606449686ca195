"""Per-pipeline device-resident stream corpus (one JSON row per pipeline).

Measures every registered pipeline on the 5000-image 256x256
device-resident stream with the execution path autotuned per pipeline
(XLA vs the kernel, where a pipeline has a kernel), plus bit-exactness vs
the oracle on the stream's first, middle and last image. Every row records the device it ran on. Needs
a GPU; exits non-zero without one.

Usage: python benchmarks/run_device_stream.py --out stream.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-images", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cached-tune", action="store_true",
                    help="reuse persisted autotune winners")
    ap.add_argument("--pipelines", nargs="+", default=None, metavar="NAME",
                    help="measure only these pipelines")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: no GPU found (JAX default device: {dev})",
              file=sys.stderr)
        return 1
    from hipe_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from hipe_tpu.models.pipelines import PIPELINES
    from hipe_tpu.runtime.device_stream import DeviceStreamRunner
    from hipe_tpu.utils.images import seeded_image

    img = seeded_image(256, 256, 3, seed=args.seed)
    names = args.pipelines or list(PIPELINES)
    unknown = [n for n in names if n not in PIPELINES]
    if unknown:
        print(f"unknown pipelines: {unknown} "
              f"(choose from {sorted(PIPELINES)})", file=sys.stderr)
        return 1
    rows = []
    for name in names:
        r = DeviceStreamRunner(name, num_images=args.num_images, image=img)
        r.autotune(passes=4, reps=2, retune=not args.cached_tune)
        err = r.verify_max_abs_err()
        res = r.measure_throughput(passes=8, reps=3)
        row = {
            "pipeline": name,
            "device_kind": dev.device_kind,
            "max_abs_err": err,
            "ms_per_pass": res["per_pass_s"] * 1e3,
            "img_per_s": res["img_per_s"],
            "gb_per_s": res["gb_per_s"],
            "path": r.tuning["chosen"],
            "kernel": r.kernel_name,
        }
        rows.append(row)
        print(row, file=sys.stderr)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    bad = [row["pipeline"] for row in rows if row["max_abs_err"]]
    print(f"wrote {args.out}" + (f" (inexact: {bad})" if bad else ""),
          file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
