"""Smoke run of the engine's main paths on one NVIDIA GPU, at real sizes.

    python chip_smoke.py            # one card: stream, engine, serve-resize
    python chip_smoke.py --multi    # every visible card: the sharded paths

Phases (each a function, so tests can call it at tiny sizes on the CPU):

- ``stream``: ``DeviceStreamRunner("blur3")`` over 5000 256x256x3 images
  resident on the card, 16 distinct seeded images repeated through the
  stream. Autotune times XLA and the Pallas Triton kernel end to end; each
  must equal the NumPy oracle exactly on the first, middle and last image.
- ``engine``: the reference's two programs through the ``Engine`` API on
  5000 seeded 320x240 images: approach 1 (host CPU lane + GPU lane, ratio
  0.9, batch 100) and approach 2 (row split, ratio 0.837, batch 35).
  Batch 0 must equal the oracle exactly.
- ``serve_resize``: ``ServingPipeline("blur3", resize_to=...)`` on seeded
  1920x1080 frames (rows-layout blur, then the Q14 bilinear resize whose
  dots must run at fp32 HIGHEST precision): exact against the oracles.
  The JPEG codec is left out: it needs libjpeg on the host.
- ``multi`` (``--multi`` only): image-level sharding of the 5000x256x256
  stream, the per-stage ``ppermute`` row split of blur->sharpen->edge and
  the weighted row split, over a flat mesh of all visible cards; each bit
  for bit against the one-card XLA result, each with one shard per card.

The script exits non-zero, printing no result, when JAX finds no GPU. Its
last line is one JSON object: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# The engine's host lane is the CPU backend: keep it visible beside the GPU
# when the environment names platforms explicitly.
_plats = os.environ.get("JAX_PLATFORMS")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"


def log(msg: str) -> None:
    print(msg, flush=True)


def _max_abs_err(got: np.ndarray, want: np.ndarray) -> int:
    if np.broadcast_shapes(got.shape, want.shape) != got.shape:
        raise ValueError(f"shape {got.shape} != {want.shape}")
    return int(np.max(np.abs(got.astype(np.int16) - want.astype(np.int16))))


def phase_stream(num_images: int = 5000, size=(256, 256), seed: int = 0,
                 use_pallas: bool | None = None, passes: int = 5) -> dict:
    """Flagship stream: autotune (XLA vs kernel), exactness of each."""
    import jax

    from hipe_tpu.runtime.device_stream import DeviceStreamRunner
    from hipe_tpu.utils.images import seeded_image

    # 16 distinct images: the verified slots 0, N/2 and N-1 of a
    # 5000-image stream hold images 0, 4 and 7.
    images = np.stack([seeded_image(*size, seed=seed + i) for i in range(16)])
    runner = DeviceStreamRunner("blur3", num_images=num_images, image=images,
                                use_pallas=use_pallas)
    timings = runner.autotune(passes=passes, reps=3, cache=False)
    chosen = runner.path
    errors = {}
    # Every timed path, as compiled, against the oracle.
    for path in timings:
        runner.set_path(path)
        errors[runner.kernel_name] = runner.verify_max_abs_err()
    runner.set_path(chosen)
    compiled = jax.jit(runner._one_pass).lower(runner.stream).compile()
    return {
        "kernel": runner.kernel_name,
        "chosen": runner.tuning["chosen"],
        "per_pass_ms": {k: v * 1e3 for k, v in timings.items()},
        "max_abs_err": errors,
        "memory_analysis": str(compiled.memory_analysis()),
        "ok": all(e == 0 for e in errors.values()),
    }


def phase_engine(num_images: int = 5000, size=(240, 320), seed: int = 0,
                 a1=(0.9, 100), a2=(0.837, 35), cpu_device=None,
                 accel_device=None) -> dict:
    """Approach 1 (both lanes) and approach 2 (row split): batch 0 exact."""
    from hipe_tpu.ops import reference as oracle
    from hipe_tpu.runtime.engine import Engine, EngineConfig
    from hipe_tpu.utils.images import seeded_image

    image = seeded_image(*size, seed=seed)
    want = oracle.gaussian_blur_int_oracle(image)
    out = {"ok": True}
    for approach, (ratio, batch) in ((1, a1), (2, a2)):
        cfg = EngineConfig(approach=approach, mode="both", gpu_ratio=ratio,
                           batch_size=batch, num_images=num_images,
                           pipeline="blur3")
        eng = Engine(cfg, cpu_device=cpu_device, accel_device=accel_device)
        t0 = time.perf_counter()
        stats = eng.run(image=image)
        wall = time.perf_counter() - t0
        first = eng.first_output
        err = _max_abs_err(first, want[None])
        res = {
            "accel_kernel": eng._lanes["accel"].path,
            "cpu_kernel": eng._lanes["cpu"].path,
            "batch0_images": int(first.shape[0]),
            "max_abs_err": err,
            "cpu_units": int(stats.cpu.units),
            "accel_units": int(stats.accel.units),
            "wall_s": wall,
        }
        out[f"approach{approach}"] = res
        out["ok"] = out["ok"] and err == 0
    return out


def phase_serve_resize(num_images: int = 8, size=(1080, 1920),
                       resize_to=(540, 960), seed: int = 0,
                       device=None) -> dict:
    """Serving filter + Q14 bilinear resize on decoded frames: exact."""
    from hipe_tpu.ops import reference as oracle
    from hipe_tpu.runtime.serve import ServingPipeline
    from hipe_tpu.utils.images import seeded_image

    frames = np.stack([seeded_image(*size, seed=seed + i)
                       for i in range(num_images)])
    sp = ServingPipeline("blur3", device=device, resize_to=tuple(resize_to))
    got = sp.process_pixels(frames)
    want = np.stack([
        oracle.resize_bilinear_oracle(
            oracle.gaussian_blur_int_oracle(f), *resize_to)
        for f in frames
    ])
    err = _max_abs_err(got, want)
    return {
        "kernel": sp.pipeline.kernel_name(sp.use_pallas, layout="rows"),
        "shape": list(got.shape),
        "max_abs_err": err,
        "ok": err == 0 and got.shape == want.shape,
    }


def _shard_devices(arr) -> list:
    return sorted({s.device.id for s in arr.addressable_shards})


def phase_multi(num_images: int = 5000, size=(256, 256),
                frames=(16, 2160, 3840), seed: int = 0,
                devices=None) -> dict:
    """Sharded approaches over a flat mesh vs the one-card XLA result."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hipe_tpu.ops import blur as xblur
    from hipe_tpu.parallel import mesh as meshlib
    from hipe_tpu.parallel.image_level import make_image_level_fn, shard_batch
    from hipe_tpu.parallel.row_split import (make_row_split_fn,
                                             make_weighted_row_split_fn)
    from hipe_tpu.utils.images import seeded_image

    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    one = devs[0]
    out = {"devices": n, "ok": True}

    def record(name, got, want, shards):
        err = _max_abs_err(got, want)
        own = shards == sorted(d.id for d in devs)
        out[name] = {"max_abs_err": err, "shard_devices": shards,
                     "one_shard_per_device": own}
        out["ok"] = out["ok"] and err == 0 and own

    # Approach 1: the 5000-image stream, batch-sharded.
    image = seeded_image(*size, seed=seed)
    stream = np.ascontiguousarray(
        np.broadcast_to(image, (num_images,) + image.shape))
    mesh_dp = meshlib.make_mesh(n, devices=devs)
    fn = make_image_level_fn(mesh_dp, ("gaussian3",))
    got = fn(shard_batch(stream, mesh_dp))
    shards = _shard_devices(got)
    got = np.asarray(got)
    want = np.asarray(jax.jit(
        lambda x: xblur.filter_chain(x, ("gaussian3",)))(
            jax.device_put(stream, one)))
    record("image_level", got, want, shards)
    del got, want, stream

    # Approach 2: per-stage ppermute halo row split, and weighted shares.
    names = ("gaussian3", "sharpen", "edge")
    b, h, w = frames
    rng = np.random.default_rng(seed)
    x = np.stack([seeded_image(h, w, seed=int(s))
                  for s in rng.integers(0, 2**31, b)])
    want = np.asarray(jax.jit(lambda v: xblur.filter_chain(v, names))(
        jax.device_put(x, one)))
    mesh_sp = meshlib.make_mesh(n, axis=meshlib.ROW_AXIS, devices=devs)
    x_sh = jax.device_put(x, NamedSharding(mesh_sp, P(None, meshlib.ROW_AXIS)))
    got = make_row_split_fn(mesh_sp, names)(x_sh)
    record("row_split", np.asarray(got), want, _shard_devices(got))
    weights = [1.0 + 0.25 * i for i in range(n)]
    got = make_weighted_row_split_fn(mesh_sp, names, weights=weights)(x_sh)
    record("weighted_row_split", np.asarray(got), want, _shard_devices(got))
    return out


def _nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def _routing_table() -> dict:
    from hipe_tpu.models.pipelines import PIPELINES

    return {name: pipe.kernel_name(True) for name, pipe in PIPELINES.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded phase, over every card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jaxlib

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"error: no GPU found (JAX default device: {devs[0]})",
              file=sys.stderr)
        return 1
    from hipe_tpu.utils.cache import enable_compilation_cache

    log(f"compile cache: {enable_compilation_cache()}")
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__}")
    log(f"devices: {len(devs)} x {devs[0].device_kind}")

    if args.multi:
        phases = {"multi": lambda: phase_multi(seed=args.seed)}
    else:
        log("kernel per pipeline on this device: "
            + json.dumps(_routing_table()))
        phases = {
            "stream": lambda: phase_stream(seed=args.seed),
            "engine": lambda: phase_engine(seed=args.seed),
            "serve_resize": lambda: phase_serve_resize(seed=args.seed),
        }
    ok = True
    for name, fn in phases.items():
        t0 = time.perf_counter()
        res = fn()
        res["seconds"] = time.perf_counter() - t0
        mem = res.pop("memory_analysis", None)
        log(f"phase {name}: " + json.dumps(res, default=str))
        if mem is not None:
            log(f"phase {name} memory_analysis: {mem}")
        ok = ok and res["ok"]
    log(_nvidia_smi())  # card name and power limit, as nvidia-smi gives them
    if not ok:
        print("error: a phase was not exact", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
