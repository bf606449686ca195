"""Device-resident stream processing — the accelerator fast path.

The reference's throughput ceiling was host<->device transfer of every image
over PCIe (`README.md:85` of the reference: the CPU becomes
communication-bound). Here the stream stays resident in device memory:
inputs are staged (or, for the replicated stream simulation of
`heterogeneous_blur.c:431-442`, generated) on the device, the whole stream
is processed by one compiled program, and only checksums/requested outputs
return to the host. This is the mode `bench.py` measures.

Throughput measurement uses pass-count differencing: chained passes (each
pass consumes the previous pass's output, so XLA can neither hoist nor elide
work) timed at two different pass counts; the difference isolates
steady-state per-pass time from dispatch and launch latency.

The execution path is *measured, not assumed*: :meth:`autotune` times the
XLA path and, for pipelines with a hand-written kernel, that kernel, then
routes through the winner. A path that fails to compile is an error, never
a skip.
"""

from __future__ import annotations

import functools
import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from hipe_tpu.models import pipelines as plib

# Accepting a cached config requires its fresh one-shot timing to stay
# within this factor of the stored one; beyond it the full sweep re-runs.
_RETUNE_FACTOR = 1.6
_TUNE_CACHE_VERSION = 3


def _default_tune_cache_path() -> str:
    from hipe_tpu.utils.cache import DEFAULT_DIR

    return os.path.join(DEFAULT_DIR, "autotune.json")


class DeviceStreamRunner:
    """Process an N-image stream resident in device memory.

    ``image`` is one (H, W, C) image or a (K, H, W, C) set; stream slot
    ``i`` holds image ``i % K``.
    """

    def __init__(
        self,
        pipeline: plib.Pipeline | str = "blur3",
        *,
        num_images: int = 5000,
        image: np.ndarray | None = None,
        use_pallas: bool | None = None,
        device=None,
        tune_cache_path: str | None = None,
    ):
        self.pipeline = plib.get(pipeline) if isinstance(pipeline, str) else pipeline
        self.num_images = num_images
        if image is None:
            from hipe_tpu.utils.images import load_test_image

            image = load_test_image()
        self.images = image[None] if image.ndim == 3 else image
        k, h, w, c = self.images.shape
        self.shape = (h, w, c)
        self.device = device or jax.devices()[0]
        if use_pallas is None:
            use_pallas = plib.default_use_pallas(self.device)
        self.use_pallas = use_pallas

        from hipe_tpu.utils.images import hwc_to_planar

        planes = jax.device_put(
            jnp.asarray(hwc_to_planar(self.images)), self.device
        )

        n, hh, ww = num_images * c, h, w
        self.n_planes = n

        @jax.jit
        def materialize(p):
            slot_image = jnp.arange(num_images) % k
            return p.reshape(k, c, hh, ww)[slot_image].reshape(n, hh, ww)

        # The device-resident stream: distinct device buffers per image
        # (the reference's memcpy stream simulation, in device memory).
        self.stream = materialize(planes)

        kernel = self.use_pallas and self.pipeline.has_kernel
        self.tuning: dict | None = None
        self.tune_cache_path = tune_cache_path or _default_tune_cache_path()
        self.set_path("pallas" if kernel else "xla")

    @property
    def kernel_name(self) -> str:
        """The implementation the current path runs."""
        return self.pipeline.kernel_name(self.path == "pallas")

    # ---- autotune-winner persistence (the reference's "recommended ratio
    # printed as a re-run command", heterogeneous_blur.c:712-723, made
    # automatic: the chosen execution config is cached per workload and
    # re-verified with one timing on the next run) ----

    def _tune_key(self) -> str:
        h, w, c = self.shape
        dev = getattr(self.device, "device_kind", None) or getattr(
            self.device, "platform", "unknown"
        )
        return f"{self.pipeline.name}|{h}x{w}x{c}|n{self.num_images}|{dev}"

    def _load_cached_config(self):
        try:
            with open(self.tune_cache_path) as f:
                data = json.load(f)
            if data.get("version") != _TUNE_CACHE_VERSION:
                return None
            ent = data.get("entries", {}).get(self._tune_key())
            if ent is None:
                return None
            return ent["path"], float(ent["per_pass_s"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _store_cached_config(self, path: str, per_pass_s: float) -> None:
        try:
            try:
                with open(self.tune_cache_path) as f:
                    data = json.load(f)
                if data.get("version") != _TUNE_CACHE_VERSION:
                    data = {"version": _TUNE_CACHE_VERSION, "entries": {}}
            except (OSError, ValueError):
                data = {"version": _TUNE_CACHE_VERSION, "entries": {}}
            data["entries"][self._tune_key()] = {
                "path": path, "per_pass_s": per_pass_s,
            }
            os.makedirs(os.path.dirname(self.tune_cache_path), exist_ok=True)
            tmp = self.tune_cache_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1)
            os.replace(tmp, self.tune_cache_path)
        except OSError:
            pass  # cache is an optimization; never fail the run for it

    def set_path(self, path: str) -> None:
        """Route the runner through ``"xla"`` or the ``"pallas"`` kernel."""
        self.path = path
        pipe = self.pipeline
        use_pallas = path == "pallas"

        def one_pass(s):
            return pipe.apply_planar(s, use_pallas=use_pallas)

        self._one_pass = one_pass

        @functools.partial(jax.jit, static_argnames="r")
        def chained(s, r):
            out = lax.fori_loop(0, r, lambda i, x: one_pass(x), s)
            return jnp.sum(out[::97, ::3, ::64].astype(jnp.int32))

        self._chained = chained

    def autotune(self, passes: int = 4, reps: int = 2,
                 cache: bool = True, retune: bool = False) -> dict:
        """Time XLA and the kernel, where one exists; keep the faster.

        The reference's calibration loop tunes its ratio by measurement
        (README.md:87-93); the analog here tunes the execution config.
        Returns {path: per_pass_seconds} and rebuilds the runner around
        the fastest entry. A path that fails to build or run raises: a
        kernel that does not compile is a fault to fix, not a path to
        drop.

        With ``cache=True`` (default) the winner is persisted per
        (pipeline, geometry, stream size, device kind); the next run
        re-verifies the cached path with ONE timing and only re-sweeps
        on regression past ``_RETUNE_FACTOR`` or ``retune=True``.
        ``self.tuning["cache_hit"]`` records which path ran.
        """
        if cache and not retune:
            cached = self._load_cached_config()
            if cached is not None:
                path, cached_t = cached
                self.set_path(path)
                t = self._measure_per_pass(passes=passes, reps=reps)
                if t <= cached_t * _RETUNE_FACTOR:
                    self.tuning = {
                        "chosen": path,
                        "per_pass_s": {path: t},
                        "cache_hit": True,
                        "cached_per_pass_s": cached_t,
                    }
                    # Keep the FASTEST observation as the stored
                    # baseline: re-storing each fresh timing would
                    # ratchet the acceptance threshold upward and let
                    # gradual regressions pass forever.
                    self._store_cached_config(path, min(t, cached_t))
                    return {path: t}
        paths = ["xla"]
        if self.use_pallas and self.pipeline.has_kernel:
            paths.append("pallas")
        timings: dict[str, float] = {}
        for path in paths:
            self.set_path(path)
            timings[path] = self._measure_per_pass(passes=passes, reps=reps)
        best = min(timings, key=timings.get)
        self.set_path(best)
        self.tuning = {
            "chosen": best,
            "per_pass_s": timings,
            "cache_hit": False,
        }
        if cache:
            self._store_cached_config(best, timings[best])
        return timings

    def verify_max_abs_err(self) -> int:
        """Max-abs pixel error vs the reference oracle.

        Checks the first, middle and last image of the stream, so that a
        fault in plane or grid addressing past the first image shows.
        """
        from hipe_tpu.ops import reference as oracle
        from hipe_tpu.utils.images import hwc_to_planar

        c = self.shape[2]
        slots = sorted({0, self.num_images // 2, self.num_images - 1})
        planes = np.concatenate([np.arange(i * c, (i + 1) * c) for i in slots])
        # Run the full stream (the compiled pass is built for its shape)
        # and gather the sampled planes on-device — only those cross to
        # the host.
        got = np.asarray(
            jax.jit(lambda s: self._one_pass(s)[planes])(self.stream)
        )
        ref_fn = {
            "blur3": lambda im: oracle.gaussian_blur_int_oracle(im, 1),
            "blur5": lambda im: oracle.gaussian_blur_int_oracle(im, 2),
            "blur9": lambda im: oracle.gaussian_blur_int_oracle(im, 4),
        }.get(self.pipeline.name)
        if ref_fn is None:
            # The pipeline's own XLA path (filter chains and the
            # global-statistics pipelines alike) is the oracle; its
            # CPU-exactness is pinned by the test suite.
            def ref_fn(im):
                return np.asarray(self.pipeline(jnp.asarray(im)))
        k = self.images.shape[0]
        want = hwc_to_planar(
            np.stack([ref_fn(self.images[i % k]) for i in slots]))
        return int(np.max(np.abs(got.astype(int) - want.astype(int))))

    def _measure_per_pass(self, passes: int, reps: int) -> float:
        """Median-of-`reps` steady-state seconds/pass via differencing."""

        def timed(r: int) -> float:
            t0 = time.perf_counter()
            jax.block_until_ready(self._chained(self.stream, r))
            return time.perf_counter() - t0

        timed(1)
        timed(1 + passes)  # compile both pass counts outside the window
        samples = []
        for _ in range(reps):
            t1 = timed(1)
            t2 = timed(1 + passes)
            samples.append((t2 - t1) / passes)
        ordered = sorted(samples)
        mid = len(ordered) // 2
        best = (ordered[mid] if len(ordered) % 2
                else (ordered[mid - 1] + ordered[mid]) / 2.0)
        if best <= 0.0:
            # Timing noise swamped the differencing (tiny CPU test runs);
            # fall back to the raw chained-run estimate.
            best = t2 / (1 + passes)
        return best

    def measure_throughput(self, passes: int = 10, reps: int = 3) -> dict:
        """Steady-state img/s via pass-count differencing, median of `reps`."""
        best = self._measure_per_pass(passes=passes, reps=reps)
        h, w, c = self.shape
        return {
            "per_pass_s": best,
            "img_per_s": self.num_images / best,
            "mpix_per_s": self.num_images * h * w / best / 1e6,
            "gb_per_s": 2 * self.num_images * h * w * c / best / 1e9,
        }
