"""Filter pipelines — the deployable "models" of the engine.

Each pipeline is a named chain of integer-exact uint8 filters. Every stage
runs on the XLA path (:mod:`hipe_tpu.ops.blur`), on any JAX backend and in
any layout. One family also has a hand-written GPU kernel: a single
separable Gaussian over planar planes runs the Pallas Triton kernel of
:mod:`hipe_tpu.ops.pallas_blur` when ``use_pallas=True``. The interleaved
rows layout stays on XLA: relayout to planes + kernel + relayout back
measured slower than XLA's rows fusion on an H100. The registry covers the
workloads in BASELINE.json: the reference 3x3 blur, the large-radius
separable Gaussians, and the blur->sharpen->edge chain.
"""

from __future__ import annotations

import dataclasses

import jax

from hipe_tpu.ops import blur as xblur
from hipe_tpu.ops import pallas_blur


# Global-statistics applies (LUT gathers / luma blends)
# carry int32 temps per pixel that XLA materializes at stream scale: at
# the 5000-image resident stream (15000 planes) one s32 temp is ~4 GB.
# Above this many planes, GlobalStatsPipeline.apply_planar runs the op as a
# lax.map over equal chunks (largest divisor of N that is a multiple of the
# channel count and <= the limit) — bit-identical because every statistic
# is per-image.
GLOBAL_STATS_PLANE_CHUNK = 3072


def _global_stats_chunk(n: int, channels: int) -> int | None:
    """Chunk size for a stream-scale global-statistics apply, or None.

    The largest divisor of ``n`` that is a multiple of ``channels``
    (chunk boundaries must align to whole images — planar layout is
    image-major, so any multiple of the channel count is) and at most
    :data:`GLOBAL_STATS_PLANE_CHUNK`. None when ``n`` already fits or no
    useful divisor exists (then the unchunked op runs; callers at that
    scale are constructed from image batches, so a divisor exists in
    practice — 15000 planes -> 3000).
    """
    limit = GLOBAL_STATS_PLANE_CHUNK
    if n <= limit:
        return None
    for k in range(limit - limit % channels, channels, -channels):
        if n % k == 0:
            return k
    return None


def default_use_pallas(device) -> bool:
    """Whether the hand-written kernels apply on ``device``.

    They are compiled for CUDA devices only; every other platform runs the
    XLA path.
    """
    return getattr(device, "platform", "cpu") == "gpu"


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """A named uint8->uint8 filter chain."""

    name: str
    filters: tuple

    @property
    def radius(self) -> int:
        """Total stencil radius (halo rows needed per side for row-split)."""
        return xblur.chain_radius(self.filters)

    @property
    def has_kernel(self) -> bool:
        """Whether the planar path has a hand-written kernel: a single
        separable Gaussian stage."""
        return len(self.filters) == 1 and self.filters[0].startswith(
            "gaussian")

    def kernel_name(self, use_pallas: bool, layout: str = "planar") -> str:
        """Which implementation the ``layout`` path runs."""
        if use_pallas and self.has_kernel and layout == "planar":
            return f"pallas-triton:{self.filters[0]}_planar"
        return "xla"

    def __call__(self, x: jax.Array) -> jax.Array:
        """XLA path on (..., H, W, C) uint8 batches."""
        return xblur.filter_chain(x, self.filters)

    def apply_planar(self, planes: jax.Array, *, use_pallas: bool = False,
                     h_pad: bool = True, interpret: bool = False
                     ) -> jax.Array:
        """Planar (N, H, W) path: the GPU kernel where one exists, else XLA.

        ``h_pad=False`` treats H as halo-padded by :attr:`radius` rows per
        side and returns the valid interior (row-split shard mode).
        """
        if use_pallas and self.has_kernel:
            return pallas_blur.gaussian_blur_planar_pallas(
                planes, xblur.FILTER_RADIUS[self.filters[0]], h_pad=h_pad,
                interpret=interpret,
            )
        return xblur.filter_chain(
            planes, self.filters, h_axis=-2, w_axis=-1, h_pad=h_pad
        )

    def apply_rows(self, rows: jax.Array, channels: int, *,
                   use_pallas: bool = False) -> jax.Array:
        """Interleaved rows (B, H, W*C) — the channels-last device layout.

        Always the rows-native XLA ops (see the module docstring);
        ``use_pallas`` is accepted so that callers treat every pipeline
        class alike.
        """
        assert rows.shape[-1] % channels == 0
        return xblur.filter_chain_rows(rows, channels, self.filters)

    def apply_nhwc(self, x: jax.Array, *, use_pallas: bool = False) -> jax.Array:
        """(B, H, W, C) wrapper over :meth:`apply_rows`."""
        b, h, w, c = x.shape
        out = self.apply_rows(x.reshape(b, h, w * c), c, use_pallas=use_pallas)
        return out.reshape(b, h, w, c)

    def nhwc_halo_fn(self, *, use_pallas: bool = False,
                     interpret: bool = False):
        """A halo-consuming NHWC block fn for row-split shard bodies.

        Takes (B, H + 2*radius, W, C) uint8 and returns (B, H, W, C); pair it
        with ``make_row_split_fn(..., local_fn=..., radius=pipeline.radius)``
        to run the planar kernels per shard on a device mesh.

        Single-filter pipelines only: a multi-stage chain applied in one
        halo-padded 'valid' pass would diverge within `radius` rows of the
        global top/bottom image edges (per-stage clamping at true edges
        cannot be reproduced from a replicated-edge halo), so chains raise —
        use :meth:`nhwc_clamp_fn` with
        ``make_row_split_fn(..., local_clamp=True)``, which is exact
        everywhere.
        """
        if len(self.filters) > 1:
            raise ValueError(
                f"pipeline {self.name!r} is a multi-stage chain: "
                "nhwc_halo_fn would be inexact at global image edges. Use "
                "nhwc_clamp_fn() with make_row_split_fn(..., "
                "local_clamp=True) instead."
            )

        def fn(block: jax.Array) -> jax.Array:
            b, h, w, c = block.shape
            planes = block.transpose(0, 3, 1, 2).reshape(b * c, h, w)
            out = self.apply_planar(
                planes, use_pallas=use_pallas, h_pad=False, interpret=interpret
            )
            oh = out.shape[1]
            return out.reshape(b, c, oh, w).transpose(0, 2, 3, 1)

        return fn

    def nhwc_clamp_fn(self, *, use_pallas: bool = False,
                      interpret: bool = False):
        """A clamp-mode NHWC block fn (rows in == rows out) for window slabs.

        Pair with ``make_row_split_fn(..., local_fn=..., local_clamp=True,
        radius=pipeline.radius)``: the shard body supplies a shifted window
        of real rows and keeps the owned slice, so the whole pipeline —
        chains included — is bit-exact everywhere (global edges included).
        """

        def fn(block: jax.Array) -> jax.Array:
            b, h, w, c = block.shape
            planes = block.transpose(0, 3, 1, 2).reshape(b * c, h, w)
            out = self.apply_planar(
                planes, use_pallas=use_pallas, h_pad=True, interpret=interpret
            )
            return out.reshape(b, c, h, w).transpose(0, 2, 3, 1)

        return fn


@dataclasses.dataclass(frozen=True)
class GlobalStatsPipeline:
    """A per-image global-statistics point pipeline (no stencil).

    ``name`` selects the op family in ``ops/equalize.py`` (functions
    ``<name>_planar/_rows/_nhwc``):

    - ``equalize``: per-channel 256-bin histogram -> monotone LUT — PIL
      ``ImageOps.equalize`` semantics, bit-exact, integer-only.
    - ``autocontrast``: per-channel min/max -> PIL float64 LUT,
      bit-exact via the precomputed (lo, hi) LUT cube. The ``cutoff``
      field (integer percent or (low, high) pair, PIL semantics) trims
      that much histogram mass from each end before picking the range —
      e.g. ``GlobalStatsPipeline("autocontrast", cutoff=2)`` is
      ``ImageOps.autocontrast(im, cutoff=2)``; the registry entry keeps
      cutoff=0.
    - ``contrast``: per-*image* Pillow luma mean -> (mean, value) LUT
      cube row — PIL ``ImageEnhance.Contrast(im).enhance(factor)``,
      bit-exact (fp32 truncating blend emulated host-side per factor).
      The ``factor`` field selects the strength; 1.0 (the registry
      default) is the identity, so pass a factor (CLI ``--factor``).
    - ``color``: per-pixel saturation blend with the pixel's own Pillow
      luma — PIL ``ImageEnhance.Color``, bit-exact (host-rounded fp32
      product table; see ops/equalize.py). Cross-channel, so it lives
      in this channels-aware family though it needs no global statistic
      (sharding is collective-free).
    - ``sharpness``: PIL ``ImageEnhance.Sharpness``, bit-exact — the
      SMOOTH-degenerate blend with PIL's border-copy rule. Border
      position is global, so row-split needs the hybrid halo+mask
      helper (``make_sharpness_row_split_fn``).
    - ``mode`` / ``mode5``: PIL ``ImageFilter.ModeFilter(3 | 5)``,
      bit-exact — pairwise equality-sum counts with a -1 sentinel for
      the TRUNCATED out-of-image window positions (PIL excludes them
      rather than clamping, so borders are global positions too;
      ``make_mode_row_split_fn``).

    There is no stencil radius: these ops need *whole-image* statistics,
    so halo-based row-split cannot run them (accessing :attr:`radius`
    raises with the pointer to the collective shard helpers,
    :func:`hipe_tpu.parallel.row_split.make_equalize_row_split_fn` /
    ``make_autocontrast_row_split_fn`` — psum of partial histograms and
    pmin/pmax of extrema respectively).

    This family has no hand-written kernel: every layout runs XLA, and
    ``use_pallas`` is accepted so that callers treat every pipeline class
    alike.
    """

    name: str
    filters: tuple = ()
    cutoff: object = 0  # autocontrast only: int percent or (low, high)
    # autocontrast only: PIL preserve_tone — one Pillow-luma-derived
    # range applied to all channels (per-image, like contrast).
    preserve_tone: bool = False
    factor: float = 1.0  # contrast only: blend strength (1.0 = identity)
    # contrast only: channel count of *planar* inputs (apply_planar gets
    # (B*C, H, W) with no channel info; rows/nhwc layouts carry their own).
    channels: int = 3

    has_kernel = False  # DeviceStreamRunner.autotune times XLA alone

    def __post_init__(self):
        if not self.filters:
            object.__setattr__(self, "filters", (self.name,))
        if self.cutoff != 0 and self.name != "autocontrast":
            raise ValueError(
                f"cutoff applies to 'autocontrast' only, not {self.name!r}"
            )
        if self.preserve_tone and self.name != "autocontrast":
            raise ValueError(
                f"preserve_tone applies to 'autocontrast' only, "
                f"not {self.name!r}"
            )
        if self.factor != 1.0 and self.name not in (
            "contrast", "color", "sharpness"
        ):
            raise ValueError(
                f"factor applies to 'contrast'/'color'/'sharpness' only, "
                f"not {self.name!r}"
            )
        if self.name == "autocontrast":
            from hipe_tpu.ops.equalize import _normalize_cutoff

            _normalize_cutoff(self.cutoff)  # fail at construction
        if self.name in ("contrast", "color", "sharpness") and not (
            isinstance(self.factor, (int, float)) and self.factor >= 0
        ):
            raise ValueError(
                f"{self.name} factor must be a number >= 0, "
                f"got {self.factor!r}"
            )

    def _op(self, layout: str):
        import functools

        from hipe_tpu.ops import equalize as eq

        fn = getattr(eq, f"{self.name}_{layout}")
        if self.name == "autocontrast":
            fn = functools.partial(fn, cutoff=self.cutoff,
                                   preserve_tone=self.preserve_tone)
            if self.preserve_tone and layout == "planar":
                fn = functools.partial(fn, channels=self.channels)
        elif self.name in ("contrast", "color", "sharpness"):
            fn = functools.partial(fn, factor=float(self.factor))
            if layout == "planar":
                fn = functools.partial(fn, channels=self.channels)
        return fn

    @property
    def radius(self) -> int:
        raise ValueError(
            f"pipeline {self.name!r} uses whole-image or cross-channel "
            "statistics and has "
            "no stencil radius: halo-based row-split (approach2) cannot "
            "run it. Use an image-level mode (approach1/stream/serve) or "
            "the collective (psum/pmin/pmax) shard helper "
            f"hipe_tpu.parallel.row_split.make_{self.name}_row_split_fn."
        )

    def __call__(self, x: jax.Array) -> jax.Array:
        """XLA path on (..., H, W, C) uint8 batches."""
        return self._op("nhwc")(x)

    def kernel_name(self, use_pallas: bool, layout: str = "planar") -> str:
        return "xla"

    def apply_planar(self, planes: jax.Array, *, use_pallas: bool = False,
                     h_pad: bool = True, interpret: bool = False
                     ) -> jax.Array:
        if not h_pad:
            raise ValueError(
                f"pipeline {self.name!r}: halo (h_pad=False) mode is "
                "meaningless for a global-statistics op"
            )
        fn = self._op("planar")
        n = planes.shape[0]
        chunk = _global_stats_chunk(n, self.channels)
        if chunk is not None:
            from jax import lax

            out = lax.map(
                fn, planes.reshape(n // chunk, chunk, *planes.shape[1:]))
            return out.reshape(planes.shape)
        return fn(planes)

    def apply_rows(self, rows: jax.Array, channels: int, *,
                   use_pallas: bool = False) -> jax.Array:
        return self._op("rows")(rows, channels)

    def apply_nhwc(self, x: jax.Array, *, use_pallas: bool = False) -> jax.Array:
        return self._op("nhwc")(x)

    def nhwc_halo_fn(self, **kw):
        self.radius  # raises with the explanation

    def nhwc_clamp_fn(self, **kw):
        self.radius  # raises with the explanation


PIPELINES = {
    "blur3": Pipeline("blur3", ("gaussian3",)),
    "blur5": Pipeline("blur5", ("gaussian5",)),
    "blur7": Pipeline("blur7", ("gaussian7",)),
    "blur9": Pipeline("blur9", ("gaussian9",)),
    "sharpen": Pipeline("sharpen", ("sharpen",)),
    "edge": Pipeline("edge", ("edge",)),
    "chain": Pipeline("chain", ("gaussian3", "sharpen", "edge")),
    "median": Pipeline("median", ("median",)),
    "denoise": Pipeline("denoise", ("median", "gaussian3")),
    # Morphology: 3x3 min/max rank filters (PIL MinFilter/MaxFilter
    # bit-exact) and the opening/closing compositions.
    "erode": Pipeline("erode", ("erode",)),
    "dilate": Pipeline("dilate", ("dilate",)),
    "open": Pipeline("open", ("erode", "dilate")),
    "close": Pipeline("close", ("dilate", "erode")),
    # 5x5/7x7/9x9 rank filters (PIL MedianFilter(n); see ops/blur.py).
    "median5": Pipeline("median5", ("median5",)),
    "median7": Pipeline("median7", ("median7",)),
    "median9": Pipeline("median9", ("median9",)),
    # Radius-0 PIL point stages (ImageOps closed forms); chainable with
    # any stencil stage on every path.
    "invert": Pipeline("invert", ("invert",)),
    "solarize": Pipeline("solarize", ("solarize",)),
    "posterize": Pipeline("posterize", ("posterize4",)),
    "equalize": GlobalStatsPipeline("equalize"),
    "autocontrast": GlobalStatsPipeline("autocontrast"),
    "contrast": GlobalStatsPipeline("contrast"),
    "color": GlobalStatsPipeline("color"),
    "sharpness": GlobalStatsPipeline("sharpness"),
    # PIL ImageFilter.ModeFilter — truncated (not clamped) windows, so
    # borders are global-position-dependent: this family, not FILTERS.
    "mode": GlobalStatsPipeline("mode"),
    "mode5": GlobalStatsPipeline("mode5"),
}

# The flagship model: the reference workload (3x3 Gaussian on image streams).
flagship = PIPELINES["blur3"]


def get(name_or_filters) -> Pipeline:
    if isinstance(name_or_filters, (Pipeline, GlobalStatsPipeline)):
        return name_or_filters  # already-constructed (e.g. parametrized)
    if isinstance(name_or_filters, str):
        if name_or_filters in PIPELINES:
            return PIPELINES[name_or_filters]
        if name_or_filters in xblur.FILTERS:
            # Bare filter names are valid pipelines of one stage (the CLI
            # advertises them as choices).
            return Pipeline(name_or_filters, (name_or_filters,))
        raise KeyError(
            f"unknown pipeline {name_or_filters!r} "
            f"(choose from {sorted(set(PIPELINES) | set(xblur.FILTERS))})"
        )
    unknown = [n for n in name_or_filters if n not in xblur.FILTERS]
    if unknown:
        # "equalize" is not chainable with stencil stages — it is a
        # whole-image statistics op with its own pipeline class.
        raise KeyError(
            f"unknown filter stage(s) {unknown!r} "
            f"(chainable stages: {sorted(xblur.FILTERS)})"
        )
    return Pipeline("+".join(name_or_filters), tuple(name_or_filters))
