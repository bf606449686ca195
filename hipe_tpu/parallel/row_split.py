"""Approach 2: H-axis SPMD sharding with device-to-device halo exchange.

The reference splits every image's rows between two devices with a 1-row halo
realized as overlapping host-buffer reads
(`split_image_blur.c:144-173,516,537`); seam exactness comes from computing
the halo rows on both devices and discarding them at read-back. On a device
mesh the halo moves between devices instead (NVLink on a GPU host): each shard `lax.ppermute`s its boundary rows to its
neighbors inside one jitted SPMD program, blurs its halo-padded slab in
"valid" mode, and keeps exactly its own output rows — bit-identical to the
unsplit blur for every split point (the reference's seam-correctness
property, SURVEY.md §3.2), generalized from 2 devices/halo=1 to N devices /
halo=radius (5x5, 9x9, filter chains).
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hipe_tpu.ops import blur as xblur
from hipe_tpu.parallel.mesh import ROW_AXIS


def exchange_halo(
    x: jax.Array,
    radius: int,
    axis_name: str,
    h_axis: int = 1,
) -> jax.Array:
    """Halo-pad a local row shard: neighbors' rows by ppermute, edge clamp at ends.

    `x` is the per-device block of an H-sharded array (inside shard_map).
    Returns `x` extended by `radius` rows on each side of `h_axis`:
    interior shards receive their neighbors' boundary rows via
    `lax.ppermute`; the first/last shard replicate their own edge row,
    matching the reference kernel's clamp-to-edge semantics
    (`gaussian_kernel.cl:56-57`).
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    h = h_axis

    top_rows = lax.slice_in_dim(x, 0, radius, axis=h)
    nloc = x.shape[h]
    bot_rows = lax.slice_in_dim(x, nloc - radius, nloc, axis=h)

    if n > 1:
        # Shift down: shard i sends its bottom rows to shard i+1 (its halo-top).
        from_prev = lax.ppermute(
            bot_rows, axis_name, [(i, i + 1) for i in range(n - 1)]
        )
        # Shift up: shard i sends its top rows to shard i-1 (its halo-bottom).
        from_next = lax.ppermute(
            top_rows, axis_name, [(i + 1, i) for i in range(n - 1)]
        )
    else:
        from_prev = jnp.zeros_like(bot_rows)
        from_next = jnp.zeros_like(top_rows)

    # Global edges: clamp-to-edge == replicate own first/last row.
    first = lax.slice_in_dim(x, 0, 1, axis=h)
    last = lax.slice_in_dim(x, nloc - 1, nloc, axis=h)
    edge_top = jnp.concatenate([first] * radius, axis=h) if radius > 1 else first
    edge_bot = jnp.concatenate([last] * radius, axis=h) if radius > 1 else last

    top = jnp.where(idx == 0, edge_top, from_prev)
    bot = jnp.where(idx == n - 1, edge_bot, from_next)
    return jnp.concatenate([top, x, bot], axis=h)


def exchange_window(
    x: jax.Array,
    radius: int,
    axis_name: str,
    h_axis: int = 1,
) -> tuple[jax.Array, jax.Array]:
    """Shifted-window slab: own+2R *real* rows per shard, exact for chains.

    Unlike :func:`exchange_halo` (which pads the first/last shard with
    replicated edge rows — exact for single filters but wrong for chains,
    whose per-stage clamp at true image edges cannot be reproduced by input
    replication), this returns a window of real image rows
    ``[clip(start - R, 0, H - own - 2R), +own+2R)`` plus the offset of the
    shard's owned region inside it. Running a clamp-mode chain of total
    radius R on the slab and keeping ``[keep, keep+own)`` is bit-exact
    everywhere: clamp either lands on a true image edge (correct semantics)
    or on a slab boundary >= R rows from every kept row (wrongness from a
    clamped non-edge boundary penetrates at most R rows after the full
    chain — the reference's compute-then-discard slab argument,
    `split_image_blur.c:526,537-539`).

    Requires each shard to own >= 2*radius rows (edge shards borrow 2R rows
    from their single neighbor).
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    h = h_axis
    own = x.shape[h]
    if n == 1:
        # The whole image: clamp mode is already exact, no window needed.
        return x, jnp.zeros((), jnp.int32)
    r2 = 2 * radius
    assert own >= r2, (
        f"window exchange needs >= {r2} rows/shard, got {own}"
    )
    top2 = lax.slice_in_dim(x, 0, r2, axis=h)
    bot2 = lax.slice_in_dim(x, own - r2, own, axis=h)
    from_prev = lax.ppermute(
        bot2, axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    from_next = lax.ppermute(
        top2, axis_name, [(i + 1, i) for i in range(n - 1)]
    )
    cand = jnp.concatenate([from_prev, x, from_next], axis=h)
    # First shard's window starts at the true top edge (offset past the
    # garbage from_prev rows); last shard's window ends at the true bottom
    # edge; interior windows center on the owned region.
    offset = jnp.where(idx == 0, r2, jnp.where(idx == n - 1, 0, radius))
    keep = jnp.where(idx == 0, 0, jnp.where(idx == n - 1, r2, radius))
    slab = lax.dynamic_slice_in_dim(cand, offset, own + r2, axis=h)
    return slab, keep


def make_row_split_fn(
    mesh: Mesh,
    names: Sequence[str] = ("gaussian3",),
    *,
    axis_name: str = ROW_AXIS,
    batch_axis: str | None = None,
    local_fn: Callable | None = None,
    radius: int | None = None,
    local_clamp: bool = False,
    channels: int | None = None,
) -> Callable[[jax.Array], jax.Array]:
    """Build the jitted row-split pipeline over `mesh`.

    Input/output: (B, H, W, C) uint8 — or, with `channels=C`, interleaved
    rows (B, H, W*C), the channels-last device layout — H sharded over `axis_name` (and B
    over `batch_axis` if given: DP x SP on a 2-D mesh). `names` is a filter
    chain from :data:`hipe_tpu.ops.blur.FILTERS`; alternatively pass
    `local_fn` together with its `radius`:

    - ``local_clamp=False`` (default): `local_fn` is a valid-mode
      halo-consuming fn (rows in == rows out + 2*radius, e.g. the planar
      kernel with ``h_pad=False``). Exact for single filters; multi-stage
      chains must NOT use this mode (per-stage clamp at global image edges
      cannot be reproduced from a replicated-edge halo — use
      ``local_clamp=True``).
    - ``local_clamp=True``: `local_fn` is a clamp-mode fn (rows in == rows
      out, e.g. ``Pipeline.nhwc_clamp_fn``) of total stencil radius
      `radius`; the shard body feeds it a shifted window of real rows
      (:func:`exchange_window`) and keeps the owned slice — bit-exact
      everywhere including global edges, for chains too.
    """
    names = tuple(names)

    if local_fn is None and channels is not None:
        # Rows-layout chain with per-stage halo exchange.
        def local(block: jax.Array) -> jax.Array:
            for name in names:
                r_i = xblur.FILTER_RADIUS[name]
                # Radius-0 point stages need no halo (and exchange_halo's
                # edge-replication path assumes radius >= 1).
                padded = (exchange_halo(block, r_i, axis_name, h_axis=1)
                          if r_i else block)
                block = xblur.ROWS_FILTERS[name](
                    padded, channels, h_pad=False
                )
            return block

    elif local_fn is not None and local_clamp:
        # Clamp-mode local fn over a shifted window of real rows: exact for
        # chains at global edges (see exchange_window).
        assert radius is not None, "local_fn requires an explicit radius"

        def local(block: jax.Array) -> jax.Array:
            slab, keep = exchange_window(block, radius, axis_name, h_axis=1)
            out = local_fn(slab)
            if out.shape[1] == block.shape[1]:  # n == 1: no window added
                return out
            return lax.dynamic_slice_in_dim(
                out, keep, block.shape[1], axis=1
            )

    elif local_fn is not None:
        # Single custom stage (e.g. a Pallas kernel): one halo exchange of
        # its radius, then the valid-mode kernel.
        assert radius is not None, "local_fn requires an explicit radius"

        def local(block: jax.Array) -> jax.Array:
            return local_fn(exchange_halo(block, radius, axis_name, h_axis=1))

    else:
        # Chains exchange halos per stage: at global image edges each stage
        # must clamp its *own input* (the previous stage's output), so a
        # single summed-radius exchange of the raw input would be wrong
        # at the first/last shard. Interior seams would be exact either
        # way; per-stage exchange keeps edges exact too, at the cost of
        # one tiny ppermute per stage.
        def local(block: jax.Array) -> jax.Array:
            for name in names:
                r_i = xblur.FILTER_RADIUS[name]
                padded = (exchange_halo(block, r_i, axis_name, h_axis=1)
                          if r_i else block)
                block = xblur.FILTERS[name](
                    padded, h_axis=1, w_axis=2, h_pad=False
                )
            return block

    pspec_in = P(batch_axis, axis_name)
    # check_vma=False: Pallas calls inside the shard body don't carry
    # varying-mesh-axes metadata on their output avals.
    shard_fn = jax.shard_map(
        local, mesh=mesh, in_specs=pspec_in, out_specs=pspec_in,
        check_vma=False,
    )

    @jax.jit
    def step(x: jax.Array) -> jax.Array:
        x = lax.with_sharding_constraint(x, NamedSharding(mesh, pspec_in))
        return shard_fn(x)

    return step


def row_split_blur(
    x: jax.Array,
    mesh: Mesh,
    names: Sequence[str] = ("gaussian3",),
    **kw,
) -> jax.Array:
    """One-shot convenience wrapper around :func:`make_row_split_fn`."""
    return make_row_split_fn(mesh, names, **kw)(x)


def make_weighted_row_split_fn(
    mesh: Mesh,
    names: Sequence[str] = ("gaussian3",),
    weights: Sequence[float] | None = None,
    *,
    axis_name: str = ROW_AXIS,
    batch_axis: str | None = None,
    local_fn: Callable | None = None,
    radius: int | None = None,
) -> Callable[[jax.Array], jax.Array]:
    """Ratio-weighted (uneven) row sharding over a homogeneous mesh.

    The reference's core knob is an uneven row split by measured device
    speed (`split_image_blur.c:144-154`, ratio 0.837 splits 240 rows 39/201
    between CPU and GPU). SPMD shard_map requires uniform block shapes, so
    uneven ownership is realized with padded windows: rows are apportioned
    to shards by `weights` (largest-remainder, every shard >= 1 row), the H
    axis is relayouted — one static gather — into uniform per-shard windows
    of ``S + 2R`` *real* rows (S = max share, R = chain radius), each shard
    runs the clamp-mode chain on its window, and a second static gather
    reassembles exactly the owned rows. Same exactness argument as
    :func:`exchange_window`: clamp lands on true edges or >= R rows from
    every kept row, so the result is bit-identical to the unsplit chain for
    any weights.

    The two relayout gathers cost ~2 extra HBM passes — worth it only when
    shard speeds genuinely differ (the reference's heterogeneous scenario;
    e.g. mixed-generation meshes). For homogeneous meshes use
    :func:`make_row_split_fn` (even split, halo exchange only).

    `local_fn` optionally overrides the per-shard clamp-mode fn (signature
    (B, S+2R, W, C) -> same shape, e.g. ``Pipeline.nhwc_clamp_fn()``)
    together with its total `radius`.
    """
    names = tuple(names)
    n = mesh.shape[axis_name]
    if weights is None:
        weights = [1.0] * n
    assert len(weights) == n, (len(weights), n)
    r_total = radius if local_fn is not None else xblur.chain_radius(names)
    assert r_total is not None

    if local_fn is None:
        def local_fn(block: jax.Array) -> jax.Array:
            return xblur.filter_chain(block, names, h_axis=1, w_axis=2,
                                      h_pad=True)

    from hipe_tpu.parallel import partitioner as pt

    pspec = P(batch_axis, axis_name)

    @jax.jit
    def step(x: jax.Array) -> jax.Array:
        import numpy as np

        b, height, w, c = x.shape
        if n == 1:
            # Whole image on one shard: clamp mode alone is exact; no
            # window, gathers, or exchange needed.
            return local_fn(x)
        segs = pt.row_partition(height, list(weights), halo=0)
        counts = [sg.out_rows for sg in segs]
        # The window needs max_share + 2R real rows; for extreme weights
        # (or short images) cap the largest shares and redistribute rows
        # to the smallest — weights are a performance hint, exactness
        # never depends on the exact share split.
        cap = height - 2 * r_total
        assert n * cap >= height, (
            f"image too short for a weighted {n}-way split of radius "
            f"{r_total}: H={height}"
        )
        while max(counts) > cap:
            i = max(range(n), key=lambda k: counts[k])
            j = min(range(n), key=lambda k: counts[k])
            excess = counts[i] - cap
            counts[i] -= excess
            counts[j] += excess
        starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        s = max(counts)
        win = s + 2 * r_total
        win_starts = np.clip(starts - r_total, 0, height - win)
        in_idx = np.concatenate(
            [np.arange(ws, ws + win) for ws in win_starts]
        ).astype(np.int32)
        out_idx = np.concatenate(
            [
                i * win + (starts[i] - win_starts[i]) + np.arange(counts[i])
                for i in range(n)
            ]
        ).astype(np.int32)

        xp = jnp.take(x, jnp.asarray(in_idx), axis=1)
        xp = lax.with_sharding_constraint(xp, NamedSharding(mesh, pspec))
        shard_fn = jax.shard_map(
            local_fn, mesh=mesh, in_specs=pspec, out_specs=pspec,
            check_vma=False,
        )
        out_p = shard_fn(xp)
        out = jnp.take(out_p, jnp.asarray(out_idx), axis=1)
        return lax.with_sharding_constraint(out, NamedSharding(mesh, pspec))

    return step


def _make_stats_row_split_fn(
    mesh: Mesh,
    plane_lut_fn,
    *,
    axis_name: str,
    batch_axis: str | None,
    channels: int | None,
) -> Callable[[jax.Array], jax.Array]:
    """Shared shard scaffolding for the global-statistics pipelines.

    ``plane_lut_fn(planes, c) -> (N, 256) LUTs`` runs inside the shard body
    and performs whatever collective its statistic needs (psum of
    histograms, pmin/pmax of extrema); everything else — the rows/NHWC
    layout handling, the LUT apply, the shard_map plumbing — is
    identical between the ops and lives here once.
    """
    from hipe_tpu.ops import equalize as eq

    def local(block: jax.Array) -> jax.Array:
        if channels is not None:
            b, hh, lane = block.shape
            w = lane // channels
            x = block.reshape(b, hh, w, channels)
        else:
            x = block
            b, hh, w = x.shape[0], x.shape[1], x.shape[2]
        c = x.shape[-1]
        planes = x.transpose(0, 3, 1, 2).reshape(b * c, hh, w)
        lut = plane_lut_fn(planes, c)
        out = eq.apply_lut(planes, lut)
        out = out.reshape(b, c, hh, w).transpose(0, 2, 3, 1)
        return out.reshape(block.shape)

    pspec = P(batch_axis, axis_name)
    shard_fn = jax.shard_map(
        local, mesh=mesh, in_specs=pspec, out_specs=pspec, check_vma=False
    )

    @jax.jit
    def step(x: jax.Array) -> jax.Array:
        x = lax.with_sharding_constraint(x, NamedSharding(mesh, pspec))
        return shard_fn(x)

    return step


def make_equalize_row_split_fn(
    mesh: Mesh,
    *,
    axis_name: str = ROW_AXIS,
    batch_axis: str | None = None,
    channels: int | None = None,
) -> Callable[[jax.Array], jax.Array]:
    """Histogram equalization over H-sharded images: psum, not halo.

    The stencil pipelines shard rows with `lax.ppermute` halo exchange;
    equalization (``ops/equalize.py``) is driven by *whole-image*
    statistics, so the SPMD pattern inverts: each shard computes the
    256-bin histograms of its own rows, one ``lax.psum`` over the row
    axis produces the global per-(image, channel) histograms on every
    shard, each shard builds the identical LUT and applies it to its
    local rows. One tiny collective ((B*C, 256) int32) per
    batch — bit-identical to the single-device
    :func:`hipe_tpu.ops.equalize.equalize_nhwc` for every shard count.

    Input/output: (B, H, W, C) uint8 — or rows (B, H, W*C) with
    ``channels=C`` — H sharded over ``axis_name`` (and B over
    ``batch_axis`` if given: DP x SP).
    """
    from hipe_tpu.ops import equalize as eq

    n_shards = mesh.shape[axis_name]

    def plane_luts(planes: jax.Array, c: int) -> jax.Array:
        hist = lax.psum(eq.histogram_planes(planes), axis_name)
        npix = planes.shape[1] * n_shards * planes.shape[2]
        return eq.equalize_lut(hist, npix)

    return _make_stats_row_split_fn(
        mesh, plane_luts, axis_name=axis_name, batch_axis=batch_axis,
        channels=channels,
    )


def make_autocontrast_row_split_fn(
    mesh: Mesh,
    *,
    axis_name: str = ROW_AXIS,
    batch_axis: str | None = None,
    channels: int | None = None,
    cutoff=0,
    preserve_tone: bool = False,
) -> Callable[[jax.Array], jax.Array]:
    """Autocontrast over H-sharded images: pmin/pmax of local extrema.

    The companion of :func:`make_equalize_row_split_fn` for the second
    global-statistics op (``ops/equalize.py`` autocontrast, PIL float64
    LUT bit-exact): each shard reduces its rows to per-(image, channel)
    min/max, one ``lax.pmin`` + ``lax.pmax`` over the row axis yields the
    global extrema on every shard, the (lo, hi)-indexed LUT row is
    gathered from the precomputed cube and applied locally. Two scalar
    collectives per (image, channel) — bit-identical to the single-device
    :func:`hipe_tpu.ops.equalize.autocontrast_nhwc`.

    ``cutoff`` (PIL percent trim) needs the full histogram rather than
    bare extrema, so it switches the collective to the equalize-style
    ``lax.psum`` of per-shard histograms before the exact trim walk.
    """
    from hipe_tpu.ops import equalize as eq

    c0, c1 = eq._normalize_cutoff(cutoff)

    def plane_luts(planes: jax.Array, c: int) -> jax.Array:
        if preserve_tone:
            # PIL preserve_tone: ONE Pillow-luma-derived range per image,
            # shared by all channels (psum/pmin/pmax over the luma).
            b = planes.shape[0] // c
            src = eq.pil_luma(
                planes.reshape(b, c, planes.shape[1], planes.shape[2])
            )
        else:
            src = planes
        if c0 or c1:
            hist = lax.psum(eq.histogram_planes(src), axis_name)
            lo, hi = eq.autocontrast_extrema(hist, (c0, c1))
        else:
            flat = src.reshape(src.shape[0], -1)
            lo = lax.pmin(flat.min(axis=1), axis_name)
            hi = lax.pmax(flat.max(axis=1), axis_name)
        lut = eq.autocontrast_lut(lo, hi)
        return jnp.repeat(lut, c, axis=0) if preserve_tone else lut

    return _make_stats_row_split_fn(
        mesh, plane_luts, axis_name=axis_name, batch_axis=batch_axis,
        channels=channels,
    )


def make_contrast_row_split_fn(
    mesh: Mesh,
    *,
    factor: float = 1.0,
    axis_name: str = ROW_AXIS,
    batch_axis: str | None = None,
    channels: int | None = None,
) -> Callable[[jax.Array], jax.Array]:
    """PIL-exact contrast over H-sharded images: psum of luma histograms.

    Contrast (``ops/equalize.py`` contrast_*, ImageEnhance.Contrast
    bit-exact) needs one statistic per *image* — the rounded mean of the
    Pillow fixed-point luma — shared by all channels. Each shard
    histograms the luma of its local rows, one ``lax.psum`` yields the
    global (B, 256) histogram, every shard derives the identical rounded
    mean (exact int32 threshold-sum arithmetic), gathers the factor's
    (mean, value) LUT row and applies it to all its channels'
    rows — bit-identical to the single-device
    :func:`hipe_tpu.ops.equalize.contrast_nhwc` for every shard count.
    """
    from hipe_tpu.ops import equalize as eq

    n_shards = mesh.shape[axis_name]

    def plane_luts(planes: jax.Array, c: int) -> jax.Array:
        b = planes.shape[0] // c
        img4 = planes.reshape(b, c, planes.shape[1], planes.shape[2])
        l = eq.pil_luma(img4)
        hist = lax.psum(eq.histogram_planes(l), axis_name)
        npix = planes.shape[1] * n_shards * planes.shape[2]
        mean_i = eq.luma_mean_round_half(hist, npix)
        lut = eq.contrast_lut(mean_i, factor)
        return jnp.repeat(lut, c, axis=0)

    return _make_stats_row_split_fn(
        mesh, plane_luts, axis_name=axis_name, batch_axis=batch_axis,
        channels=channels,
    )


def make_color_row_split_fn(
    mesh: Mesh,
    *,
    factor: float = 1.0,
    axis_name: str = ROW_AXIS,
    batch_axis: str | None = None,
    channels: int | None = None,
) -> Callable[[jax.Array], jax.Array]:
    """PIL-exact saturation blend over H-sharded images: no collective.

    Color (``ops/equalize.py`` color_*, ImageEnhance.Color bit-exact)
    blends each pixel with its own luma — purely local, so the shard
    body is a plain per-shard apply (the degenerate case of the
    global-statistics shard family: the "collective" is empty). Provided
    for API symmetry with the other channels-aware ops.
    """
    from hipe_tpu.ops import equalize as eq

    def local(block: jax.Array) -> jax.Array:
        if channels is not None:
            b, hh, lane = block.shape
            return eq.color_rows(block, channels, factor=factor)
        b, hh, w, c = block.shape
        rows = block.reshape(b, hh, w * c)
        return eq.color_rows(rows, c, factor=factor).reshape(block.shape)

    pspec = P(batch_axis, axis_name)
    shard_fn = jax.shard_map(
        local, mesh=mesh, in_specs=pspec, out_specs=pspec, check_vma=False
    )

    @jax.jit
    def step(x: jax.Array) -> jax.Array:
        x = lax.with_sharding_constraint(x, NamedSharding(mesh, pspec))
        return shard_fn(x)

    return step


def make_sharpness_row_split_fn(
    mesh: Mesh,
    *,
    factor: float = 1.0,
    axis_name: str = ROW_AXIS,
    batch_axis: str | None = None,
    channels: int | None = None,
) -> Callable[[jax.Array], jax.Array]:
    """PIL-exact sharpness over H-sharded images: halo + border masks.

    Sharpness (``ops/equalize.py`` sharpness_*, ImageEnhance.Sharpness
    bit-exact) is a radius-1 stencil blend with PIL's kernel-filter
    border rule: border pixels pass through unfiltered. The border is a
    *global* position — a translation-variant wrinkle the clamp-window
    stencil machinery doesn't model — so the shard body combines both
    SPMD patterns: one ``ppermute`` halo row per side (``exchange_halo``)
    for the smooth, then ``lax.axis_index`` masks so only the true first/
    last shard pass their global edge row through. Bit-identical to the
    single-device :func:`hipe_tpu.ops.equalize.sharpness_nhwc`.
    """
    from hipe_tpu.ops import blur as xblur
    from hipe_tpu.ops.equalize import _sharpness_blend

    def local(block: jax.Array) -> jax.Array:
        if channels is not None:
            b, hh, lane = block.shape
            w = lane // channels
            x = block.reshape(b, hh, w, channels)
        else:
            x = block
            b, hh, w = x.shape[0], x.shape[1], x.shape[2]
        padded = exchange_halo(x, 1, axis_name, h_axis=1)
        sm = xblur.FILTERS["pil_smooth"](
            padded, h_axis=-3, w_axis=-2, h_pad=False)
        out = _sharpness_blend(x.astype(jnp.int32), sm.astype(jnp.int32),
                               factor)
        n = lax.axis_size(axis_name)
        idx = lax.axis_index(axis_name)
        ys = jnp.arange(hh)[:, None, None]
        xs = jnp.arange(w)[None, :, None]
        border = (
            ((idx == 0) & (ys == 0))
            | ((idx == n - 1) & (ys == hh - 1))
            | (xs == 0) | (xs == w - 1)
        )
        out = jnp.where(border, x, out)
        return out.reshape(block.shape)

    pspec = P(batch_axis, axis_name)
    shard_fn = jax.shard_map(
        local, mesh=mesh, in_specs=pspec, out_specs=pspec, check_vma=False
    )

    @jax.jit
    def step(x: jax.Array) -> jax.Array:
        x = lax.with_sharding_constraint(x, NamedSharding(mesh, pspec))
        return shard_fn(x)

    return step


def make_mode_row_split_fn(
    mesh: Mesh,
    *,
    size: int = 3,
    axis_name: str = ROW_AXIS,
    batch_axis: str | None = None,
    channels: int | None = None,
) -> Callable[[jax.Array], jax.Array]:
    """PIL-exact ModeFilter over H-sharded images: halo + sentinel masks.

    The mode filter (``ops/equalize.py`` mode_*, ImageFilter.ModeFilter
    bit-exact) counts the size x size window TRUNCATED at the global
    image bounds — out-of-image positions are excluded, not clamped.
    Like sharpness's border-copy rule, that makes borders a *global*
    position: the shard body exchanges real halo rows via ``ppermute``
    (``exchange_halo``), then ``lax.axis_index`` masks rewrite only the
    true first/last shard's outer halo rows to the -1 sentinel the mode
    core treats as "no value here". Bit-identical to the single-device
    :func:`hipe_tpu.ops.equalize.mode_nhwc`.
    """
    from hipe_tpu.ops.equalize import _MODE_SENTINEL, _mode_core_i32

    if size not in (3, 5):
        raise ValueError(f"mode filter size must be 3 or 5, got {size}")
    r = size // 2

    def local(block: jax.Array) -> jax.Array:
        if channels is not None:
            b, hh, lane = block.shape
            w = lane // channels
            x = block.reshape(b, hh, w, channels)
        else:
            x = block
            b, hh, w = x.shape[0], x.shape[1], x.shape[2]
        planes = x.transpose(0, 3, 1, 2)  # (b, c, hh, w)
        padded = exchange_halo(planes, r, axis_name, h_axis=2)
        xi = padded.astype(jnp.int32)
        n = lax.axis_size(axis_name)
        idx = lax.axis_index(axis_name)
        ys = jnp.arange(hh + 2 * r)[:, None]
        outside = ((idx == 0) & (ys < r)) | (
            (idx == n - 1) & (ys >= hh + r))
        xi = jnp.where(outside, _MODE_SENTINEL, xi)
        xi = jnp.pad(xi, ((0, 0), (0, 0), (0, 0), (r, r)),
                     constant_values=_MODE_SENTINEL)
        out = _mode_core_i32(xi, size)
        return out.transpose(0, 2, 3, 1).reshape(block.shape)

    pspec = P(batch_axis, axis_name)
    shard_fn = jax.shard_map(
        local, mesh=mesh, in_specs=pspec, out_specs=pspec, check_vma=False
    )

    @jax.jit
    def step(x: jax.Array) -> jax.Array:
        x = lax.with_sharding_constraint(x, NamedSharding(mesh, pspec))
        return shard_fn(x)

    return step
