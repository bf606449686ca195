"""Approach 1: image-level (data-parallel) SPMD sharding.

The reference routes whole images to one of two devices by a tunable ratio
(`heterogeneous_blur.c:449-458,489-497`). On a homogeneous
device mesh the ratio degenerates to an even batch-axis shard: XLA inserts
zero communication — each device blurs its own images. The ratio capability
itself (asymmetric devices, measured-time feedback) lives on in the
heterogeneous CPU+GPU executor (`hipe_tpu.runtime.engine`), exactly as the reference pairs
a fast and a slow device.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import jax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hipe_tpu.ops import blur as xblur
from hipe_tpu.parallel.mesh import DATA_AXIS


def make_image_level_fn(
    mesh: Mesh,
    names: Sequence[str] = ("gaussian3",),
    *,
    axis_name: str = DATA_AXIS,
    local_fn: Callable | None = None,
) -> Callable[[jax.Array], jax.Array]:
    """Jitted data-parallel pipeline: (B, H, W, C) uint8, B sharded.

    B must be divisible by the mesh size (the reference likewise slices each
    batch into integer per-device image counts, heterogeneous_blur.c:449-458).
    """
    names = tuple(names)
    if local_fn is None:
        local_fn = functools.partial(
            xblur.filter_chain, names=names, h_axis=1, w_axis=2
        )
    sharding = NamedSharding(mesh, P(axis_name))

    @jax.jit
    def step(x: jax.Array) -> jax.Array:
        x = lax.with_sharding_constraint(x, sharding)
        out = local_fn(x)
        return lax.with_sharding_constraint(out, sharding)

    return step


def shard_batch(x, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Place a host batch onto the mesh, sharded along the leading axis."""
    return jax.device_put(x, NamedSharding(mesh, P(axis_name)))
