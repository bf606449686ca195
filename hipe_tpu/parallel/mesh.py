"""Device meshes and discovery — the L2 "device runtime" analog.

The reference enumerates OpenCL platforms/devices, taking the first CPU and
first GPU found (`heterogeneous_blur.c:142-191`) and
hard-failing if a requested device is missing (`:181-184`). Here "platforms"
are JAX backends (the accelerator + cpu) and multi-device scale comes from
`jax.sharding.Mesh` over the accelerator's devices (flat: the cards of one
host are joined all to all); the host CPU backend plays
the reference's CPU-OpenCL-device role for heterogeneous execution.
"""

from __future__ import annotations

import dataclasses

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"  # image-level (Approach 1) sharding axis
ROW_AXIS = "rows"  # row-split (Approach 2) sharding axis


@dataclasses.dataclass(frozen=True)
class DeviceInventory:
    """Discovered devices, mirroring the reference's discovery banner."""

    cpu_devices: list
    accel_devices: list
    accel_platform: str | None

    def describe(self) -> str:
        lines = []
        for i, plat in enumerate(self._platforms()):
            lines.append(f"Platform {i}: {plat}")
        if self.cpu_devices:
            lines.append(f"CPU device: {self.cpu_devices[0].device_kind}")
        if self.accel_devices:
            lines.append(
                f"Accelerator device: {self.accel_devices[0].device_kind} "
                f"x{len(self.accel_devices)}"
            )
        return "\n".join(lines)

    def _platforms(self) -> list[str]:
        plats = []
        if self.cpu_devices:
            plats.append("jax-cpu (host)")
        if self.accel_platform:
            plats.append(f"jax-{self.accel_platform}")
        return plats


def discover() -> DeviceInventory:
    """Enumerate available backends (analog of clGetPlatformIDs/DeviceIDs)."""
    try:
        cpus = jax.devices("cpu")
    except RuntimeError:
        cpus = []
    accel, platform = [], None
    default = jax.devices()
    if default and default[0].platform != "cpu":
        accel, platform = default, default[0].platform
    return DeviceInventory(cpu_devices=cpus, accel_devices=accel,
                           accel_platform=platform)


def require_device(inv: DeviceInventory, kind: str):
    """Return the first device of `kind` ('cpu'|'accel'); hard-fail if absent

    (mirrors heterogeneous_blur.c:181-184)."""
    devs = inv.cpu_devices if kind == "cpu" else inv.accel_devices
    if not devs:
        raise RuntimeError(f"Error: no {kind} device found")
    return devs[0]


def make_mesh(
    n: int | None = None,
    axis: str = DATA_AXIS,
    devices: list | None = None,
) -> Mesh:
    """1-D mesh over the first `n` accelerator (or given) devices."""
    devs = devices if devices is not None else jax.devices()
    n = n or len(devs)
    assert n <= len(devs), (n, len(devs))
    import numpy as np

    return Mesh(np.asarray(devs[:n]), (axis,))


def make_mesh_2d(
    n_data: int,
    n_rows: int,
    devices: list | None = None,
) -> Mesh:
    """2-D mesh (data, rows): batch sharding x row-split sharding combined."""
    devs = devices if devices is not None else jax.devices()
    assert n_data * n_rows <= len(devs)
    import numpy as np

    grid = np.asarray(devs[: n_data * n_rows]).reshape(n_data, n_rows)
    return Mesh(grid, (DATA_AXIS, ROW_AXIS))


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading (batch) axis; everything else replicated."""
    return NamedSharding(mesh, P(axis))


def row_sharding(mesh: Mesh, axis: str = ROW_AXIS) -> NamedSharding:
    """Shard H of an (B, H, W, C) batch; batch axis may also be sharded."""
    if DATA_AXIS in mesh.axis_names and axis in mesh.axis_names:
        return NamedSharding(mesh, P(DATA_AXIS, axis))
    return NamedSharding(mesh, P(None, axis))
