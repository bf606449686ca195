"""Pallas (Triton route) kernel for the planar separable Gaussian blur.

The reference's device kernel (`gaussian_kernel.cl:19-72`) is one OpenCL
work-item per pixel. This kernel keeps that shape at tile granularity: one
program owns one (plane, row tile, column tile) of a planar (N, H, W) uint8
stream and gathers its own stencil neighbourhood straight from device
memory, ``2 * radius`` halo rows included. Border indices are clamped
before the load, which is the reference's clamp-to-edge rule
(`gaussian_kernel.cl:56-57`); tiles are powers of two and stores past the
plane's edge are masked off. Nothing is staged in scratch memory and no
state passes between programs.

Numerics: each tap product is accumulated in float32 with the 2-D binomial
normalisation ``2^-4r`` applied once at the end. Every partial sum is an
integer below ``2^(8 + 4r) <= 2^24``, so float32 holds it exactly and the
truncating conversion equals the integer form ``(sum tap_i * x_i) >> 4r``
that :mod:`hipe_tpu.ops.blur` computes (see :mod:`hipe_tpu.ops.reference`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from hipe_tpu.ops.blur import binomial_taps

# Measured on an H100 (700 W) at 15000 planes of 256x256: 8-row tiles on
# 8 warps were the fastest of the (4-32 rows) x (4, 8 warps) grid; other
# shapes within ~3% of it traded places from run to run.
DEFAULT_BLOCK_H = 8
NUM_WARPS = 8
MAX_BLOCK_W = 256


def _blur_kernel(x_ref, o_ref, *, taps: tuple, h: int, w: int, out_h: int,
                 block_h: int, block_w: int, h_pad: bool):
    p = pl.program_id(0)
    rows = pl.program_id(1) * block_h + jnp.arange(block_h, dtype=jnp.int32)
    cols = pl.program_id(2) * block_w + jnp.arange(block_w, dtype=jnp.int32)
    r = (len(taps) - 1) // 2
    src_cols = [jnp.clip(cols + (dx - r), 0, w - 1)[None, :]
                for dx in range(len(taps))]
    acc = None
    for dy, ty in enumerate(taps):
        # Halo mode: the input carries r extra rows per side, so output
        # row i reads input rows i .. i + 2r with no clamp at the top.
        src = rows + (dy - r if h_pad else dy)
        src = jnp.clip(src, 0, h - 1)[:, None]
        part = None
        for dx, tx in enumerate(taps):
            v = plgpu.load(x_ref.at[p, src, src_cols[dx]])
            v = v.astype(jnp.int32).astype(jnp.float32)
            term = v if tx == 1 else v * float(tx)
            part = term if part is None else part + term
        term = part if ty == 1 else part * float(ty)
        acc = term if acc is None else acc + term
    out = (acc * (1.0 / (1 << (4 * r)))).astype(jnp.int32).astype(jnp.uint8)
    mask = (rows[:, None] < out_h) & (cols[None, :] < w)
    plgpu.store(o_ref.at[p, rows[:, None], cols[None, :]], out, mask=mask)


@functools.partial(
    jax.jit,
    static_argnames=("radius", "h_pad", "block_h", "interpret"),
)
def gaussian_blur_planar_pallas(
    x: jax.Array,
    radius: int = 1,
    *,
    h_pad: bool = True,
    block_h: int = DEFAULT_BLOCK_H,
    interpret: bool = False,
) -> jax.Array:
    """Separable binomial blur over planar (N, H, W) uint8, Triton route.

    ``radius=1`` is the reference 3x3 kernel (`gaussian_kernel.cl:36-41`).
    ``h_pad=False`` assumes ``radius`` halo rows are present on each side
    of H and returns the valid interior (``H - 2 * radius`` rows), the
    row-split shard mode. ``interpret=True`` runs the kernel in the Pallas
    interpreter (CPU tests); otherwise it compiles for a CUDA device only.
    """
    assert x.dtype == jnp.uint8 and x.ndim == 3, (x.dtype, x.shape)
    assert block_h > 0 and block_h & (block_h - 1) == 0, block_h
    taps, _ = binomial_taps(radius)
    n, h, w = x.shape
    out_h = h if h_pad else h - 2 * radius
    assert out_h > 0, (h, radius)
    block_w = min(MAX_BLOCK_W, pl.next_power_of_2(w))
    kernel = functools.partial(
        _blur_kernel, taps=taps, h=h, w=w, out_h=out_h, block_h=block_h,
        block_w=block_w, h_pad=h_pad,
    )
    return pl.pallas_call(
        kernel,
        grid=(n, pl.cdiv(out_h, block_h), pl.cdiv(w, block_w)),
        out_shape=jax.ShapeDtypeStruct((n, out_h, w), jnp.uint8),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        backend="triton",
        name=f"gaussian{2 * radius + 1}_planar",
    )(x)
