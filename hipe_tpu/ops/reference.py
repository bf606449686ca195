"""NumPy oracle for the reference device kernels.

This module is the *semantic* oracle: it reproduces, in NumPy, the observable
behavior of the reference OpenCL kernel (`gaussian_kernel.cl:19-72`):

- per-pixel 3x3 convolution with fixed binomial weights {1,2,1}x{1,2,1}/16
  (`gaussian_kernel.cl:36-41`),
- clamp-to-edge border handling (`gaussian_kernel.cl:56-57`),
- float32 accumulation followed by a *truncating* (not rounding) cast to
  uint8 (`gaussian_kernel.cl:70`),
- per-channel independence over interleaved RGB (`gaussian_kernel.cl:44-63`).

Key numerics fact used throughout this framework: because every weight is a
multiple of 2^-4 (more generally 2^-s for binomial kernels) and every input is
a uint8, every partial sum in fp32 is exact, so the fp32-accumulate +
truncating-cast pipeline is *bit-identical* to integer arithmetic
``(sum_i w_int_i * x_i) >> s``. The whole framework therefore uses integer
kernels on the device and this oracle verifies both formulations agree.
"""

from __future__ import annotations

import numpy as np

# Integer binomial taps (1, 2, 1): the reference's fp32 weights times 16
# (`gaussian_kernel.cl:36-41`).
BLUR3_TAPS = np.array([1, 2, 1], dtype=np.int64)
BLUR3_SHIFT = 4  # 2D normalization 16 = 2**4


def binomial_taps(radius: int) -> tuple[np.ndarray, int]:
    """Integer binomial taps of length 2*radius+1 and the per-axis shift.

    radius=1 -> (1,2,1), shift 2 per axis (4 for the 2D kernel);
    radius=2 -> (1,4,6,4,1), shift 4; radius=4 -> C(8,k), shift 8.
    These define the "large-radius separable Gaussian" family (5x5 / 9x9) of
    BASELINE.json config 4 — the reference itself only ships the 3x3.
    """
    taps = np.array([1], dtype=np.int64)
    for _ in range(2 * radius):
        taps = np.convolve(taps, [1, 1])
    shift = 2 * radius  # sum(taps) == 2**(2*radius)
    return taps, shift


def _pad_edge(img: np.ndarray, radius: int) -> np.ndarray:
    pad = [(radius, radius), (radius, radius)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="edge")


def gaussian_blur_float_oracle(img: np.ndarray, radius: int = 1) -> np.ndarray:
    """Float path: literal re-expression of the OpenCL kernel's semantics.

    fp32 accumulate of uint8 * (tap/2**(2s)) weights, truncating uint8 cast,
    matching `gaussian_kernel.cl:44-70`. Supports (H, W) or (H, W, C) uint8.
    """
    assert img.dtype == np.uint8
    taps, shift = binomial_taps(radius)
    norm = np.float32(1.0 / (1 << (2 * shift)))
    k2d = (taps[:, None] * taps[None, :]).astype(np.float32) * norm
    H, W = img.shape[:2]
    padded = _pad_edge(img, radius).astype(np.float32)
    acc = np.zeros(img.shape, dtype=np.float32)
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            acc += k2d[dy, dx] * padded[dy : dy + H, dx : dx + W]
    return acc.astype(np.uint8)  # truncating cast, as (unsigned char)sum


def gaussian_blur_int_oracle(img: np.ndarray, radius: int = 1) -> np.ndarray:
    """Integer path: separable ``(colpass(rowpass(x))) >> 2*shift``.

    Bit-identical to :func:`gaussian_blur_float_oracle` (proved in tests);
    this is the formulation the device kernels implement.
    """
    assert img.dtype == np.uint8
    taps, shift = binomial_taps(radius)
    H, W = img.shape[:2]
    padded = _pad_edge(img, radius).astype(np.int64)
    # Row pass (along W), then column pass (along H).
    row = np.zeros((H + 2 * radius,) + img.shape[1:], dtype=np.int64)
    for dx in range(2 * radius + 1):
        row += taps[dx] * padded[:, dx : dx + W]
    acc = np.zeros(img.shape, dtype=np.int64)
    for dy in range(2 * radius + 1):
        acc += taps[dy] * row[dy : dy + H]
    return (acc >> (2 * shift)).astype(np.uint8)


def sharpen3x3_oracle(img: np.ndarray) -> np.ndarray:
    """3x3 unsharp kernel [[0,-1,0],[-1,5,-1],[0,-1,0]], clamp to [0,255].

    The reference has no sharpen; this defines the framework's filter-chain
    semantics (BASELINE.json config 4): integer arithmetic, clamp-to-edge
    borders, saturating uint8 store.
    """
    assert img.dtype == np.uint8
    H, W = img.shape[:2]
    p = _pad_edge(img, 1).astype(np.int64)
    c = p[1 : 1 + H, 1 : 1 + W]
    up = p[0:H, 1 : 1 + W]
    dn = p[2 : 2 + H, 1 : 1 + W]
    lf = p[1 : 1 + H, 0:W]
    rt = p[1 : 1 + H, 2 : 2 + W]
    out = 5 * c - up - dn - lf - rt
    return np.clip(out, 0, 255).astype(np.uint8)


def sobel_edge_oracle(img: np.ndarray) -> np.ndarray:
    """Sobel |gx|+|gy| edge magnitude, clamp to [0,255].

    Defined per-channel (channel-independent like the blur). Uses the L1
    magnitude so the op stays integer-exact on every backend.
    """
    assert img.dtype == np.uint8
    H, W = img.shape[:2]
    p = _pad_edge(img, 1).astype(np.int64)

    def sl(dy, dx):
        return p[dy : dy + H, dx : dx + W]

    gx = (sl(0, 2) + 2 * sl(1, 2) + sl(2, 2)) - (sl(0, 0) + 2 * sl(1, 0) + sl(2, 0))
    gy = (sl(2, 0) + 2 * sl(2, 1) + sl(2, 2)) - (sl(0, 0) + 2 * sl(0, 1) + sl(0, 2))
    return np.clip(np.abs(gx) + np.abs(gy), 0, 255).astype(np.uint8)


def median3x3_oracle(img: np.ndarray) -> np.ndarray:
    """3x3 median per channel, clamp-to-edge — straight np.median loops.

    Oracle for ops/blur.py median3x3 (the Paeth min/max network); the
    median of nine integers is the 5th order statistic, so np.median is
    exact here.
    """
    h, w, _ = img.shape
    xp = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    views = np.stack(
        [xp[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    )
    return np.median(views, axis=0).astype(np.uint8)


def _rank3x3_oracle(img: np.ndarray, reduce_fn) -> np.ndarray:
    h, w = img.shape[:2]
    pad = ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2)
    xp = np.pad(img, pad, mode="edge")
    views = np.stack(
        [xp[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    )
    return reduce_fn(views, axis=0).astype(np.uint8)


def erode3x3_oracle(img: np.ndarray) -> np.ndarray:
    """3x3 minimum (morphological erosion), clamp-to-edge, per channel.

    Oracle for ops/blur.py erode3x3. Clamp-to-edge padding makes this
    bit-identical to PIL's ``ImageFilter.MinFilter(3)`` (rank filters in
    PIL replicate the border row/column before ranking), which the tests
    cross-check as an independent oracle.
    """
    return _rank3x3_oracle(img, np.min)


def dilate3x3_oracle(img: np.ndarray) -> np.ndarray:
    """3x3 maximum (morphological dilation) — PIL ``MaxFilter(3)``."""
    return _rank3x3_oracle(img, np.max)


def rank_oracle(img: np.ndarray, size: int, rank: int) -> np.ndarray:
    """PIL ``RankFilter(size, rank)`` with clamp-to-edge (== PIL's border
    replication): sort the (size^2) window values, take index ``rank``."""
    r = size // 2
    h, w = img.shape[:2]
    pad = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    xp = np.pad(img, pad, mode="edge")
    views = np.stack(
        [xp[dy:dy + h, dx:dx + w] for dy in range(size) for dx in range(size)]
    )
    return np.sort(views, axis=0)[rank]


def kernel_oracle(img: np.ndarray, taps, scale: int, offset: float
                  ) -> np.ndarray:
    """Exact-arithmetic PIL ``ImageFilter.Kernel`` semantics, int64.

    Taps in PIL order (row 0 first; PIL applies kernel rows bottom-up, so
    the correlation uses the row-reversed table); clamp-to-edge borders
    (PIL copies border pixels unfiltered — equality vs PIL holds on the
    interior); round-half-up via the integer identity
    floor(acc/scale + offset + 1/2) = (2*acc + scale*(2*offset+1)) // (2*scale).
    Oracle for ops/blur.py register_kernel_filter stages.
    """
    size = int(round(len(taps) ** 0.5))
    r = size // 2
    h, w = img.shape[:2]
    pad = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    xp = np.pad(img, pad, mode="edge").astype(np.int64)
    t = np.array(taps, np.int64).reshape(size, size)[::-1]
    acc = np.zeros(img.shape, np.int64)
    for dy in range(size):
        for dx in range(size):
            acc += t[dy, dx] * xp[dy:dy + h, dx:dx + w]
    off2 = int(2 * offset)
    assert off2 == 2 * offset
    num = 2 * acc + int(scale) * (off2 + 1)
    return np.clip(num // (2 * int(scale)), 0, 255).astype(np.uint8)


def _resize_axis_oracle(x: np.ndarray, n_out: int) -> np.ndarray:
    """One bilinear pass on the LAST axis of int array x (ops/resize.py
    contract: half-pixel mapping, Q14 weights, round-half-up >> 14)."""
    n_in = x.shape[-1]
    j = np.arange(n_out, dtype=np.float64)
    src = np.clip((j + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    wr = np.rint((src - lo) * (1 << 14)).astype(np.int64)
    wl = (1 << 14) - wr
    acc = x[..., lo].astype(np.int64) * wl + x[..., hi].astype(np.int64) * wr
    return (acc + (1 << 13)) >> 14


def resize_bilinear_oracle(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(..., H, W, C) uint8 -> (..., oh, ow, C): per-pixel gathers, no band
    matrices — the independent oracle for ops/resize.py."""
    t = np.moveaxis(img, -1, -3)  # (..., C, H, W)
    if t.shape[-1] != ow:
        t = _resize_axis_oracle(t, ow).astype(np.uint8)
    if t.shape[-2] != oh:
        t = np.swapaxes(
            _resize_axis_oracle(np.swapaxes(t, -1, -2), oh), -1, -2)
    return np.moveaxis(t.astype(np.uint8), -3, -1)
