"""Image layout utilities, seeded inputs and stream simulation.

The reference decodes one JPEG with CImg (planar storage) and converts it to
interleaved RGB on the host (`heterogeneous_blur.c:106-137`), then simulates
a 5000-image stream by memcpy-replicating that image into each batch
(`heterogeneous_blur.c:431-442`). This module provides the equivalents:
NHWC<->planar conversion (the planar kernels take (N*C, H, W) planes, see
`hipe_tpu.ops.pallas_blur`), batched stream replication, and the seeded
stand-ins for the reference's two input photos, so that every entry point
runs without files from outside the repository.
"""

from __future__ import annotations

import numpy as np

# The reference's two input assets, by geometry (H, W).
REFERENCE_320 = (240, 320)
REFERENCE_256 = (256, 256)


def hwc_to_planar(batch: np.ndarray) -> np.ndarray:
    """(B, H, W, C) -> (B*C, H, W): one contiguous plane per image-channel."""
    b, h, w, c = batch.shape
    return np.ascontiguousarray(batch.transpose(0, 3, 1, 2)).reshape(b * c, h, w)


def planar_to_hwc(planes: np.ndarray, channels: int) -> np.ndarray:
    """(B*C, H, W) -> (B, H, W, C); inverse of :func:`hwc_to_planar`."""
    n, h, w = planes.shape
    b = n // channels
    return np.ascontiguousarray(planes.reshape(b, channels, h, w).transpose(0, 2, 3, 1))


def replicate_stream(image: np.ndarray, count: int) -> np.ndarray:
    """Simulate an image stream by replication (heterogeneous_blur.c:431-442)."""
    return np.broadcast_to(image, (count,) + image.shape)


def seeded_image(h: int = 256, w: int = 256, c: int = 3,
                 seed: int = 0) -> np.ndarray:
    """A photo-like uint8 HWC image made from ``seed``.

    Smooth low-frequency gradients with mild sensor-like noise, so that it
    compresses like a photograph under JPEG (the reference's inputs are
    photos); the same seed always gives the same pixels.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((h, w, c), np.uint8)
    for ch in range(c):
        fy, fx, gy, gx = rng.uniform(0.3, 3.0, 4)
        p1, p2 = rng.uniform(0.0, 2 * np.pi, 2)
        base = (128.0
                + 70.0 * np.sin(2 * np.pi * (fy * yy / h + fx * xx / w) + p1)
                + 35.0 * np.cos(2 * np.pi * (gy * yy / h - gx * xx / w) + p2))
        noise = rng.normal(0.0, 6.0, (h, w))
        out[..., ch] = np.clip(np.rint(base + noise), 0, 255)
    return out


def load_test_image(path: str | None = None, *, size=REFERENCE_256,
                    seed: int = 0) -> np.ndarray:
    """Decode ``path`` to HWC uint8, or make a seeded image of ``size``."""
    if path is None:
        return seeded_image(*size, seed=seed)
    from hipe_tpu.io_.jpeg import decode_file

    return decode_file(path)


def checker_image(h: int = 64, w: int = 64, c: int = 3, seed: int = 0) -> np.ndarray:
    """Deterministic random uint8 test image (no file IO needed)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
