"""Input streaming: the simulated image stream and JPEG decode pipelines.

The reference simulates a 5000-image stream by memcpy-replicating one decoded
JPEG into a contiguous per-batch buffer (`heterogeneous_blur.c:418-442`),
the last batch being the remainder. This module reproduces that (zero-copy
on host via broadcasting — the real copy happens at host->device transfer,
which is the part that matters on an accelerator) and
adds real decode streams: batched multithreaded JPEG decode through the
native codec, including the mixed-resolution stream of BASELINE.json
config 5.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def batch_sizes(num_images: int, batch_size: int) -> list[int]:
    """Batch schedule incl. remainder batch (heterogeneous_blur.c:423-427)."""
    out = []
    left = num_images
    while left > 0:
        out.append(min(batch_size, left))
        left -= out[-1]
    return out


class ReplicatedStream:
    """Simulated stream: one decoded image replicated num_images times."""

    def __init__(self, image: np.ndarray, num_images: int, batch_size: int):
        assert image.dtype == np.uint8 and image.ndim == 3
        self.image = image
        self.num_images = num_images
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        for bc in batch_sizes(self.num_images, self.batch_size):
            # Host-side zero-copy replication; densified at device transfer.
            yield np.broadcast_to(self.image, (bc,) + self.image.shape)

    def batch_shapes(self) -> list[tuple]:
        """Batch shapes without materializing batches (warmup planning)."""
        return [
            (bc,) + self.image.shape
            for bc in batch_sizes(self.num_images, self.batch_size)
        ]


class JpegStream:
    """Real stream: decode JPEG byte payloads batch-by-batch (native codec)."""

    def __init__(self, payloads: list[bytes], batch_size: int,
                 num_threads: int | None = None):
        self.payloads = payloads
        self.batch_size = batch_size
        self.num_threads = num_threads
        self.num_images = len(payloads)

    def __iter__(self) -> Iterator[np.ndarray]:
        from hipe_tpu.io_.jpeg import decode_batch

        for start in range(0, len(self.payloads), self.batch_size):
            chunk = self.payloads[start : start + self.batch_size]
            yield decode_batch(chunk, num_threads=self.num_threads)

    def batch_shapes(self) -> list[tuple]:
        """Batch shapes from one header decode — no full stream decode."""
        from hipe_tpu.io_.jpeg import decode_bytes

        h, w, c = decode_bytes(self.payloads[0]).shape
        return [
            (bc, h, w, c)
            for bc in batch_sizes(self.num_images, self.batch_size)
        ]


class Prefetcher:
    """Background-thread stream prefetch (double-buffered host staging).

    Wraps any batch stream so the next batch is produced (e.g. JPEG-decoded)
    while the engine processes the current one — the host-side analog of the
    reference's async transfer/compute overlap (`heterogeneous_blur.c:
    482-535`). `depth` bounds the number of batches staged ahead.
    """

    def __init__(self, stream, depth: int = 2):
        self.stream = stream
        self.depth = depth

    def batch_shapes(self) -> list[tuple]:
        return self.stream.batch_shapes()

    def __iter__(self) -> Iterator[np.ndarray]:
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=self.depth)
        _END = object()

        def producer():
            # A producer exception (e.g. a corrupt JPEG mid-stream) must
            # reach the consumer, not silently truncate the stream — the
            # engine would otherwise report throughput over images it never
            # processed.
            try:
                for batch in self.stream:
                    q.put(batch)
                q.put(_END)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            yield item
        t.join()


class MixedResolutionStream:
    """Alternating-resolution stream (e.g. 256x256 + 320x240 batches).

    Batches are homogeneous in shape (a requirement for static-shape jit);
    the stream interleaves per-resolution batches round-robin, covering the
    mixed-resolution pipeline of BASELINE.json config 5.
    """

    def __init__(self, images: list[np.ndarray], num_images: int,
                 batch_size: int):
        assert images, "need at least one resolution"
        self.images = images
        self.num_images = num_images
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        sizes = batch_sizes(self.num_images, self.batch_size)
        for i, bc in enumerate(sizes):
            img = self.images[i % len(self.images)]
            yield np.broadcast_to(img, (bc,) + img.shape)

    def batch_shapes(self) -> list[tuple]:
        sizes = batch_sizes(self.num_images, self.batch_size)
        return [
            (bc,) + self.images[i % len(self.images)].shape
            for i, bc in enumerate(sizes)
        ]
