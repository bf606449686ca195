"""Lossless DCT-domain transforms: rotate/flip JPEGs without recompression.

The jpegtran analog (ops/jpeg_transform.py): coefficient grids are
permuted/sign-masked/transposed as jitted tensor ops — no IDCT, no
requantization, metadata (Exif/ICC/COM) carried over. Demonstrates the
single-stream API, the batched serving-scale path, and the involution
property (rot90 x4 == the canonical rewrite of the original).

Usage: python examples/lossless_transform.py [input.jpg] [num_images]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    path = sys.argv[1] if len(sys.argv) > 1 else None
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 64

    if path is None:
        from hipe_tpu.io_.jpeg import encode_bytes
        from hipe_tpu.utils.images import REFERENCE_320, seeded_image

        data = encode_bytes(seeded_image(*REFERENCE_320), quality=90)
    else:
        with open(path, "rb") as f:
            data = f.read()

    from hipe_tpu.io_ import jpeg
    from hipe_tpu.ops import jpeg_transform as jt

    rot = jt.transform_bytes(data, "rot90")
    print(f"rot90: {len(data)} -> {len(rot)} bytes "
          f"({jpeg.decode_bytes(data).shape} -> "
          f"{jpeg.decode_bytes(rot).shape}), no recompression")

    co = jpeg.read_coefficients(data)
    canon = jpeg.write_coefficients(
        [c.coefs for c in co.components], co.width, co.height,
        subsampling="420",
        qtables=[c.qtable for c in co.components],
        markers=jpeg.read_markers(data))
    r = data
    for _ in range(4):
        r = jt.transform_bytes(r, "rot90")
    print(f"rot90 x4 == canonical rewrite: {r == canon}")

    import time

    payloads = [data] * n
    jt.transform_batch(payloads[:2], "rot90")  # compile outside the clock
    t0 = time.perf_counter()
    out = jt.transform_batch(payloads, "rot90")
    dt = time.perf_counter() - t0
    print(f"batched rot90: {n} images in {dt * 1000:.0f} ms "
          f"({n / dt:.0f} img/s)")
    assert all(o == out[0] for o in out)

    # jpegtran -grayscale: chroma dropped, luma coefficients verbatim —
    # decoding the output equals libjpeg's JCS_GRAYSCALE decode of the
    # original color stream.
    import numpy as np

    gray = jt.transform_bytes(data, "grayscale")
    same = np.array_equal(
        jpeg.decode_bytes(gray), jpeg.decode_bytes(data, force_gray=True)
    )
    print(f"grayscale drop == JCS_GRAYSCALE decode of original: {same} "
          f"({len(data)} -> {len(gray)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
