"""Fused decode -> blur -> encode serving (mixed-resolution stream).

Usage: python examples/serving.py [batches] [batch_size]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    n_batches = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    batch_size = int(sys.argv[2]) if len(sys.argv) > 2 else 8

    from hipe_tpu.io_.jpeg import encode_bytes
    from hipe_tpu.utils.images import REFERENCE_256, REFERENCE_320, seeded_image

    a = encode_bytes(seeded_image(*REFERENCE_256), quality=90)
    b = encode_bytes(seeded_image(*REFERENCE_320), quality=90)

    from hipe_tpu.runtime.serve import ServingPipeline

    serve = ServingPipeline("blur3")
    batches = [[(a if i % 2 == 0 else b)] * batch_size
               for i in range(n_batches)]
    for i, encoded in enumerate(serve.run(batches)):
        print(f"batch {i}: {len(encoded)} JPEGs, "
              f"{sum(len(e) for e in encoded)} bytes out")
    s = serve.stats
    print(f"{s.images} images in {s.wall_ms:.0f} ms "
          f"({s.img_per_s:.0f} img/s); decode {s.decode_ms:.0f} ms, "
          f"device {s.device_ms:.0f} ms, encode {s.encode_ms:.0f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
