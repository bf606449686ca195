"""Blur one JPEG — the `gaussian_blur.c` single-device baseline equivalent.

Usage: python examples/single_image.py [in.jpg] [out.jpg] [pipeline]
(without in.jpg, a seeded 256x256 image)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from hipe_tpu.io_.jpeg import encode_file  # noqa: E402
from hipe_tpu.models import pipelines as plib  # noqa: E402
from hipe_tpu.utils.images import load_test_image  # noqa: E402


def main() -> int:
    src = sys.argv[1] if len(sys.argv) > 1 else None
    dst = sys.argv[2] if len(sys.argv) > 2 else "blurred.jpg"
    pipe = plib.get(sys.argv[3] if len(sys.argv) > 3 else "blur3")

    img = load_test_image(src)
    print(f"{src or 'seeded image'}: {img.shape[1]}x{img.shape[0]}, "
          f"{img.shape[2]} channels")
    out = pipe.apply_nhwc(jnp.asarray(img[None]))
    encode_file(__import__("numpy").asarray(out)[0], dst)
    print(f"wrote {dst} ({pipe.name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
