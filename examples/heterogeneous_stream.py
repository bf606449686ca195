"""Heterogeneous CPU+GPU stream processing — the reference's headline demo.

Runs Approach 1 (image-level ratio split) and Approach 2 (row split + halo)
back-to-back on a small stream and prints both 8-section reports.

Usage: python examples/heterogeneous_stream.py [num_images] [ratio]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from hipe_tpu.runtime.engine import Engine, EngineConfig  # noqa: E402
from hipe_tpu.utils.images import REFERENCE_320, seeded_image  # noqa: E402


def main() -> int:
    num = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    ratio = float(sys.argv[2]) if len(sys.argv) > 2 else 0.5
    image = np.ascontiguousarray(seeded_image(*REFERENCE_320))
    for approach in (1, 2):
        eng = Engine(EngineConfig(approach=approach, mode="both",
                                  gpu_ratio=ratio, batch_size=50,
                                  num_images=num))
        eng.run(image=image)
        print(eng.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
