"""Weighted N-lane device fleet (generalized heterogeneous execution).

Runs a 4-lane fleet on virtual CPU devices (or whatever devices exist),
shows the weighted row partition and the measured-feedback weight
recommendation.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        python examples/fleet.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import jax

    from hipe_tpu.runtime.fleet import FleetEngine, LaneSpec

    devs = jax.devices("cpu") or jax.devices()
    n = min(4, len(devs))
    lanes = [
        LaneSpec(device=devs[i % len(devs)], weight=w, name=f"lane{i}")
        for i, w in enumerate([1.0, 2.0, 2.0, 1.0][:n])
    ]
    from hipe_tpu.utils.images import REFERENCE_320, seeded_image

    image = seeded_image(*REFERENCE_320)
    for approach in (1, 2):
        eng = FleetEngine(lanes, approach=approach, batch_size=50,
                          num_images=200)
        eng.run(image=image.copy())
        print(eng.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
