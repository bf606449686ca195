"""The PIL ImageEnhance quartet + colorize, every one bit-exact.

Brightness (a static-LUT stage), Contrast (per-image luma mean),
Color (per-pixel saturation blend), Sharpness (SMOOTH-degenerate blend
with PIL's border rule), and ImageOps.colorize — each compared against
PIL itself on a seeded 320x240 image.

    JAX_PLATFORMS=cpu python examples/enhance.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import jax.numpy as jnp
    from PIL import Image, ImageEnhance, ImageOps

    from hipe_tpu.models.pipelines import GlobalStatsPipeline
    from hipe_tpu.ops import blur as xblur
    from hipe_tpu.ops import equalize as eq

    from hipe_tpu.utils.images import REFERENCE_320, seeded_image

    img = seeded_image(*REFERENCE_320)
    pim = Image.fromarray(img)

    # Brightness: a 256-entry LUT stage (PIL's fp32 truncating blend
    # emulated host-side), chainable with any stencil.
    xblur.register_lut_filter("ex_dim", xblur.brightness_lut(0.7))
    got = np.asarray(xblur.FILTERS["ex_dim"](jnp.asarray(img)))
    want = np.asarray(ImageEnhance.Brightness(pim).enhance(0.7))
    print("Brightness(0.7):", "bit-exact"
          if np.array_equal(got, want) else "MISMATCH")

    # Contrast / Color / Sharpness: channels-aware pipelines with a
    # factor field (CLI: serve <name> --factor F).
    for name, enhancer, factor in (
        ("contrast", ImageEnhance.Contrast, 1.5),
        ("color", ImageEnhance.Color, 0.4),
        ("sharpness", ImageEnhance.Sharpness, 1.8),
    ):
        pipe = GlobalStatsPipeline(name, factor=factor)
        got = np.asarray(pipe(jnp.asarray(img[None])))[0]
        want = np.asarray(enhancer(pim).enhance(factor))
        print(f"{name.capitalize()}({factor}):", "bit-exact"
              if np.array_equal(got, want) else "MISMATCH")

    # Colorize: grayscale -> color wedge (the gray-output mirror in
    # serving: ServingPipeline(colorize=...) / --colorize navy:#ffe0a0).
    gray = np.asarray(pim.convert("L"))
    lut3 = eq.colorize_lut("navy", "#ffe0a0", mid="maroon")
    got = eq.colorize_oracle(gray, lut3)
    want = np.asarray(ImageOps.colorize(
        Image.fromarray(gray), "navy", "#ffe0a0", mid="maroon"))
    print("Colorize(navy -> #ffe0a0 via maroon):", "bit-exact"
          if np.array_equal(got, want) else "MISMATCH")
    return 0


if __name__ == "__main__":
    sys.exit(main())
