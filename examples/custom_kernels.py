"""User-defined convolution kernels and the PIL builtin filter family.

Registers a custom kernel stage, chains it with builtin stages and the
PIL presets, and demonstrates the exactness contract: bit-identical to
PIL ImageFilter on the interior for exact-class scales, deviations
confined to exact .5 ties otherwise (the engine's deterministic
round-half-up vs PIL's fp32 coin flip).

    JAX_PLATFORMS=cpu python examples/custom_kernels.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import jax.numpy as jnp

    from hipe_tpu.models import pipelines as plib
    from hipe_tpu.ops import blur as xblur
    from hipe_tpu.ops import reference as oracle

    from hipe_tpu.utils.images import REFERENCE_320, seeded_image

    img = seeded_image(*REFERENCE_320)

    # 1. Register a custom kernel: taps exactly as you'd hand them to
    #    PIL's ImageFilter.Kernel (row 0 first), integer scale, offset.
    xblur.register_kernel_filter(
        "soft", (1, 2, 1, 2, 4, 2, 1, 2, 1), scale=16)
    pipe = plib.get(["soft", "pil_emboss", "sharpen"])
    print(f"pipeline {pipe.name!r}: radius {pipe.radius} "
          f"(soft 1 + pil_emboss 1 + sharpen 1)")
    out = np.asarray(pipe(jnp.asarray(img)))
    want = oracle.sharpen3x3_oracle(oracle.kernel_oracle(
        oracle.kernel_oracle(img, (1, 2, 1, 2, 4, 2, 1, 2, 1), 16, 0.0),
        *xblur.PIL_PRESETS["pil_emboss"]))
    print("chain vs NumPy oracle:",
          "bit-exact" if np.array_equal(out, want) else "MISMATCH")

    # 2. The 10 PIL builtins are pre-registered as pil_* stages; verify
    #    one exact-class preset against PIL itself (interior: PIL copies
    #    border pixels through unfiltered, the engine clamps to edge).
    from PIL import Image, ImageFilter

    got = np.asarray(xblur.FILTERS["pil_smooth"](jnp.asarray(img)))
    pil = np.stack([
        np.asarray(Image.fromarray(img[:, :, c]).filter(ImageFilter.SMOOTH))
        for c in range(3)], axis=-1)
    same = np.array_equal(got[1:-1, 1:-1], pil[1:-1, 1:-1])
    print("pil_smooth (odd scale 13) vs PIL interior:",
          "bit-exact" if same else "MISMATCH")

    # 3. An even non-dyadic scale (DETAIL, scale 6): PIL's own fp32 tap
    #    normalization coin-flips exact .5 ties; the engine rounds them
    #    up deterministically. Every deviation is +-1 on a tie.
    got = np.asarray(xblur.FILTERS["pil_detail"](jnp.asarray(img)))
    pil = np.stack([
        np.asarray(Image.fromarray(img[:, :, c]).filter(ImageFilter.DETAIL))
        for c in range(3)], axis=-1)
    diff = got[1:-1, 1:-1].astype(int) - pil[1:-1, 1:-1].astype(int)
    print(f"pil_detail (even non-dyadic scale 6) vs PIL: "
          f"{(diff != 0).mean() * 100:.2f}% of pixels differ, "
          f"max |diff| = {np.abs(diff).max()} (all exact .5 ties)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
