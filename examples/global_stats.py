"""Global-statistics pipelines: equalize and autocontrast.

The stencil pipelines (blur/sharpen/edge/median) are local ops; these
two are driven by whole-image statistics and are bit-exact to PIL
(ImageOps.equalize / ImageOps.autocontrast — float64 LUT quirks
included). Shows the serving path, the cutoff variant, and the
SPMD row-split whose collective is a psum/pmin/pmax instead of a halo
exchange (run with XLA_FLAGS=--xla_force_host_platform_device_count=8
to see the 8-way mesh on CPU).

Usage: python examples/global_stats.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np

    from hipe_tpu.io_.jpeg import encode_bytes
    from hipe_tpu.utils.images import seeded_image

    payload = encode_bytes(seeded_image(256, 256), quality=90)

    # --- serving: decode -> equalize -> encode ---
    from hipe_tpu.runtime.serve import ServingPipeline

    serve = ServingPipeline("equalize")
    [out] = serve.process_batch([payload])
    print(f"equalize: {len(payload)} bytes in -> {len(out)} bytes out")

    # --- PIL exactness (the external oracle) ---
    import io

    from PIL import Image, ImageOps

    from hipe_tpu.io_ import jpeg

    px = serve.process_batch([payload], encode=False)[0]
    want = np.asarray(
        ImageOps.equalize(Image.open(io.BytesIO(payload)).convert("RGB"))
    )
    print("pixels == PIL ImageOps.equalize:", np.array_equal(px, want))

    # --- trimmed autocontrast (PIL cutoff semantics) ---
    from hipe_tpu.models.pipelines import GlobalStatsPipeline

    ac = ServingPipeline(GlobalStatsPipeline("autocontrast", cutoff=2))
    px_ac = ac.process_batch([payload], encode=False)[0]
    want_ac = np.asarray(
        ImageOps.autocontrast(
            Image.open(io.BytesIO(payload)).convert("RGB"), cutoff=2
        )
    )
    print("pixels == PIL autocontrast(cutoff=2):",
          np.array_equal(px_ac, want_ac))

    # --- SPMD: psum of per-shard histograms instead of halo exchange ---
    import jax

    from hipe_tpu.parallel.mesh import ROW_AXIS
    from hipe_tpu.parallel.row_split import make_equalize_row_split_fn
    from jax.sharding import Mesh

    devs = jax.devices("cpu")
    n = min(8, len(devs))
    mesh = Mesh(np.array(devs[:n]), (ROW_AXIS,))
    img = jpeg.decode_bytes(payload)
    fn = make_equalize_row_split_fn(mesh)
    sharded = np.asarray(fn(img[None]))[0]
    print(f"{n}-way row-sharded equalize == single device:",
          np.array_equal(sharded, px))
    return 0


if __name__ == "__main__":
    sys.exit(main())
