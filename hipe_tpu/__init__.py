"""hipe_tpu — Heterogeneous Image-Processing Engine in JAX.

A JAX/XLA/Pallas framework with the capabilities of the reference OpenCL
heterogeneous Gaussian-blur engine
(CC834/Heterogeneous-OpenCL-Image-Processing-Engine). The reference's two
standalone C programs become two sharding/partitioning strategies over one
jitted pipeline:

- image-level distribution (reference `heterogeneous_blur.c`) ->
  :mod:`hipe_tpu.parallel.image_level` (batch-axis SPMD sharding over a
  device mesh, plus a heterogeneous CPU+GPU two-lane executor);
- split-image distribution (reference `split_image_blur.c`) ->
  :mod:`hipe_tpu.parallel.row_split` (H-axis sharding with halo exchange via
  `lax.ppermute`).

The OpenCL kernel (reference `gaussian_kernel.cl:19-72`) becomes integer-exact
XLA ops (:mod:`hipe_tpu.ops.blur`) and a Pallas Triton kernel for the GPU
(:mod:`hipe_tpu.ops.pallas_blur`); CImg's JPEG codec becomes a native C++
libjpeg codec (:mod:`hipe_tpu.io_.jpeg`).
"""

__version__ = "0.1.0"

from hipe_tpu.ops import blur as ops_blur  # noqa: F401
from hipe_tpu.ops.blur import (  # noqa: F401
    filter_chain,
    gaussian_blur,
    gaussian_blur3x3,
    sharpen3x3,
    sobel_edge,
)


def __getattr__(name):
    # Lazy heavyweight exports so `import hipe_tpu` stays cheap.
    if name in ("Engine", "EngineConfig"):
        from hipe_tpu.runtime import engine

        return getattr(engine, name)
    if name == "ServingPipeline":
        from hipe_tpu.runtime.serve import ServingPipeline

        return ServingPipeline
    if name in ("FleetEngine", "LaneSpec"):
        from hipe_tpu.runtime import fleet

        return getattr(fleet, name)
    if name == "DeviceStreamRunner":
        from hipe_tpu.runtime.device_stream import DeviceStreamRunner

        return DeviceStreamRunner
    if name in ("register_kernel_filter", "register_lut_filter",
                "register_rank_filter", "brightness_lut", "gamma_lut",
                "solarize_lut"):
        from hipe_tpu.ops import blur

        return getattr(blur, name)
    if name in ("PIPELINES", "Pipeline", "GlobalStatsPipeline", "flagship"):
        from hipe_tpu.models import pipelines

        return getattr(pipelines, name)
    if name in ("equalize_nhwc", "equalize_rows", "equalize_planar",
                "autocontrast_nhwc", "autocontrast_rows",
                "autocontrast_planar",
                "contrast_nhwc", "contrast_rows", "contrast_planar",
                "color_nhwc", "color_rows", "color_planar",
                "sharpness_nhwc", "sharpness_rows", "sharpness_planar",
                "mode_nhwc", "mode_rows", "mode_planar",
                "mode5_nhwc", "mode5_rows", "mode5_planar",
                "colorize_lut"):
        from hipe_tpu.ops import equalize

        return getattr(equalize, name)
    if name in ("make_row_split_fn", "make_weighted_row_split_fn",
                "make_equalize_row_split_fn",
                "make_autocontrast_row_split_fn",
                "make_contrast_row_split_fn", "make_color_row_split_fn",
                "make_sharpness_row_split_fn",
                "make_mode_row_split_fn"):
        from hipe_tpu.parallel import row_split

        return getattr(row_split, name)
    if name == "make_image_level_fn":
        from hipe_tpu.parallel.image_level import make_image_level_fn

        return make_image_level_fn
    if name == "transform_jpeg_bytes":
        from hipe_tpu.ops.jpeg_transform import transform_bytes

        return transform_bytes
    if name in ("resize_bilinear", "resize_bilinear_planar"):
        from hipe_tpu.ops import resize

        return getattr(resize, name)
    if name == "decode_coefficients":
        from hipe_tpu.ops.jpeg_decode import decode_coefficients

        return decode_coefficients
    if name == "encode_bytes_device":
        from hipe_tpu.ops.jpeg_encode import encode_bytes_device

        return encode_bytes_device
    raise AttributeError(name)
