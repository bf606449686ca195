"""Command-line interface, mirroring the reference programs.

Reference usage (`README.md:41-63`):
    ./heterogeneous_blur [cpu|gpu|both] [gpu_ratio] [batch_size]
    ./split_image_blur [gpu_ratio] [batch_size]

Here:
    python -m hipe_tpu.cli approach1 [both|cpu|gpu|tpu] [gpu_ratio] [batch]
    python -m hipe_tpu.cli approach2 [gpu_ratio] [batch]

('gpu' names the accelerator lane, the JAX default device; 'tpu' is an
older alias.)
Invalid ratio/batch values warn and fall back to the defaults, exactly like
the reference parser (`heterogeneous_blur.c:52-86`). Extra options are flags
so the positional grammar stays reference-compatible. Without --image every
mode runs on a seeded photo-like image of the reference's input size
(--seed picks it); nothing is read from outside the repository.
"""

from __future__ import annotations

import argparse
import csv
import sys

import numpy as np

from hipe_tpu.parallel import mesh as meshlib
from hipe_tpu.parallel import partitioner as pt
from hipe_tpu.profiling.report import CSV_COLUMNS, to_csv_row
from hipe_tpu.runtime.engine import Engine, EngineConfig
from hipe_tpu.utils import images as imglib


def _add_kernel_flag(sp) -> None:
    sp.add_argument(
        "--kernel", action="append", metavar="NAME=TAPS[:SCALE[:OFFSET]]",
        help="register a custom convolution kernel as a chainable filter "
             "stage (taps comma-separated in PIL ImageFilter.Kernel order, "
             "odd square 3x3-9x9; scale defaults to sum(taps); offset in "
             "halves). Repeatable; use the NAME in --pipeline / the "
             "pipeline argument. Example: "
             "--kernel soft=1,2,1,2,4,2,1,2,1:16 --pipeline soft,sharpen")
    sp.add_argument(
        "--lut", action="append", metavar="NAME=SPEC",
        help="register a 256-entry LUT as a chainable radius-0 point "
             "stage. SPEC is brightness:F (PIL ImageEnhance.Brightness, "
             "bit-exact), gamma:G, solarize:T (PIL threshold), or 256 "
             "comma-separated uint8 values. "
             "Repeatable. Example: --lut dim=brightness:0.7 "
             "--pipeline dim,blur3")
    sp.add_argument(
        "--rank", action="append", metavar="NAME=SIZE:RANK",
        help="register PIL RankFilter(SIZE, RANK) as a chainable stage "
             "(SIZE odd 3..9, RANK in [0, SIZE^2); bit-exact incl. "
             "borders; median5/erode5/dilate5/median7/median9 are "
             "pre-registered). "
             "Repeatable. Example: --rank q25=5:6 --pipeline q25,edge")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hipe_tpu", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="approach", required=True)

    a1 = sub.add_parser("approach1", help="image-level distribution")
    a1.add_argument("mode", nargs="?", default="both",
                    choices=["both", "cpu", "gpu", "tpu"])
    a1.add_argument("gpu_ratio", nargs="?", type=float,
                    default=pt.DEFAULT_RATIO)
    a1.add_argument("batch_size", nargs="?", type=int,
                    default=pt.DEFAULT_BATCH)

    st = sub.add_parser(
        "stream",
        help="device-resident stream (the accelerator fast path)",
    )
    st.add_argument("pipeline_name", nargs="?", default="blur3")
    st.add_argument("--num-images", type=int, default=pt.NUM_IMAGES)
    st.add_argument("--image", default=None,
                    help="input JPEG (default: a seeded 256x256 image)")
    st.add_argument("--seed", type=int, default=0,
                    help="seed of the generated input image")
    st.add_argument("--no-autotune", action="store_true",
                    help="skip the measured execution-config selection")
    st.add_argument("--retune", action="store_true",
                    help="ignore the persisted autotune winner and re-sweep")
    st.add_argument("--passes", type=int, default=10)
    st.add_argument("--json", action="store_true",
                    help="print one JSON result line (bench.py schema-like)")
    st.add_argument("--factor", type=float, default=None,
                    help="contrast/color/sharpness strength (PIL "
                         "ImageEnhance, bit-exact)")
    st.add_argument("--cutoff", type=int, nargs="+", default=None,
                    metavar="PCT",
                    help="autocontrast trim percent(s) (PIL semantics)")
    st.add_argument("--preserve-tone", action="store_true",
                    help="autocontrast: PIL preserve_tone luminance mode")
    _add_kernel_flag(st)

    sv = sub.add_parser(
        "serve",
        help="decode -> filter -> encode streaming pipeline (JPEG in/out)",
    )
    sv.add_argument("pipeline_name", nargs="?", default="blur3")
    sv.add_argument("--num-images", type=int, default=500)
    sv.add_argument("--batch-size", type=int, default=100)
    sv.add_argument("--image", default=None,
                    help="input JPEG(s), comma-separated for a "
                         "mixed-resolution stream (default: a seeded "
                         "256x256 image)")
    sv.add_argument("--seed", type=int, default=0,
                    help="seed of the generated input image")
    sv.add_argument("--quality", type=int, default=90,
                    help="JPEG quality for the simulated input stream "
                         "and the encoded outputs")
    sv.add_argument("--decode-on-device", action="store_true",
                    help="host does entropy decode only; IDCT/upsample/"
                         "color run on the device fused with the filter")
    sv.add_argument("--encode-on-device", action="store_true",
                    help="host does entropy encode only; color/downsample/"
                         "fDCT/quantize run on the device fused with the "
                         "filter (byte-identical output files)")
    sv.add_argument("--encode-subsampling", default="420",
                    choices=("420", "444", "422", "440",
                             "411", "410", "311"),
                    help="chroma subsampling of the emitted JPEGs")
    sv.add_argument("--encode-progressive", action="store_true",
                    help="progressive output streams (cjpeg -progressive "
                         "scan script; identical pixels)")
    sv.add_argument("--encode-arithmetic", action="store_true",
                    help="arithmetic-coded output streams (SOF9; ~5-10%% "
                         "smaller than Huffman at identical pixels)")
    sv.add_argument("--encode-optimize", action="store_true",
                    help="per-image optimal Huffman tables (~2-5%% smaller "
                         "files, identical pixels)")
    sv.add_argument("--encode-restart-interval", type=int, default=0,
                    metavar="MCUS",
                    help="insert RSTn markers every MCUS MCUs (0 = none)")
    sv.add_argument("--decode-gray", action="store_true",
                    help="decode color streams as grayscale at the source "
                         "(libjpeg JCS_GRAYSCALE: Y-only IDCT, no chroma "
                         "work) and run the pipeline 1-channel")
    sv.add_argument("--gray", action="store_true",
                    help="grayscale outputs: device luma convert (jccolor "
                         "rgb_gray fixed point), byte-identical to "
                         "libjpeg's RGB->grayscale encode")
    sv.add_argument("--thumbnail", action="store_true",
                    help="half-size outputs: filter, then an exact 2x2 "
                         "average (jcsample rounding), then encode")
    sv.add_argument("--resize", type=int, nargs=2, default=None,
                    metavar=("H", "W"),
                    help="arbitrary output size: filter, then the "
                         "integer-exact bilinear resize (banded "
                         "matmuls), then encode")
    sv.add_argument("--cutoff", type=int, nargs="+", default=None,
                    metavar="PCT",
                    help="autocontrast only: trim PCT percent (or two "
                         "values: low high) of histogram mass from each "
                         "end before stretching (PIL cutoff semantics, "
                         "bit-exact)")
    sv.add_argument("--preserve-tone", action="store_true",
                    help="autocontrast only: PIL preserve_tone — one "
                         "luminance-derived range applied to all "
                         "channels (bit-exact)")
    sv.add_argument("--factor", type=float, default=None,
                    help="contrast/color/sharpness only: PIL ImageEnhance "
                         "strength (bit-exact; 1.0 = identity, <1 "
                         "reduces, >1 boosts)")
    sv.add_argument("--colorize", default=None, metavar="BLACK:WHITE[:MID]",
                    help="map grayscale output to a color wedge (PIL "
                         "ImageOps.colorize, bit-exact; colors are names "
                         "or #rrggbb). Needs a 1-channel stage output: "
                         "combine with --decode-gray or --gray")
    sv.add_argument("--decode-scale", type=int, default=1,
                    choices=(1, 2, 4, 8),
                    help="DCT-domain scaled decode 1/N (libjpeg "
                         "scale_num/denom semantics, bit-exact): the whole "
                         "pipeline runs at ceil(dim/N) resolution")
    sv.add_argument("--no-encode", action="store_true",
                    help="skip output JPEG encode")
    sv.add_argument("--json", action="store_true",
                    help="print one JSON result line")
    _add_kernel_flag(sv)

    tr = sub.add_parser(
        "transform",
        help="lossless DCT-domain transform (jpegtran analog on device)")
    tr.add_argument("input", nargs="+",
                    help="input JPEG path(s); multiple inputs use the "
                         "batched path and -o names a directory")
    tr.add_argument("op", choices=("flip_h", "flip_v", "rot90", "rot180",
                                   "rot270", "transpose", "transverse",
                                   "grayscale", "crop"))
    tr.add_argument("--crop", type=int, nargs=4, default=None,
                    metavar=("X", "Y", "W", "H"),
                    help="region for op=crop (X,Y iMCU-aligned)")
    tr.add_argument("-o", "--output", required=True,
                    help="output JPEG path (or directory for multi-input)")
    tr.add_argument("--progressive", action="store_true")
    tr.add_argument("--arithmetic", action="store_true")
    tr.add_argument("--optimize", action="store_true")

    a2 = sub.add_parser("approach2", help="split-image distribution")
    a2.add_argument("gpu_ratio", nargs="?", type=float,
                    default=pt.DEFAULT_RATIO)
    a2.add_argument("batch_size", nargs="?", type=int,
                    default=pt.DEFAULT_BATCH)
    a2.add_argument("--save-output", default=None, metavar="PATH",
                    help="save reassembled batch-0 image (SAVE_IMAGE analog)")

    for sp in (a1, a2):
        sp.add_argument("--image", default=None,
                        help="input JPEG (default: a seeded image of the "
                             "reference's 320x240 size); comma-separate "
                             "paths for a mixed-resolution stream "
                             "(BASELINE config 5)")
        sp.add_argument("--seed", type=int, default=0,
                        help="seed of the generated input image")
        sp.add_argument("--num-images", type=int, default=pt.NUM_IMAGES)
        sp.add_argument("--pipeline", default="blur3",
                        help="blur3|blur5|blur7|blur9|sharpen|edge|chain or "
                             "comma-separated filter names")
        sp.add_argument("--accel-path", default="pallas",
                        choices=["pallas", "xla"])
        sp.add_argument("--no-profile", action="store_true",
                        help="skip stage timing (async fast path)")
        sp.add_argument("--pipeline-depth", type=int, default=1,
                        help="batches in flight per lane (1 = reference "
                             "per-batch barrier; 2 = double-buffered)")
        sp.add_argument("--scheduler", default="static",
                        choices=["static", "greedy"],
                        help="static = fixed-ratio split (reference); "
                             "greedy = batch-level work stealing "
                             "(approach 1 'both' only)")
        sp.add_argument("--elastic", action="store_true",
                        help="greedy only: survive a lane failure by "
                             "redistributing its batches to healthy lanes "
                             "(default: fail fast, like the reference)")
        sp.add_argument("--csv", default=None, metavar="PATH",
                        help="append a per_run.csv-schema row")
        sp.add_argument("--run-index", type=int, default=1)
        sp.add_argument("--factor", type=float, default=None,
                        help="contrast/color/sharpness strength (PIL "
                             "ImageEnhance, bit-exact)")
        sp.add_argument("--cutoff", type=int, nargs="+", default=None,
                        metavar="PCT",
                        help="autocontrast trim percent(s)")
        sp.add_argument("--preserve-tone", action="store_true",
                        help="autocontrast: PIL preserve_tone mode")
        _add_kernel_flag(sp)
    return p


def _main_stream(args) -> int:
    """The device-resident stream mode: load once, process on the device."""
    import json

    from hipe_tpu.models.pipelines import PIPELINES
    from hipe_tpu.runtime.device_stream import DeviceStreamRunner

    if "," in args.pipeline_name:
        from hipe_tpu.models import pipelines as plib
        from hipe_tpu.ops.blur import FILTERS

        names = tuple(args.pipeline_name.split(","))
        bad = [nm for nm in names if nm not in FILTERS]
        if bad:
            print(f"Error: unknown filter stage(s) {bad} "
                  f"(chainable stages: {sorted(FILTERS)})", file=sys.stderr)
            return 1
        stream_pipeline = plib.get(names)
    elif args.pipeline_name in PIPELINES:
        stream_pipeline = args.pipeline_name
    else:
        # Bare filter names — registered --kernel/--lut/--rank stages
        # included — are single-stage pipelines (plib.get semantics).
        from hipe_tpu.models import pipelines as plib
        from hipe_tpu.ops.blur import FILTERS

        if args.pipeline_name not in FILTERS:
            print(
                f"Error: unknown pipeline {args.pipeline_name!r} "
                f"(choose from {sorted(PIPELINES)}, a filter name, or a "
                "comma-joined filter chain)",
                file=sys.stderr,
            )
            return 1
        stream_pipeline = plib.get(args.pipeline_name)
    param_pipe, err = _stats_pipeline_from_flags(args, args.pipeline_name)
    if err:
        print(err, file=sys.stderr)
        return 1
    if param_pipe is not None:
        stream_pipeline = param_pipe
    try:
        image = imglib.load_test_image(args.image, seed=args.seed)
    except (FileNotFoundError, ValueError) as e:
        print(f"Error: cannot load input image: {e}", file=sys.stderr)
        return 1
    h, w, c = image.shape
    print("========== DEVICE-STREAM CONFIGURATION ==========")
    print(f"Pipeline: {args.pipeline_name}")
    print(f"Stream: {args.num_images} images of {w}x{h}x{c} "
          "(device-resident)")
    runner = DeviceStreamRunner(
        stream_pipeline, num_images=args.num_images, image=image
    )
    if not args.no_autotune:
        timings = runner.autotune(retune=args.retune)
        for label, t in sorted(timings.items(), key=lambda kv: kv[1]):
            print(f"  autotune {label:22s} {t * 1e3:8.2f} ms/pass")
        hit = " (cache hit, sweep skipped)" if runner.tuning.get(
            "cache_hit") else ""
        print(f"Chosen config: {runner.tuning['chosen']}{hit}")
    err = runner.verify_max_abs_err()
    res = runner.measure_throughput(passes=args.passes, reps=3)
    print("\n========== DEVICE-STREAM RESULTS ==========")
    print(f"   Max-abs error vs oracle: {err}")
    print(f"   Per-pass time: {res['per_pass_s'] * 1e3:.2f} ms")
    print(f"   Overall throughput: {res['mpix_per_s']:.2f} Megapixels/sec")
    print(f"   Images per second: {res['img_per_s']:.2f}")
    print(f"   Effective device-memory traffic: {res['gb_per_s']:.0f} GB/s")
    print(f"   Kernel: {runner.kernel_name}")
    if args.json:
        print(json.dumps({
            "pipeline": args.pipeline_name,
            "num_images": args.num_images,
            "img_per_s": round(res["img_per_s"], 1),
            "max_abs_err": err,
            "config": (runner.tuning or {}).get("chosen", "default"),
            "kernel": runner.kernel_name,
        }))
    # Exact equality is the repo-wide contract: any nonzero
    # device-vs-oracle error is a kernel regression, never tolerance.
    return 0 if err == 0 else 1


def _main_transform(args) -> int:
    """Lossless DCT-domain transform of JPEG file(s) (jpegtran analog)."""
    import os as _os

    from hipe_tpu.ops.jpeg_transform import (crop_bytes, transform_batch,
                                             transform_bytes)

    opts = dict(progressive=args.progressive,
                arithmetic=args.arithmetic, optimize=args.optimize)
    try:
        datas = []
        for path in args.input:
            with open(path, "rb") as f:
                datas.append(f.read())
        if args.op == "crop":
            if args.crop is None:
                raise ValueError("op=crop requires --crop X Y W H")
            outs = [crop_bytes(d, *args.crop, **opts) for d in datas]
        elif len(datas) > 1:
            outs = transform_batch(datas, args.op, **opts)
        else:
            outs = [transform_bytes(datas[0], args.op, **opts)]
    except (OSError, ValueError) as e:
        print(f"Error: {e}")
        return 1
    if len(args.input) > 1:
        names = [_os.path.basename(p) for p in args.input]
        if len(set(names)) != len(names):
            print("Error: input basenames collide; outputs would "
                  "overwrite each other in the output directory")
            return 1
        _os.makedirs(args.output, exist_ok=True)
        for name, out in zip(names, outs):
            with open(_os.path.join(args.output, name), "wb") as f:
                f.write(out)
        total_in = sum(len(d) for d in datas)
        total_out = sum(len(o) for o in outs)
        print(f"{args.op}: {len(datas)} files -> {args.output}/ "
              f"({total_in} -> {total_out} bytes, lossless)")
    else:
        with open(args.output, "wb") as f:
            f.write(outs[0])
        print(f"{args.op}: {args.input[0]} -> {args.output} "
              f"({len(datas[0])} -> {len(outs[0])} bytes, lossless)")
    return 0


def _main_serve(args) -> int:
    """Streaming decode -> filter -> encode service over a JPEG stream."""
    import json

    from hipe_tpu.io_.jpeg import encode_bytes
    from hipe_tpu.models.pipelines import PIPELINES
    from hipe_tpu.runtime.serve import ServingPipeline

    if "," in args.pipeline_name:
        # Comma-joined filter chains, same as approach1/approach2
        # (e.g. "gaussian3,solarize").
        from hipe_tpu.models import pipelines as plib
        from hipe_tpu.ops.blur import FILTERS

        names = tuple(args.pipeline_name.split(","))
        bad = [nm for nm in names if nm not in FILTERS]
        if bad:
            print(f"Error: unknown filter stage(s) {bad} "
                  f"(chainable stages: {sorted(FILTERS)})", file=sys.stderr)
            return 1
        serve_pipeline = plib.get(names)
    elif args.pipeline_name in PIPELINES:
        serve_pipeline = args.pipeline_name
    else:
        from hipe_tpu.models import pipelines as plib
        from hipe_tpu.ops.blur import FILTERS

        if args.pipeline_name not in FILTERS:
            print(
                f"Error: unknown pipeline {args.pipeline_name!r} "
                f"(choose from {sorted(PIPELINES)}, a filter name, or a "
                "comma-joined filter chain)",
                file=sys.stderr,
            )
            return 1
        serve_pipeline = plib.get(args.pipeline_name)
    paths = args.image.split(",") if args.image else [None]
    try:
        payloads = [
            encode_bytes(imglib.load_test_image(p, seed=args.seed),
                         quality=args.quality)
            for p in paths
        ]
    except (FileNotFoundError, ValueError) as e:
        print(f"Error: cannot load input image: {e}", file=sys.stderr)
        return 1
    batch = max(1, min(args.batch_size, args.num_images))
    print("========== SERVING CONFIGURATION ==========")
    print(f"Pipeline: {args.pipeline_name}")
    print(f"Stream: {args.num_images} JPEGs ({len(paths)} source image(s)), "
          f"batch {batch}, quality {args.quality}")
    decode_desc = (
        "device (entropy on host, IDCT/upsample/color on the device)"
        if args.decode_on_device else "host (native libjpeg)"
    )
    print(f"Decode: {decode_desc}")
    from hipe_tpu.ops.jpeg_encode import DEVICE_SUBSAMPLINGS

    if args.encode_on_device and \
            args.encode_subsampling not in DEVICE_SUBSAMPLINGS:
        # Reference-style warn-and-default: the device encoder implements
        # the standard layouts; exotic names encode on host.
        print(f"Warning: subsampling {args.encode_subsampling} has no "
              f"device encoder; encoding on host instead.")
        args.encode_on_device = False
    encode_desc = (
        "device (color/downsample/fDCT/quantize on the device, entropy on "
        "host)"
        if args.encode_on_device else "host (native libjpeg)"
    )
    if not args.no_encode:
        print(f"Encode: {encode_desc}")
    if args.thumbnail:
        print("Output: half-size thumbnails (exact 2x2 average)")
    if args.decode_scale > 1:
        print(f"Decode scale: 1/{args.decode_scale} (DCT-domain, "
              f"bit-exact vs libjpeg scaled decode)")
    pipeline_arg = serve_pipeline
    if args.cutoff is not None or args.preserve_tone:
        from hipe_tpu.models.pipelines import GlobalStatsPipeline

        if args.pipeline_name != "autocontrast" or (
            args.cutoff is not None and len(args.cutoff) > 2
        ):
            print("Error: --cutoff/--preserve-tone take autocontrast "
                  "options (one or two integer percents / a flag) and "
                  "apply to the 'autocontrast' pipeline only",
                  file=sys.stderr)
            return 1
        cut = 0
        if args.cutoff is not None:
            cut = (args.cutoff[0] if len(args.cutoff) == 1
                   else tuple(args.cutoff))
        try:
            pipeline_arg = GlobalStatsPipeline(
                "autocontrast", cutoff=cut,
                preserve_tone=args.preserve_tone,
                channels=1 if args.decode_gray else 3)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        if args.cutoff is not None:
            print(f"Autocontrast cutoff: {cut}%")
        if args.preserve_tone:
            print("Autocontrast preserve_tone: luminance-derived range "
                  "(PIL bit-exact)")
    if args.factor is not None:
        from hipe_tpu.models.pipelines import GlobalStatsPipeline

        if args.pipeline_name not in ("contrast", "color", "sharpness"):
            print("Error: --factor applies to the 'contrast'/'color'/"
                  "'sharpness' pipelines only", file=sys.stderr)
            return 1
        try:
            pipeline_arg = GlobalStatsPipeline(
                args.pipeline_name, factor=args.factor,
                channels=1 if args.decode_gray else 3)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        enh = {"contrast": "Contrast", "color": "Color",
               "sharpness": "Sharpness"}[args.pipeline_name]
        print(f"{enh} factor: {args.factor} "
              f"(PIL ImageEnhance.{enh}, bit-exact)")
    colorize_lut3 = None
    if args.colorize is not None:
        from hipe_tpu.ops.equalize import colorize_lut

        parts = args.colorize.split(":")
        if len(parts) not in (2, 3):
            print("Error: --colorize takes BLACK:WHITE or BLACK:WHITE:MID "
                  "colors", file=sys.stderr)
            return 1
        if not (args.decode_gray or args.gray):
            print("Error: --colorize needs a grayscale stage output; "
                  "combine it with --decode-gray or --gray",
                  file=sys.stderr)
            return 1
        try:
            colorize_lut3 = colorize_lut(*parts)
        except ValueError as e:
            print(f"Error: bad --colorize: {e}", file=sys.stderr)
            return 1
        print(f"Colorize: {' -> '.join(parts)} (PIL ImageOps.colorize, "
              "bit-exact)")
    serve = ServingPipeline(
        pipeline_arg, quality=args.quality,
        decode_on_device=args.decode_on_device,
        encode_on_device=args.encode_on_device,
        encode_subsampling=args.encode_subsampling,
        encode_progressive=args.encode_progressive,
        encode_arithmetic=args.encode_arithmetic,
        encode_restart_interval=args.encode_restart_interval,
        encode_optimize=args.encode_optimize,
        output_scale=2 if args.thumbnail else 1,
        resize_to=tuple(args.resize) if args.resize else None,
        gray_output=args.gray,
        decode_gray=args.decode_gray,
        colorize=colorize_lut3,
        decode_scale=args.decode_scale,
    )

    def batches():
        # Mixed-resolution streams alternate source images ACROSS batches
        # (uniform within a batch): the serving contract for pixel-array
        # returns, and what the per-shape jit cache is built for.
        # (Interleaving sizes within one batch crashed the host-decode
        # path before this.)
        sent = 0
        bi = 0
        while sent < args.num_images:
            n = min(batch, args.num_images - sent)
            yield [payloads[bi % len(payloads)]] * n
            bi += 1
            sent += n

    n_out = sum(len(r) for r in serve.run(batches(),
                                          encode=not args.no_encode))
    st = serve.stats
    print("\n========== SERVING RESULTS ==========")
    print(f"   Images processed: {n_out}")
    print(f"   Host decode time: {st.decode_ms:.1f} ms")
    print(f"   Device time: {st.device_ms:.1f} ms")
    print(f"   Encode time: {st.encode_ms:.1f} ms")
    print(f"   Wall time: {st.wall_ms:.1f} ms")
    print(f"   Images per second: {st.img_per_s:.2f}")
    if args.json:
        print(json.dumps({
            "pipeline": args.pipeline_name,
            "num_images": n_out,
            "decode_on_device": bool(args.decode_on_device),
            "encode_on_device": bool(args.encode_on_device),
            "img_per_s": round(st.img_per_s, 1),
            "decode_ms": round(st.decode_ms, 1),
            "device_ms": round(st.device_ms, 1),
            "encode_ms": round(st.encode_ms, 1),
            "wall_ms": round(st.wall_ms, 1),
        }))
    return 0 if n_out == args.num_images else 1


def _register_cli_kernels(specs) -> str | None:
    """Register --kernel NAME=TAPS[:SCALE[:OFFSET]] stages; error or None."""
    from hipe_tpu.ops.blur import register_kernel_filter

    for raw in specs or ():
        head, eq, body = raw.partition("=")
        parts = body.split(":")
        try:
            if not eq or not head or len(parts) > 3:
                raise ValueError(
                    "expected NAME=T,T,...[:SCALE[:OFFSET]] (taps in PIL "
                    "ImageFilter.Kernel order; scale defaults to sum(taps))"
                )
            taps = [int(t) for t in parts[0].split(",")]
            scale = int(parts[1]) if len(parts) > 1 and parts[1] else None
            offset = float(parts[2]) if len(parts) > 2 and parts[2] else 0.0
            register_kernel_filter(head, taps, scale, offset)
        except ValueError as e:
            return f"Error: bad --kernel {raw!r}: {e}"
    return None


def _register_cli_luts(specs) -> str | None:
    """Register --lut NAME=SPEC point stages; returns an error or None."""
    from hipe_tpu.ops.blur import (brightness_lut, gamma_lut,
                                   register_lut_filter, solarize_lut)

    for raw in specs or ():
        head, eq, body = raw.partition("=")
        try:
            if not eq or not head:
                raise ValueError(
                    "expected NAME=brightness:F | NAME=gamma:G | "
                    "NAME=v0,v1,...,v255"
                )
            kind, sep, arg = body.partition(":")
            if sep and kind == "brightness":
                lut = brightness_lut(float(arg))
            elif sep and kind == "gamma":
                lut = gamma_lut(float(arg))
            elif sep and kind == "solarize":
                lut = solarize_lut(int(arg))
            elif sep:
                raise ValueError(
                    f"unknown LUT constructor {kind!r} "
                    "(brightness:F, gamma:G, or solarize:T)"
                )
            else:
                import numpy as np

                lut = np.array([int(v) for v in body.split(",")])
            register_lut_filter(head, lut)
        except ValueError as e:
            return f"Error: bad --lut {raw!r}: {e}"
    return None


def _stats_pipeline_from_flags(args, name: str):
    """(pipeline_or_None, error_or_None) for --factor/--cutoff/
    --preserve-tone on a pipeline called ``name`` (stream/approach
    grammar; serve adds channel handling on top)."""
    from hipe_tpu.models.pipelines import GlobalStatsPipeline

    factor = getattr(args, "factor", None)
    cutoff = getattr(args, "cutoff", None)
    tone = getattr(args, "preserve_tone", False)
    if factor is None and cutoff is None and not tone:
        return None, None
    try:
        if factor is not None:
            if name not in ("contrast", "color", "sharpness"):
                raise ValueError(
                    "--factor applies to contrast/color/sharpness only"
                )
            return GlobalStatsPipeline(name, factor=factor), None
        if name != "autocontrast" or (
            cutoff is not None and len(cutoff) > 2
        ):
            raise ValueError(
                "--cutoff/--preserve-tone apply to autocontrast only "
                "(one or two integer percents / a flag)"
            )
        cut = 0
        if cutoff is not None:
            cut = cutoff[0] if len(cutoff) == 1 else tuple(cutoff)
        return GlobalStatsPipeline(
            "autocontrast", cutoff=cut, preserve_tone=tone), None
    except ValueError as e:
        return None, f"Error: {e}"


def _register_cli_ranks(specs) -> str | None:
    """Register --rank NAME=SIZE:RANK stages; returns an error or None."""
    from hipe_tpu.ops.blur import register_rank_filter

    for raw in specs or ():
        head, eq, body = raw.partition("=")
        try:
            size, sep, rank = body.partition(":")
            if not eq or not head or not sep:
                raise ValueError("expected NAME=SIZE:RANK")
            register_rank_filter(head, int(size), int(rank))
        except ValueError as e:
            return f"Error: bad --rank {raw!r}: {e}"
    return None


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    from hipe_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    err = (_register_cli_kernels(getattr(args, "kernel", None))
           or _register_cli_luts(getattr(args, "lut", None))
           or _register_cli_ranks(getattr(args, "rank", None)))
    if err:
        print(err, file=sys.stderr)
        return 1
    if args.approach == "stream":
        return _main_stream(args)
    if args.approach == "serve":
        return _main_serve(args)
    if args.approach == "transform":
        return _main_transform(args)
    approach = 1 if args.approach == "approach1" else 2
    mode = getattr(args, "mode", "both")
    pipeline = (
        tuple(args.pipeline.split(","))
        if "," in args.pipeline
        else args.pipeline
    )
    # Fail fast with a clean message (the reference's cl_error analog,
    # heterogeneous_blur.c:25-30).
    from hipe_tpu.models.pipelines import PIPELINES
    from hipe_tpu.ops.blur import FILTERS

    if isinstance(pipeline, tuple):
        bad = [nm for nm in pipeline if nm not in FILTERS]
        valid = sorted(FILTERS)
    else:
        bad = [] if pipeline in PIPELINES or pipeline in FILTERS else [pipeline]
        valid = sorted(set(PIPELINES) | set(FILTERS))
    if bad:
        print(
            f"Error: unknown pipeline/filter {bad} (choose from {valid})",
            file=sys.stderr,
        )
        return 1
    if isinstance(pipeline, str):
        param_pipe, err = _stats_pipeline_from_flags(args, pipeline)
        if err:
            print(err, file=sys.stderr)
            return 1
        if param_pipe is not None:
            pipeline = param_pipe
    if approach == 2:
        from hipe_tpu.models import pipelines as plib

        try:
            plib.get(pipeline).radius
        except ValueError as e:
            # Global-statistics pipelines have no halo radius; approach2's
            # row split cannot run them (the error says what can).
            print(f"Error: {e}", file=sys.stderr)
            return 1

    cfg = EngineConfig(
        approach=approach,
        mode=mode,
        gpu_ratio=args.gpu_ratio,
        batch_size=args.batch_size,
        num_images=args.num_images,
        pipeline=pipeline,
        profile=not args.no_profile,
        pipeline_depth=args.pipeline_depth,
        scheduler=args.scheduler,
        elastic=args.elastic,
        accel_path=args.accel_path,
        save_output=getattr(args, "save_output", None),
        verbose=True,
    ).validate()

    name = "HETEROGENEOUS" if approach == 1 else "SPLIT-IMAGE"
    print(f"========== {name} CONFIGURATION ==========")
    print(f"Input file: {args.image or f'seeded image (seed {args.seed})'}")
    print(f"Number of images in stream: {cfg.num_images}")
    print(f"Batch size: {cfg.batch_size} images")
    print(f"Number of batches: {pt.num_batches(cfg.num_images, cfg.batch_size)}")
    print(f"Pipeline: {cfg.pipeline}")
    if approach == 1:
        print(f"Mode: {cfg.mode}")
        print(f"GPU ratio: {cfg.gpu_ratio * 100:.1f}% GPU, "
              f"{(1 - cfg.gpu_ratio) * 100:.1f}% CPU")
    else:
        print(f"GPU ratio: {cfg.gpu_ratio * 100:.1f}% (rows to GPU)")
    print("================================================\n")

    paths = args.image.split(",") if args.image else [None]
    try:
        images = [
            np.ascontiguousarray(imglib.load_test_image(
                p, size=imglib.REFERENCE_320, seed=args.seed))
            for p in paths
        ]
    except (FileNotFoundError, ValueError) as e:
        print(f"Error: cannot load input image: {e}", file=sys.stderr)
        return 1
    image = images[0]
    h, w, c = image.shape
    for p, im in zip(paths, images):
        ih, iw, ic = im.shape
        print(f"Original image loaded: {iw}x{ih}, {ic} channels "
              f"({p or 'seeded'})")
    print(f"Size of one image: {image.nbytes} bytes "
          f"({image.nbytes / 1024.0:.2f} KB)\n")

    print(meshlib.discover().describe())

    if approach == 2:
        # Use the pipeline's actual halo so the banner's input-row counts
        # (and clamped split_row for extreme ratios) match what the engine
        # runs (Engine._run_approach2 uses halo=pipeline.radius).
        from hipe_tpu.models import pipelines as plib

        rs = pt.row_split(h, cfg.gpu_ratio, halo=plib.get(cfg.pipeline).radius)
        print("\nSplit configuration:")
        print(f"  Split row: {rs.split_row} (CPU: rows 0-{rs.split_row - 1}, "
              f"GPU: rows {rs.split_row}-{h - 1})")
        print(f"  CPU: {rs.cpu_input_rows} input rows (inc. halo), "
              f"{rs.cpu_output_rows} output rows")
        print(f"  GPU: {rs.gpu_input_rows} input rows (inc. halo), "
              f"{rs.gpu_output_rows} output rows")

    print(f"\nStarting batch processing of {cfg.num_images} images in "
          f"{pt.num_batches(cfg.num_images, cfg.batch_size)} batches...")
    engine = Engine(cfg)
    if len(images) > 1:
        from hipe_tpu.runtime.stream import MixedResolutionStream

        stream = MixedResolutionStream(images, cfg.num_images, cfg.batch_size)
        stats = engine.run(stream=stream)
    else:
        stats = engine.run(image=image)
    print("\nAll batches finished!")
    print(engine.report())

    if args.csv:
        row = to_csv_row(stats, run=args.run_index, file=args.csv)
        write_header = True
        try:
            with open(args.csv) as f:
                write_header = not f.readline().strip()
        except FileNotFoundError:
            pass
        with open(args.csv, "a", newline="") as f:
            wtr = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
            if write_header:
                wtr.writeheader()
            wtr.writerow(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
