"""Fused decode -> filter -> encode serving pipeline (BASELINE config 5).

The reference's full data path is JPEG decode (CImg) -> device blur ->
optional JPEG encode (`split_image_blur.c:106-139,548-553`).
This module is that path as a streaming service: batched multithreaded native
JPEG decode (hipe_tpu.io_.jpeg), device filtering, and multithreaded JPEG
encode, with decode of batch k+1 prefetched while the device processes
batch k (double buffering, the analog of the reference's async
write/kernel/read overlap). Handles mixed-resolution
streams: jitted device functions are cached per input shape.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np

import jax
import jax.numpy as jnp

from hipe_tpu.models import pipelines as plib
from hipe_tpu.profiling.events import now_ms


@dataclasses.dataclass
class ServeStats:
    images: int = 0
    decode_ms: float = 0.0
    device_ms: float = 0.0
    encode_ms: float = 0.0
    wall_ms: float = 0.0

    @property
    def img_per_s(self) -> float:
        return self.images / (self.wall_ms / 1000.0) if self.wall_ms else 0.0


class ServingPipeline:
    """decode -> filter -> encode with decode/compute overlap."""

    def __init__(
        self,
        pipeline: plib.Pipeline | str = "blur3",
        *,
        device=None,
        quality: int = 90,
        decode_threads: int | None = None,
        use_pallas: bool | None = None,
        decode_on_device: bool = False,
        encode_on_device: bool = False,
        encode_subsampling: str = "420",
        encode_progressive: bool = False,
        encode_arithmetic: bool = False,
        encode_restart_interval: int = 0,
        encode_optimize: bool = False,
        output_scale: int = 1,
        resize_to: tuple | None = None,
        decode_scale: int = 1,
        gray_output: bool = False,
        decode_gray: bool = False,
        colorize=None,
    ):
        self.pipeline = plib.get(pipeline) if isinstance(pipeline, str) else pipeline
        self.device = device or jax.devices()[0]
        self.quality = quality
        self.decode_threads = decode_threads
        if use_pallas is None:
            use_pallas = plib.default_use_pallas(self.device)
        self.use_pallas = use_pallas
        # decode_on_device: host does entropy decode only; dequant + IDCT +
        # upsample + YCbCr run on the device fused with the filter
        # (ops/jpeg_decode.py), bit-exact vs the host codec.
        self.decode_on_device = decode_on_device
        # encode_on_device: color convert/downsample/fDCT/quantize run on
        # the device fused with the filter (ops/jpeg_encode.py); host does
        # only the serial entropy encode. Output bytes are identical to the
        # host codec's. With decode_on_device too, the whole numeric
        # transcode is one jitted program: coefficients in -> coefficients
        # out, no pixel round trip through the host.
        self.encode_on_device = encode_on_device
        from hipe_tpu.ops import jpeg_encode as je

        if encode_on_device and encode_subsampling not in \
                je.DEVICE_SUBSAMPLINGS:
            # The device encoder covers every named layout (incl. the
            # exotic 411/410/311/asym via the generic int_downsample
            # reproduction); anything else has no host encode path
            # either, so fail with the device-encoder list.
            raise ValueError(
                f"encode_on_device supports subsampling "
                f"{'/'.join(je.DEVICE_SUBSAMPLINGS)}, got "
                f"{encode_subsampling!r} (drop encode_on_device to "
                f"use the host encoder)"
            )
        self.encode_subsampling = encode_subsampling
        # Output entropy-coding options (host entropy layer, so they apply
        # to every encode placement): arithmetic-coded streams are ~5-10%
        # smaller than Huffman at identical pixels; restart markers make
        # streams error-resilient / parallel-decodable. Neither changes
        # the quantized coefficients, so device-encode output stays
        # byte-identical to a direct libjpeg encode with the same options.
        # encode_progressive: emit progressive scans (libjpeg
        # jpeg_simple_progression — the cjpeg -progressive scan script).
        # Composes with arithmetic (SOF10) and restart markers.
        self.encode_progressive = encode_progressive
        self.encode_arithmetic = encode_arithmetic
        self.encode_restart_interval = encode_restart_interval
        # encode_optimize: per-image optimal Huffman tables (libjpeg
        # optimize_coding, cjpeg -optimize): ~2-5% smaller files, same
        # coefficients, so placement byte-identity holds as for the
        # other entropy options. Ignored by arithmetic coding.
        self.encode_optimize = encode_optimize
        # output_scale=2: thumbnail serving — after the filter, an exact
        # 2x2 average (jcsample.c h2v2 rounding, ops/jpeg_encode.py
        # downsample_h2v2 per channel, edge-replicated to even dims)
        # halves each output dimension. This is a decode-then-downscale
        # contract defined by this framework (NOT libjpeg's DCT-domain
        # scale_num/8 modes), exact and testable against its own oracle.
        if output_scale not in (1, 2):
            raise ValueError(f"output_scale must be 1 or 2, got {output_scale}")
        self.output_scale = output_scale
        # resize_to=(H, W): arbitrary-size outputs — after the filter, the
        # integer-exact separable bilinear resize (ops/resize.py, two
        # two-tap banded matmuls) rescales to exactly (H, W).
        # Orthogonal to decode_scale (which changes the FILTER resolution);
        # not combinable with the fixed 2x jcsample thumbnail.
        if resize_to is not None:
            rh, rw = resize_to
            if output_scale == 2:
                raise ValueError("resize_to and output_scale=2 are "
                                 "mutually exclusive")
            if not (isinstance(rh, int) and isinstance(rw, int)
                    and rh > 0 and rw > 0):
                raise ValueError(f"resize_to must be positive ints, "
                                 f"got {resize_to!r}")
            resize_to = (rh, rw)
        self.resize_to = resize_to
        # gray_output: color inputs leave as grayscale — the jccolor
        # rgb_gray_convert fixed-point luma (ops/jpeg_encode.rgb_to_gray)
        # computed on device after filter/resize, encoded 1-component.
        # Byte-identical to libjpeg's own RGB->grayscale encode of the
        # same pixels (encode_bytes_opts(gray_from_rgb=True) is the
        # oracle). Grayscale inputs pass through unchanged.
        self.gray_output = gray_output
        # decode_gray: decode color streams as grayscale at the SOURCE
        # (libjpeg out_color_space=JCS_GRAYSCALE semantics: Y-only IDCT,
        # chroma never touched) and run the whole pipeline 1-channel —
        # the cheap gray path. Distinct from gray_output, which filters
        # in color and converts at the end (filter-then-luma). Device
        # path: the 1-component decode graph on component 0
        # (ops/jpeg_decode.gray_geometry), bit-exact vs the host gray
        # decode — full-size AND scaled (probe-verified across samplings
        # x 1/2-1/8: jdmaster's scaled-size selection for gray output
        # matches the 1-component selection on full-res-luma streams).
        self.decode_gray = decode_gray
        # colorize: grayscale pipeline output -> RGB through three wedge
        # LUTs (PIL ImageOps.colorize bit-exact; build with
        # ops.equalize.colorize_lut or pass any (3, 256) uint8 table).
        # The mirror of gray_output: it needs a 1-channel stage output
        # (decode_gray / gray_output / L streams) and makes the encoded
        # files color. Applied inside every placement's jitted program.
        if colorize is not None:
            import numpy as _np

            colorize = _np.asarray(colorize, dtype=_np.uint8)
            if colorize.shape != (3, 256):
                raise ValueError(
                    f"colorize expects a (3, 256) LUT (see "
                    f"ops.equalize.colorize_lut), got {colorize.shape}"
                )
        self.colorize = colorize
        self._colorize_key = (
            None if colorize is None else hash(colorize.tobytes())
        )
        # decode_scale=2/4/8: DCT-domain scaled decode (libjpeg
        # scale_num/denom semantics, bit-exact) — the image enters the
        # pipeline already at ceil(dim/scale), so filter + encode run on
        # 1/4 - 1/64th the samples. On-device via reduced IDCTs
        # (ops/jpeg_decode.decode_planes_scaled) in decode_on_device mode,
        # else the native codec's scaled path. Composes with output_scale
        # (a further post-filter 2x average).
        if decode_scale not in (1, 2, 4, 8):
            raise ValueError(
                f"decode_scale must be 1, 2, 4 or 8, got {decode_scale}"
            )
        self.decode_scale = decode_scale
        self._fns: dict[tuple, callable] = {}
        self._fused_fns: dict[tuple, callable] = {}
        self._enc_qtabs: tuple | None = None
        # The pool overlaps host stages with device work; the heavy entropy
        # coding itself runs GIL-free inside the native batch calls
        # (io_/jpeg.py read/write_coefficients_batch), sized there by
        # cpu_count too.
        self._pool = ThreadPoolExecutor(
            max_workers=decode_threads or os.cpu_count() or 4
        )
        self.stats = ServeStats()

    def close(self) -> None:
        """Release the host-stage worker threads (idempotent)."""
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _out_dims(self, h: int, w: int) -> tuple[int, int]:
        """Output pixel dims after the optional downscale/resize."""
        if self.resize_to is not None:
            return self.resize_to
        if self.output_scale == 2:
            return -(-h // 2), -(-w // 2)
        return h, w

    def _gray_c(self, c: int) -> int:
        """Channel count after the gray_output stage."""
        return 1 if (self.gray_output and c == 3) else c

    def _out_c(self, c: int) -> int:
        """Output channel count (gray_output then colorize, in order)."""
        c1 = self._gray_c(c)
        if self.colorize is not None and c1 == 1:
            return 3
        return c1

    def _colorize_rows(self, rows, b: int, h: int, w: int, c1: int):
        """Wedge-LUT L->RGB on rows layout: (b, h, w) -> (b, h, w*3).

        ``c1`` is the channel count AFTER gray_output. PIL's colorize
        asserts L mode; a 3-channel stage output is a config error.
        """
        if self.colorize is None:
            return rows
        if c1 != 1:
            raise ValueError(
                "colorize needs a grayscale stage output (use decode_gray "
                "or gray_output, or feed 1-channel streams); got "
                f"{c1} channels"
            )
        lut = jnp.asarray(self.colorize)
        x = rows.reshape(b, h, w).astype(jnp.int32)
        chans = [jnp.take(lut[i], x) for i in range(3)]
        out = jnp.stack(chans, axis=-1).astype(jnp.uint8)
        return out.reshape(b, h, w * 3)

    def _gray_rows(self, rows, b: int, h: int, w: int, c: int):
        """rgb_to_gray on rows layout: (b, h, w*3) -> (b, h, w)."""
        if not (self.gray_output and c == 3):
            return rows
        from hipe_tpu.ops.jpeg_encode import rgb_to_gray

        y = rgb_to_gray(rows.reshape(b, h, w, c))
        return y.astype(jnp.uint8)

    def _post_filter_rows(self, rows, b: int, h: int, w: int, c: int):
        """Post-filter output sizing on rows layout: 2x thumb or resize."""
        if self.resize_to is not None:
            from hipe_tpu.ops.resize import resize_bilinear

            oh, ow = self.resize_to
            img = resize_bilinear(rows.reshape(b, h, w, c), oh, ow)
            return img.reshape(b, oh, ow * c)
        if self.output_scale == 2:
            return self._downscale_rows(rows, b, h, w, c)
        return rows

    def _scaled_in_dims(self, h: int, w: int) -> tuple[int, int]:
        """Pixel dims entering the filter after the scaled decode."""
        s = self.decode_scale
        return -(-h // s), -(-w // s)

    def _downscale_rows(self, rows: jnp.ndarray, b: int, h: int, w: int,
                        c: int) -> jnp.ndarray:
        """Exact 2x thumbnail: per-channel jcsample h2v2 average.

        Edge-replicates odd dims to even (jcsample expand semantics),
        then (sum of 2x2 + alternating bias) >> 2 per channel — the same
        bit-exact averaging the device encoder uses for chroma.
        """
        from hipe_tpu.ops.jpeg_encode import _pad_edge, downsample_h2v2

        img = jnp.moveaxis(
            rows.reshape(b, h, w, c).astype(jnp.int32), -1, 1
        )  # (b, c, h, w): planar so the lane axis is W, not W*C
        img = _pad_edge(img, 2 * -(-h // 2), 2 * -(-w // 2))
        small = downsample_h2v2(img)
        small = jnp.moveaxis(small, 1, -1).astype(jnp.uint8)
        h2, w2 = small.shape[1], small.shape[2]
        return small.reshape(b, h2, w2 * c)

    def _device_fn(self, shape: tuple):
        """Per-shape jitted rows-layout filter (+ post-filter stages)."""
        if shape not in self._fns:
            pipe, pallas_flag = self.pipeline, self.use_pallas
            b, h, w, channels = shape

            def fn(rows):
                out = pipe.apply_rows(rows, channels, use_pallas=pallas_flag)
                out = self._post_filter_rows(out, rows.shape[0], h, w,
                                             channels)
                oh, ow = self._out_dims(h, w)
                out = self._gray_rows(out, rows.shape[0], oh, ow, channels)
                return self._colorize_rows(out, rows.shape[0], oh, ow,
                                           self._gray_c(channels))

            self._fns[shape] = jax.jit(fn)
        return self._fns[shape]

    def _decode(self, payloads: list[bytes]) -> np.ndarray:
        from hipe_tpu.io_.jpeg import decode_batch, decode_batch_scaled

        t0 = now_ms()
        if self.decode_scale > 1:
            batch = decode_batch_scaled(payloads, 1, self.decode_scale,
                                        num_threads=self.decode_threads,
                                        force_gray=self.decode_gray)
        else:
            batch = decode_batch(payloads, num_threads=self.decode_threads,
                                 force_gray=self.decode_gray)
        if batch.shape[-1] == 4:
            # 4-component (Adobe CMYK/YCCK) streams decode fine standalone
            # (io_.jpeg.decode_bytes / ops.jpeg_decode) but the serving
            # filter+re-encode contract is 1/3-channel.
            raise ValueError(
                "4-component (CMYK) JPEG serving is not supported; decode "
                "via hipe_tpu.io_.jpeg.decode_bytes or "
                "ops.jpeg_decode.decode_coefficients instead"
            )
        self.stats.decode_ms += now_ms() - t0
        return batch

    def _filter_device(self, batch: np.ndarray) -> np.ndarray:
        t0 = now_ms()
        b, h, w, c = batch.shape
        # Rows layout on device (free host reshape; avoids NHWC lane padding)
        rows = jax.device_put(batch.reshape(b, h, w * c), self.device)
        out = np.asarray(self._device_fn(batch.shape)(rows))
        self.stats.device_ms += now_ms() - t0
        oh, ow = self._out_dims(h, w)
        return out.reshape(b, oh, ow, self._out_c(c))

    def process_pixels(self, batch: np.ndarray) -> np.ndarray:
        """Filter (+ resize/thumbnail/gray/colorize) an already-decoded
        (B, H, W, C) uint8 batch on the device; returns pixels."""
        return self._filter_device(np.asarray(batch))

    def _encode(self, batch: np.ndarray) -> list[bytes]:
        if self.encode_on_device:
            return self._encode_device(batch)
        from hipe_tpu.io_.jpeg import encode_bytes, encode_bytes_opts

        t0 = now_ms()
        if (self.encode_subsampling != "420" or self.encode_progressive
                or self.encode_arithmetic
                or self.encode_restart_interval or self.encode_optimize
                or (self.gray_output and batch.shape[-1] == 3
                    and self.colorize is None)):
            # Honor non-default subsampling / entropy options on the host
            # path too (raises if the native codec is unavailable rather
            # than silently emitting defaults).
            gray = (self.gray_output and batch.shape[-1] == 3
                    and self.colorize is None)

            def enc(im):
                return encode_bytes_opts(
                    im, self.quality, subsampling=self.encode_subsampling,
                    progressive=self.encode_progressive,
                    arithmetic=self.encode_arithmetic,
                    restart_interval=self.encode_restart_interval,
                    gray_from_rgb=gray, optimize=self.encode_optimize,
                )
        else:
            def enc(im):
                return encode_bytes(im, self.quality)

        out = list(self._pool.map(enc, batch))
        self.stats.encode_ms += now_ms() - t0
        return out

    # ---- device-encode path: color/downsample/fDCT/quantize fused with
    # the filter on device; host does only the entropy encode ----

    def _encode_tables(self) -> tuple:
        """(luma, chroma) quant tables for self.quality (cached)."""
        if self._enc_qtabs is None:
            from hipe_tpu.io_ import jpeg as jio

            self._enc_qtabs = jio.quality_tables(self.quality)
        return self._enc_qtabs

    def _device_encode_fn(self, shape: tuple, with_filter: bool):
        """Per-shape jitted (filter +) encode: rows -> quantized coefs."""
        key = ("enc", shape, self.encode_subsampling, with_filter,
               self.output_scale, self.resize_to, self.gray_output,
               self._colorize_key)
        if key not in self._fns:
            from hipe_tpu.ops import jpeg_encode as je

            pipe, pallas_flag = self.pipeline, self.use_pallas
            b, h, w, c = shape
            # Downscale/resize/gray (if any) apply with the filter, before
            # encode; a with_filter=False batch already carries them.
            oh, ow = self._out_dims(h, w) if with_filter else (h, w)
            oc = self._out_c(c) if with_filter else c
            geo = je.encode_geometry(oh, ow, oc, self.encode_subsampling)
            luma, chroma = self._encode_tables()
            qtables = [luma] if oc == 1 else [luma, chroma, chroma]

            def fn(rows):
                if with_filter:
                    rows = pipe.apply_rows(rows, c, use_pallas=pallas_flag)
                    rows = self._post_filter_rows(rows, b, h, w, c)
                    rows = self._gray_rows(rows, b, oh, ow, c)
                    rows = self._colorize_rows(rows, b, oh, ow,
                                               self._gray_c(c))
                img = rows.reshape(b, oh, ow, oc)
                return tuple(je.encode_planes(geo, img, qtables))

            self._fns[key] = jax.jit(fn)
        return self._fns[key]

    def _entropy_encode(self, coefs: list[np.ndarray], h: int, w: int,
                        channels: int) -> list[bytes]:
        """Host entropy encode of per-component coef batches -> files.

        One native batch call (GIL-free pthread pool) rather than a
        Python-threaded per-image fan-out — the round-2 serving bottleneck.
        """
        from hipe_tpu.io_ import jpeg as jio

        t0 = now_ms()
        sub = self.encode_subsampling if channels == 3 else "444"
        out = jio.write_coefficients_batch(
            coefs, w, h, quality=self.quality, subsampling=sub,
            progressive=self.encode_progressive,
            arithmetic=self.encode_arithmetic,
            restart_interval=self.encode_restart_interval,
            optimize=self.encode_optimize,
            num_threads=self.decode_threads,
        )
        self.stats.encode_ms += now_ms() - t0
        return out

    def _encode_device(self, batch: np.ndarray,
                       with_filter: bool = False) -> list[bytes]:
        """Pixels -> JPEG bytes via device fDCT (optionally filtering too).

        with_filter=True is the fused pixel-input hot path: one host->device
        trip, filter + encode in a single jitted program, only quantized
        coefficients return to the host.
        """
        t0 = now_ms()
        b, h, w, c = batch.shape
        rows = jax.device_put(batch.reshape(b, h, w * c), self.device)
        fn = self._device_encode_fn(batch.shape, with_filter)
        coefs = [np.asarray(x) for x in fn(rows)]
        self.stats.device_ms += now_ms() - t0
        oh, ow = self._out_dims(h, w) if with_filter else (h, w)
        oc = self._out_c(c) if with_filter else c
        return self._entropy_encode(coefs, oh, ow, oc)

    # ---- device-decode path: entropy decode on host, the rest fused with
    # the filter in one jitted program (no decoded-RGB host round trip) ----

    def _fused_decode_filter_fn(self, geo, qkey):
        """Per-(geometry, quant-tables) jitted decode+filter program."""
        key = (geo, qkey, self.output_scale, self.resize_to,
               self.decode_scale, self.gray_output, self._colorize_key)
        if key not in self._fused_fns:
            from hipe_tpu.ops import jpeg_decode as jd

            qtables = [np.array(q, dtype=np.uint16) for q in qkey]
            pipe, pallas_flag = self.pipeline, self.use_pallas
            denom = self.decode_scale
            # Filter (and everything downstream) runs at the scaled-decode
            # resolution — the point of DCT-domain thumbnailing.
            h, w = self._scaled_in_dims(geo.height, geo.width)

            def fn(*comp_coefs):
                rows = jd.decode_planes_scaled(geo, list(comp_coefs),
                                               qtables, denom, layout="rows")
                b = rows.shape[0]
                c = rows.shape[-1] // w
                out = pipe.apply_rows(rows, c, use_pallas=pallas_flag)
                out = self._post_filter_rows(out, b, h, w, c)
                oh, ow = self._out_dims(h, w)
                out = self._gray_rows(out, b, oh, ow, c)
                out = self._colorize_rows(out, b, oh, ow, self._gray_c(c))
                return out.reshape(b, oh, ow, self._out_c(c))

            self._fused_fns[key] = jax.jit(fn)
        return self._fused_fns[key]

    def _maybe_gray_geo(self, jd, geo, qkey):
        """Reduce a color geometry to its luma-only view for decode_gray.

        Only full-resolution-luma 3-component streams reduce (the same
        constraint as gray_geometry); anything else keeps its geometry
        and the host-fallback path decodes it gray.
        """
        if (self.decode_gray and geo.ncomps == 3
                and geo.comps[0][:2] == (geo.max_h, geo.max_v)):
            return jd.gray_geometry(geo), (qkey[0],)
        return geo, qkey

    def _read_coefs(self, payloads: list[bytes]):
        """Host entropy decode (one GIL-free native batch call)."""
        from hipe_tpu.io_.jpeg import read_coefficients_batch

        t0 = now_ms()
        cos = read_coefficients_batch(payloads,
                                      num_threads=self.decode_threads)
        self.stats.decode_ms += now_ms() - t0
        return cos

    def _filter_device_coefs(self, payloads: list[bytes],
                             cos=None) -> np.ndarray:
        """Entropy-decode on host, decode+filter on device, batch output.

        Payload groups with matching (geometry, quant tables) — the common
        case for a stream from one encoder — batch into one device call;
        geometries the device decoder does not cover fall back to the host
        codec per group. `cos` lets run() prefetch the entropy decode on
        the host stage so it overlaps device work.
        """
        from hipe_tpu.ops import jpeg_decode as jd

        if cos is None:
            cos = self._read_coefs(payloads)

        groups: dict[tuple, list[int]] = {}
        keys = []
        for i, co in enumerate(cos):
            geo = jd.geometry_of(co)
            qkey = tuple(
                tuple(int(v) for v in c.qtable) for c in co.components
            )
            geo, qkey = self._maybe_gray_geo(jd, geo, qkey)
            keys.append((geo, qkey))
            groups.setdefault((geo, qkey), []).append(i)

        out: list[np.ndarray | None] = [None] * len(cos)
        for (geo, qkey), idxs in groups.items():
            if geo.ncomps == 4 or not jd.supported_scaled(
                    geo, self.decode_scale):
                # Host fallback keeps exotic sampling factors working (the
                # native codec applies the same DCT-domain scale there).
                # 4-component (CMYK) streams take this route too so the
                # host decode raises the clear not-servable error.
                # (_decode and _filter_device keep their own stage books,
                # so no outer timer here — it would double-count.)
                batch = self._decode([payloads[i] for i in idxs])
                res = self._filter_device(batch)
            else:
                t0 = now_ms()
                comp_batches = [
                    jax.device_put(
                        np.stack([cos[i].components[ci].coefs for i in idxs]),
                        self.device,
                    )
                    for ci in range(geo.ncomps)
                ]
                fn = self._fused_decode_filter_fn(geo, qkey)
                res = np.asarray(fn(*comp_batches))
                self.stats.device_ms += now_ms() - t0
            for j, i in enumerate(idxs):
                out[i] = res[j]
        if len({o.shape for o in out}) > 1:
            raise ValueError(
                "mixed-resolution batch cannot return one pixel array; "
                "use uniform-size batches (MixedResolutionStream yields "
                "them) or encode=True, which returns per-image JPEG bytes"
            )
        return np.stack(out)

    def _fused_transcode_fn(self, geo, qkey: tuple):
        """Per-(geometry, quant-tables) jitted decode+filter+encode program.

        The full numeric transcode on device: dequant/IDCT/upsample/color
        (ops/jpeg_decode.py) -> filter -> color/downsample/fDCT/quantize
        (ops/jpeg_encode.py). Only entropy coding stays on the host, so a
        coefficient batch goes in and a coefficient batch comes out.
        """
        key = ("transcode", geo, qkey, self.encode_subsampling,
               self.output_scale, self.resize_to, self.decode_scale,
               self.gray_output, self._colorize_key)
        if key not in self._fused_fns:
            from hipe_tpu.ops import jpeg_decode as jd
            from hipe_tpu.ops import jpeg_encode as je

            qt_in = [np.array(q, dtype=np.uint16) for q in qkey]
            pipe, pallas_flag = self.pipeline, self.use_pallas
            h, w = self._scaled_in_dims(geo.height, geo.width)
            c = 3 if geo.ncomps == 3 else 1
            oh, ow = self._out_dims(h, w)
            oc = self._out_c(c)
            enc_geo = je.encode_geometry(oh, ow, oc, self.encode_subsampling)
            luma, chroma = self._encode_tables()
            enc_qt = [luma] if oc == 1 else [luma, chroma, chroma]
            denom = self.decode_scale

            def fn(*comp_coefs):
                rows = jd.decode_planes_scaled(geo, list(comp_coefs), qt_in,
                                               denom, layout="rows")
                out = pipe.apply_rows(rows, c, use_pallas=pallas_flag)
                out = self._post_filter_rows(out, out.shape[0], h, w, c)
                out = self._gray_rows(out, out.shape[0], oh, ow, c)
                out = self._colorize_rows(out, out.shape[0], oh, ow,
                                          self._gray_c(c))
                img = out.reshape(out.shape[0], oh, ow, oc)
                return tuple(je.encode_planes(enc_geo, img, enc_qt))

            self._fused_fns[key] = jax.jit(fn)
        return self._fused_fns[key]

    def _transcode_device_coefs(self, payloads: list[bytes],
                                cos=None) -> list[bytes]:
        """Full device transcode: entropy decode -> device -> entropy encode.

        Groups payloads by (geometry, quant tables) as _filter_device_coefs
        does; unsupported geometries fall back to host decode + fused
        device filter/encode.
        """
        from hipe_tpu.ops import jpeg_decode as jd

        if cos is None:
            cos = self._read_coefs(payloads)

        groups: dict[tuple, list[int]] = {}
        for i, co in enumerate(cos):
            geo = jd.geometry_of(co)
            qkey = tuple(
                tuple(int(v) for v in c.qtable) for c in co.components
            )
            geo, qkey = self._maybe_gray_geo(jd, geo, qkey)
            groups.setdefault((geo, qkey), []).append(i)

        out: list[bytes | None] = [None] * len(cos)
        for (geo, qkey), idxs in groups.items():
            if geo.ncomps == 4 or not jd.supported_scaled(
                    geo, self.decode_scale):
                batch = self._decode([payloads[i] for i in idxs])
                res = self._encode_device(batch, with_filter=True)
            else:
                t0 = now_ms()
                comp_batches = [
                    jax.device_put(
                        np.stack([cos[i].components[ci].coefs for i in idxs]),
                        self.device,
                    )
                    for ci in range(geo.ncomps)
                ]
                fn = self._fused_transcode_fn(geo, qkey)
                coefs = [np.asarray(x) for x in fn(*comp_batches)]
                self.stats.device_ms += now_ms() - t0
                oh, ow = self._out_dims(
                    *self._scaled_in_dims(geo.height, geo.width)
                )
                res = self._entropy_encode(
                    coefs, oh, ow, self._out_c(3 if geo.ncomps == 3 else 1),
                )
            for j, i in enumerate(idxs):
                out[i] = res[j]
        return out

    def process_batch(self, payloads: list[bytes],
                      encode: bool = True) -> list[bytes] | np.ndarray:
        """Synchronous single batch: decode -> filter -> (encode)."""
        if encode and self.encode_on_device:
            if self.decode_on_device:
                return self._transcode_device_coefs(payloads)
            return self._encode_device(self._decode(payloads),
                                       with_filter=True)
        if self.decode_on_device:
            filtered = self._filter_device_coefs(payloads)
        else:
            filtered = self._filter_device(self._decode(payloads))
        return self._encode(filtered) if encode else filtered

    def run(self, payload_batches: Iterable[list[bytes]],
            encode: bool = True) -> Iterator[list[bytes] | np.ndarray]:
        """Streaming mode: host decode of batch k+1 overlaps device batch k.

        In decode_on_device mode the prefetched host stage is the entropy
        decode (a native batch call), so batch k+1's Huffman work overlaps
        batch k's device compute; IDCT/upsample/color run on device with
        the filter. With encode_on_device the device stage emits JPEG bytes
        directly (fDCT/quantize fused on device, entropy encode on host).
        """
        fuse_encode = encode and self.encode_on_device
        if self.decode_on_device:
            def host_stage(p):
                return p, self._read_coefs(p)

            def device_stage(arg):
                payloads, cos = arg
                self.stats.images += len(payloads)
                if fuse_encode:
                    return self._transcode_device_coefs(payloads, cos)
                return self._filter_device_coefs(payloads, cos)
        else:
            def host_stage(p):
                return self._decode(p)

            def device_stage(batch):
                self.stats.images += len(batch)
                if fuse_encode:
                    return self._encode_device(batch, with_filter=True)
                return self._filter_device(batch)

        t_start = now_ms()
        pending = None
        for payloads in payload_batches:
            fut = self._pool.submit(host_stage, payloads)
            if pending is not None:
                res = device_stage(pending.result())
                yield self._encode(res) if encode and not fuse_encode else res
            pending = fut
        if pending is not None:
            res = device_stage(pending.result())
            yield self._encode(res) if encode and not fuse_encode else res
        self.stats.wall_ms += now_ms() - t_start
