"""Lossless DCT-domain JPEG transforms — the jpegtran analog, on device.

jpegtran (transupp.c) rotates/flips JPEGs without decoding: coefficient
blocks are permuted on the block grid and adjusted inside each 8x8 via
DCT symmetries, so no IDCT/fDCT rounding ever happens. Those symmetries
are pure tensor ops — grid reversals, per-axis sign masks, 8x8
transposes — i.e. exactly the shape of work an accelerator does for free
inside one jitted program, batchable and shardable like the rest of the codec.

DCT symmetries used (for an 8x8 block B[u, v] of a sample block b[y, x]):
- mirror horizontally (x -> 7-x):  B[u, v] -> (-1)^v  * B[u, v]
- mirror vertically   (y -> 7-y):  B[u, v] -> (-1)^u  * B[u, v]
- transpose           (x <-> y):   B[u, v] -> B[v, u]

Grid-level, the block positions mirror/transpose correspondingly.

Exactness domain: like jpegtran's -perfect, a flip is lossless only
when the flipped axis is a whole number of iMCUs (image dim % (8 *
samp) == 0) — otherwise the hidden edge-block samples would have to
re-enter the visible image, which cannot be expressed losslessly.
Transpose is always perfect; rot90/rot270/rot180 inherit the flip
constraints on the respective axes. Unsupported geometry raises.

Reference behavior reproduced: jpegtran's documented transform
semantics (the reference's CImg stack has no DCT-domain transform — a
beyond-parity capability). "Lossless" means what it means for jpegtran:
COEFFICIENT-exact (tested against an independent loop oracle, plus a
float-IDCT semantic check, plus byte-identical involutions). The
INTEGER decode of a transformed stream can differ from the spatial
transform of the original decode by +-1 per sample — jpeg_idct_islow's
floor-shift descales are not odd-symmetric and its pass order is fixed
(and subsampled chroma upsampling swaps rounding phase under
mirroring); jpegtran output has exactly the same property.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from hipe_tpu.io_ import jpeg as jio

# The DCT-domain tensor transforms (per-component coefficient ops).
OPS = ("flip_h", "flip_v", "rot90", "rot180", "rot270", "transpose",
       "transverse")
# Everything transform_bytes/transform_batch accept: the tensor ops plus
# the component-drop op (jpegtran -grayscale keeps luma verbatim).
ALL_OPS = OPS + ("grayscale",)

_SIGN_V = np.array([(-1) ** v for v in range(8)], dtype=np.int16)


def _blocks(c: jnp.ndarray) -> jnp.ndarray:
    return c.reshape(*c.shape[:-1], 8, 8)


def _flat(b: jnp.ndarray) -> jnp.ndarray:
    return b.reshape(*b.shape[:-2], 64)


def _flip_h(c: jnp.ndarray) -> jnp.ndarray:
    """Mirror horizontally: reverse block columns, negate odd-v coefs."""
    b = _blocks(c)[..., :, ::-1, :, :]
    return _flat(b * jnp.asarray(_SIGN_V))


def _flip_v(c: jnp.ndarray) -> jnp.ndarray:
    """Mirror vertically: reverse block rows, negate odd-u coefs."""
    b = _blocks(c)[..., ::-1, :, :, :]
    return _flat(b * jnp.asarray(_SIGN_V)[:, None])


def _transpose(c: jnp.ndarray) -> jnp.ndarray:
    """Transpose: swap the block grid and each 8x8's u/v axes."""
    b = _blocks(c)
    return _flat(jnp.swapaxes(jnp.swapaxes(b, -4, -3), -2, -1))


def transform_component(c: jnp.ndarray, op: str) -> jnp.ndarray:
    """Apply one lossless op to a (..., Hb, Wb, 64) coefficient grid."""
    if op == "flip_h":
        return _flip_h(c)
    if op == "flip_v":
        return _flip_v(c)
    if op == "transpose":
        return _transpose(c)
    if op == "rot90":      # clockwise: transpose, then mirror horizontally
        return _flip_h(_transpose(c))
    if op == "rot270":     # counter-clockwise
        return _flip_v(_transpose(c))
    if op == "rot180":
        return _flip_v(_flip_h(c))
    if op == "transverse":  # transpose across the anti-diagonal
        return _flip_v(_flip_h(_transpose(c)))
    raise ValueError(f"unknown transform {op!r} (one of {OPS})")


def _swaps_axes(op: str) -> bool:
    return op in ("rot90", "rot270", "transpose", "transverse")


def _check_perfect(co, op: str) -> None:
    """Raise unless `op` is lossless for this stream (jpegtran -perfect)."""
    max_h = max(c.h_samp for c in co.components)
    max_v = max(c.v_samp for c in co.components)
    w_ok = co.width % (8 * max_h) == 0
    h_ok = co.height % (8 * max_v) == 0
    need = {
        "flip_h": w_ok, "flip_v": h_ok, "rot180": w_ok and h_ok,
        # After the transpose, the flipped axis is the ORIGINAL h/v.
        "rot90": h_ok, "rot270": w_ok, "transverse": w_ok and h_ok,
        "transpose": True,
    }[op]
    if not need:
        raise ValueError(
            f"{op} is not lossless for {co.width}x{co.height} at sampling "
            f"{max_h}x{max_v}: the trailing partial iMCU cannot re-enter "
            f"the image without recompression (jpegtran -perfect rule)"
        )


def _subsampling_name(samp: list, ncomps: int) -> str:
    """Writer layout name for a per-component sampling list."""
    if ncomps == 1:
        return "444"
    key = tuple(samp)
    if key not in _SAMP_NAMES:
        raise ValueError(f"no writer layout for sampling {samp}")
    return _SAMP_NAMES[key]


def _swapped_pieces(components, width: int, height: int, op: str):
    """(w, h, samp, qtables) after `op`'s optional axis swap."""
    qtables = [np.asarray(c.qtable, dtype=np.uint16) for c in components]
    if _swaps_axes(op):
        w, h = height, width
        samp = [(c.v_samp, c.h_samp) for c in components]
        qtables = [q.reshape(8, 8).T.reshape(64).copy() for q in qtables]
    else:
        w, h = width, height
        samp = [(c.h_samp, c.v_samp) for c in components]
    return w, h, samp, qtables


def _grayscale_luma(co):
    """The luma plane trimmed to single-component iMCU geometry.

    jpegtran -grayscale: drop the chroma components, keep the luma
    coefficients verbatim (lossless for Y by construction). The color
    stream pads Y's block array to max_h x max_v iMCUs; a
    single-component stream's iMCU is one block, so the extra dummy
    padding blocks (if any) are trimmed — they carry no image data.
    """
    comp0 = co.components[0]
    if (comp0.h_samp, comp0.v_samp) != (co.max_h, co.max_v):
        raise ValueError(
            "grayscale keep needs full-resolution luma (component 0 must "
            f"carry max sampling; got {comp0.h_samp}x{comp0.v_samp} of "
            f"{co.max_h}x{co.max_v})"
        )
    hb, wb = -(-co.height // 8), -(-co.width // 8)
    return np.ascontiguousarray(comp0.coefs[:hb, :wb]).astype(np.int16)


def transform_coefficients(co, op: str):
    """Losslessly transform an io_.jpeg.JpegCoefficients -> writer pieces.

    Returns (comp_coefs, width, height, comps_samp, qtables): the
    transformed per-component (Hb, Wb, 64) int16 arrays (numpy,
    host-side), the new image dims, the per-component (h_samp, v_samp)
    after any axis swap, and the output quant tables — TRANSPOSED for
    the transpose-family ops (the dequantized product C[u,v]*Q[u,v] is
    what the symmetry acts on, so Q transposes with C; transupp.c does
    the same). Runs the tensor ops under jit on the default device.

    ``op="grayscale"`` (jpegtran -grayscale) is the one non-tensor op:
    chroma components are dropped, luma passes through untouched.
    """
    if op == "grayscale":
        return ([_grayscale_luma(co)], co.width, co.height, [(1, 1)],
                [co.components[0].qtable])
    _check_perfect(co, op)
    out = []
    for comp in co.components:
        t = np.asarray(_jitted(op)(jnp.asarray(comp.coefs)))
        out.append(t.astype(np.int16))
    w, h, samp, qtables = _swapped_pieces(co.components, co.width,
                                          co.height, op)
    return out, w, h, samp, qtables


_JITTED: dict = {}


def _jitted(op: str):
    if op not in _JITTED:
        _JITTED[op] = jax.jit(lambda c, _op=op: transform_component(c, _op))
    return _JITTED[op]


_SAMP_NAMES = {
    ((2, 2), (1, 1), (1, 1)): "420",
    ((1, 1), (1, 1), (1, 1)): "444",
    ((2, 1), (1, 1), (1, 1)): "422",
    ((1, 2), (1, 1), (1, 1)): "440",
    ((4, 1), (1, 1), (1, 1)): "411",
    ((4, 2), (1, 1), (1, 1)): "410",
    ((3, 1), (1, 1), (1, 1)): "311",
    ((2, 2), (2, 1), (1, 1)): "asym",
}


def transform_bytes(data: bytes, op: str, copy_markers: bool = True,
                    **writer_opts) -> bytes:
    """jpegtran analog: losslessly transform a JPEG byte stream.

    Entropy-decodes on host, runs the DCT-domain tensor transform under
    jit, entropy-encodes back with the stream's OWN quant tables
    (transposed alongside the coefficients for transpose-family ops) —
    no requantization ever, regardless of what quality produced the
    stream. Writer entropy options (progressive/arithmetic/optimize/
    restart_interval) pass through, since they do not touch
    coefficients. ``copy_markers`` (default, the jpegtran -copy all
    behavior) carries COM/APP1-13 metadata — Exif, ICC, XMP — into the
    output. NOTE: spatial metadata inside the markers (Exif orientation,
    thumbnails, pixel-dimension tags) is copied verbatim, not rewritten
    — same as jpegtran.
    """
    co = jio.read_coefficients(data)
    if copy_markers:
        writer_opts.setdefault("markers", jio.read_markers(data))
    coefs, w, h, samp, qtables = transform_coefficients(co, op)
    sub = _subsampling_name(samp, len(coefs))
    return jio.write_coefficients(coefs, w, h, subsampling=sub,
                                  qtables=qtables, **writer_opts)


def _has_metadata(data: bytes) -> bool:
    """Cheap segment scan: any COM/APP1-13 marker before SOS?

    Pure-Python walk of the marker segments (each a few bytes of
    header), so the batch path only pays a native read_markers parse
    for payloads that actually carry metadata.
    """
    p = 2  # past SOI
    n = len(data)
    while p + 4 <= n:
        if data[p] != 0xFF:
            return False  # not a well-formed segment stream; be safe
        # Spec-legal 0xFF fill bytes may pad before the marker code.
        while p + 4 <= n and data[p + 1] == 0xFF:
            p += 1
        if p + 4 > n:
            return False
        code = data[p + 1]
        if code == 0xDA:  # SOS: entropy data follows
            return False
        if code == 0xFE or 0xE1 <= code <= 0xED:
            return True
        seglen = (data[p + 2] << 8) | data[p + 3]
        p += 2 + seglen
    return False


def transform_batch(payloads: list[bytes], op: str,
                    num_threads: int | None = None,
                    copy_markers: bool = True,
                    **writer_opts) -> list[bytes]:
    """Batched lossless transform: one jitted tensor op per geometry group.

    The serving-scale shape of transform_bytes: entropy decode via the
    GIL-free native batch reader, ONE jit call per (geometry, op) on the
    stacked coefficient grids (batch dims broadcast through the tensor
    ops, and shard over a DP mesh like the rest of the codec), entropy
    encode via the pthread batch writer. Mixed geometries group like the
    serving transcode path; per-image table overrides require matching
    tables within a group (one encoder's stream — the common case), so
    groups key on the quant tables too.
    """
    cos = jio.read_coefficients_batch(payloads, num_threads=num_threads)
    groups: dict[tuple, list[int]] = {}
    for i, co in enumerate(cos):
        key = (co.width, co.height,
               tuple((c.h_samp, c.v_samp) for c in co.components),
               tuple(tuple(int(v) for v in c.qtable) for c in co.components))
        groups.setdefault(key, []).append(i)
    out: list[bytes | None] = [None] * len(cos)
    for idxs in groups.values():
        rep = cos[idxs[0]]
        if op == "grayscale":
            # Non-tensor op: drop chroma, keep luma verbatim (trimmed to
            # single-component iMCU geometry).
            transformed = [np.stack([_grayscale_luma(cos[i])
                                     for i in idxs])]
            w, h = rep.width, rep.height
            samp, qtables = [(1, 1)], [rep.components[0].qtable]
            ncomps = 1
        else:
            _check_perfect(rep, op)
            ncomps = len(rep.components)
            stacked = [
                np.stack([cos[i].components[ci].coefs for i in idxs])
                for ci in range(ncomps)
            ]
            transformed = [
                np.asarray(_jitted(op)(jnp.asarray(s))).astype(np.int16)
                for s in stacked
            ]
            w, h, samp, qtables = _swapped_pieces(
                rep.components, rep.width, rep.height, op
            )
        sub = _subsampling_name(samp, ncomps)
        group_markers = (
            [jio.read_markers(payloads[i])
             if _has_metadata(payloads[i]) else []
             for i in idxs]
            if copy_markers else [[] for _ in idxs]
        )
        if any(group_markers):
            # Markers are per-image; the pthread batch writer shares one
            # option set, so metadata-carrying images take the single
            # writer (markers are rare in machine-generated streams; a
            # camera-originals batch trades GIL-free writes for -copy).
            files = [
                jio.write_coefficients(
                    [t[j] for t in transformed], w, h, subsampling=sub,
                    qtables=qtables, markers=group_markers[j],
                    **writer_opts)
                for j in range(len(idxs))
            ]
        else:
            files = jio.write_coefficients_batch(
                transformed, w, h, subsampling=sub, qtables=qtables,
                num_threads=num_threads, **writer_opts)
        for j, i in enumerate(idxs):
            out[i] = files[j]
    return out


def crop_coefficients(co, x: int, y: int, w: int, h: int):
    """Lossless crop: slice the block grids (jpegtran -crop semantics).

    (x, y) must be iMCU-aligned (multiples of 8*max_h / 8*max_v) — the
    entropy stream cannot start mid-iMCU; w/h are arbitrary positive
    sizes clipped at the image bounds. Returns the same writer pieces as
    transform_coefficients (no sampling/table changes). Like jpegtran,
    pixels inside the crop decode from the identical coefficient blocks
    — EXACT at the per-component sample level everywhere. Full-pixel
    equality with the uncropped decode holds everywhere for 4:4:4 /
    grayscale; for subsampled streams the chroma upsampler replicates at
    each NEW crop edge where the original had real neighbors, so the
    one-pixel edge ring can differ (interior identical) — the same
    behavior jpegtran -crop has.
    """
    imcu_w, imcu_h = 8 * co.max_h, 8 * co.max_v
    if x % imcu_w or y % imcu_h:
        raise ValueError(
            f"crop origin ({x}, {y}) must be iMCU-aligned "
            f"(multiples of {imcu_w}x{imcu_h} for this stream)"
        )
    if not (0 <= x < co.width and 0 <= y < co.height):
        raise ValueError(f"crop origin ({x}, {y}) outside "
                         f"{co.width}x{co.height}")
    if w <= 0 or h <= 0:
        raise ValueError("crop size must be positive")
    w = min(w, co.width - x)
    h = min(h, co.height - y)
    out = []
    samp = []
    qtables = []
    for comp in co.components:
        bx0 = x * comp.h_samp // (8 * co.max_h)
        by0 = y * comp.v_samp // (8 * co.max_v)
        dw = -(-w * comp.h_samp // co.max_h)
        dh = -(-h * comp.v_samp // co.max_v)
        wb, hb = -(-dw // 8), -(-dh // 8)
        out.append(np.ascontiguousarray(
            comp.coefs[by0:by0 + hb, bx0:bx0 + wb]))
        samp.append((comp.h_samp, comp.v_samp))
        qtables.append(np.asarray(comp.qtable, dtype=np.uint16))
    return out, w, h, samp, qtables


def crop_bytes(data: bytes, x: int, y: int, w: int, h: int,
               copy_markers: bool = True, **writer_opts) -> bytes:
    """jpegtran -crop analog: extract a region without recompression."""
    co = jio.read_coefficients(data)
    if copy_markers:
        writer_opts.setdefault("markers", jio.read_markers(data))
    coefs, w, h, samp, qtables = crop_coefficients(co, x, y, w, h)
    sub = _subsampling_name(samp, len(co.components))
    return jio.write_coefficients(coefs, w, h, subsampling=sub,
                                  qtables=qtables, **writer_opts)
