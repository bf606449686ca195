"""User-defined convolution kernels + the PIL builtin preset family.

Engine semantics: exact integer arithmetic, round-half-up
(ops/blur.py register_kernel_filter). Bit-identical to PIL ImageFilter
for scale-1 / power-of-two / odd scales; for even non-dyadic scales the
only deviations sit on exact .5 ties (PIL's fp32 tap normalization
resolves those implementation-definedly) and are +-1 — asserted exactly.
PIL copies border pixels through unfiltered, so PIL comparisons are
interior-only; engine borders are clamp-to-edge like every stage.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hipe_tpu.models import pipelines as plib
from hipe_tpu.ops import blur as xblur
from hipe_tpu.ops import reference as oracle


def _rand_img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _pil_filter(img, preset):
    from PIL import Image, ImageFilter

    pf = getattr(ImageFilter, preset[4:].upper())
    if img.ndim == 2:
        return np.asarray(Image.fromarray(img).filter(pf))
    return np.stack(
        [np.asarray(Image.fromarray(img[:, :, c]).filter(pf))
         for c in range(img.shape[2])], axis=-1)


def test_preset_tables_match_installed_pil():
    # The hardcoded tap tables must equal the installed PIL's filterargs,
    # so a Pillow bump can't silently drift the presets.
    from PIL import ImageFilter

    for nm, (taps, scale, off) in xblur.PIL_PRESETS.items():
        pf = getattr(ImageFilter, nm[4:].upper())
        psize, pscale, poff, ptaps = pf.filterargs
        assert tuple(ptaps) == taps, nm
        assert (pscale, poff) == (scale, off), nm


@pytest.mark.parametrize("preset", sorted(xblur.PIL_PRESETS))
def test_presets_match_oracle_all_layouts(preset):
    img = _rand_img((37, 44, 3), seed=hash(preset) % 2**31)
    taps, scale, off = xblur.PIL_PRESETS[preset]
    r = xblur.FILTER_RADIUS[preset]
    want = oracle.kernel_oracle(img, taps, scale, off)
    got = np.asarray(xblur.FILTERS[preset](jnp.asarray(img)))
    np.testing.assert_array_equal(got, want, err_msg=f"{preset} hwc")
    rows = jnp.asarray(img[None].reshape(1, 37, 44 * 3))
    got_rows = np.asarray(
        xblur.ROWS_FILTERS[preset](rows, 3)).reshape(37, 44, 3)
    np.testing.assert_array_equal(got_rows, want, err_msg=f"{preset} rows")
    got_valid = np.asarray(
        xblur.FILTERS[preset](jnp.asarray(img), h_pad=False))
    np.testing.assert_array_equal(got_valid, want[r:-r],
                                  err_msg=f"{preset} halo")


def _tie_mask(img, taps, scale, size):
    """Pixels whose exact value acc/scale + off lands on X.5 exactly."""
    r = size // 2
    h, w = img.shape[:2]
    pad = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    xp = np.pad(img, pad, mode="edge").astype(np.int64)
    t = np.array(taps, np.int64).reshape(size, size)[::-1]
    acc = np.zeros(img.shape, np.int64)
    for dy in range(size):
        for dx in range(size):
            acc += t[dy, dx] * xp[dy:dy + h, dx:dx + w]
    return (2 * acc) % (2 * scale) == scale


@pytest.mark.parametrize("preset", sorted(xblur.PIL_PRESETS))
def test_presets_vs_pil_interior(preset):
    img = _rand_img((48, 56, 3), seed=101)
    taps, scale, off = xblur.PIL_PRESETS[preset]
    r = xblur.FILTER_RADIUS[preset]
    got = oracle.kernel_oracle(img, taps, scale, off)
    pil = _pil_filter(img, preset)
    inner = slice(r, -r)
    diff = got[inner, inner].astype(int) - pil[inner, inner].astype(int)
    exact = scale == 1 or (scale & (scale - 1)) == 0 or scale % 2 == 1
    if exact:
        assert (diff == 0).all(), (preset, np.abs(diff).max())
    else:
        # Even non-dyadic scale: deviations must be exactly the engine's
        # round-up vs PIL's fp32-noise coin flip on exact ties — +-1 and
        # confined to tie pixels.
        assert np.abs(diff).max() <= 1, preset
        ties = _tie_mask(img, taps, scale, 2 * r + 1)[inner, inner]
        assert ((diff == 0) | ties).all(), preset


def test_kernel_stages_planar_and_rows():
    x = np.stack([_rand_img((32, 48), seed=s) for s in range(4)])
    for nm in ("pil_emboss", "pil_smooth", "pil_blur", "pil_smooth_more"):
        taps, scale, off = xblur.PIL_PRESETS[nm]
        want = np.stack([
            oracle.kernel_oracle(p[..., None], taps, scale, off)[..., 0]
            for p in x])
        got = np.asarray(xblur.filter_chain(
            jnp.asarray(x), (nm,), h_axis=-2, w_axis=-1))
        np.testing.assert_array_equal(got, want, err_msg=f"{nm} planar")
        got_r = np.asarray(xblur.filter_chain_rows(jnp.asarray(x), 1, (nm,)))
        np.testing.assert_array_equal(got_r, want, err_msg=f"{nm} rows")
    # Kernel stages mix with stencil/nonlinear stages in one chain.
    mix = ("gaussian3", "pil_emboss", "median")
    want = np.asarray(xblur.filter_chain(
        jnp.asarray(x)[..., None], mix, h_axis=-3, w_axis=-2))[..., 0]
    got = np.asarray(xblur.filter_chain(
        jnp.asarray(x), mix, h_axis=-2, w_axis=-1))
    np.testing.assert_array_equal(got, want)


def test_row_split_kernel_stage_seam_exact():
    from hipe_tpu.parallel import mesh as meshlib
    from hipe_tpu.parallel.row_split import (
        make_row_split_fn, make_weighted_row_split_fn)

    mesh = meshlib.make_mesh(4, axis=meshlib.ROW_AXIS)
    batch = np.stack([_rand_img((64, 40, 3), seed=s) for s in range(2)])
    # Radius-2 (5x5) preset through the generic halo machinery.
    taps, scale, off = xblur.PIL_PRESETS["pil_blur"]
    want = np.stack([oracle.kernel_oracle(b, taps, scale, off)
                     for b in batch])
    got = np.asarray(
        make_row_split_fn(mesh, ("pil_blur",))(jnp.asarray(batch)))
    np.testing.assert_array_equal(got, want)
    te, se, oe = xblur.PIL_PRESETS["pil_emboss"]
    want2 = np.stack([oracle.gaussian_blur_int_oracle(
        oracle.kernel_oracle(b, te, se, oe)) for b in batch])
    wfn = make_weighted_row_split_fn(
        mesh, ("pil_emboss", "gaussian3"), weights=[1, 3, 2, 2])
    np.testing.assert_array_equal(np.asarray(wfn(jnp.asarray(batch))), want2)


def test_register_kernel_filter_validation():
    reg = xblur.register_kernel_filter
    with pytest.raises(ValueError, match="odd square"):
        reg("k_bad1", (1, 2, 3))
    with pytest.raises(ValueError, match="positive integer"):
        reg("k_bad2", (0,) * 9, scale=0)
    with pytest.raises(ValueError, match="scale must be a positive"):
        reg("k_bad3", (1, -1, 0, 0, 0, 0, 0, 0, 0))  # default scale = sum = 0
    with pytest.raises(ValueError, match="multiple of 0.5"):
        reg("k_bad4", (1,) * 9, scale=9, offset=0.3)
    with pytest.raises(ValueError, match="too large"):
        reg("k_bad5", (30000,) * 9, scale=1)
    with pytest.raises(ValueError, match="builtin filter name"):
        reg("gaussian3", (1,) * 9, scale=9)
    # Idempotent re-register; conflicting spec raises.
    reg("k_dup", (1,) * 9, scale=9)
    reg("k_dup", (1,) * 9, scale=9)
    with pytest.raises(ValueError, match="different spec"):
        reg("k_dup", (1,) * 9, scale=10)


def test_custom_kernel_chain_and_registry_pipeline():
    xblur.register_kernel_filter("k_soft", (1, 2, 1, 2, 4, 2, 1, 2, 1),
                                 16, 0.5)
    img = _rand_img((30, 34, 3), seed=7)
    pipe = plib.get(["k_soft", "sharpen"])
    assert pipe.radius == 2
    got = np.asarray(pipe(jnp.asarray(img)))
    want = oracle.sharpen3x3_oracle(
        oracle.kernel_oracle(img, (1, 2, 1, 2, 4, 2, 1, 2, 1), 16, 0.5))
    np.testing.assert_array_equal(got, want)
    # PIL default scale (sum of taps).
    xblur.register_kernel_filter("k_box", (1,) * 9)
    assert xblur.KERNEL_STAGES["k_box"]["scale"] == 9


def test_cli_kernel_flag():
    from hipe_tpu.cli import _register_cli_kernels

    assert _register_cli_kernels(
        ["k_cli=1,2,1,2,4,2,1,2,1:16:0.5"]) is None
    assert xblur.KERNEL_STAGES["k_cli"]["off2"] == 1
    # Scale defaulting (empty field) and offset-less forms.
    assert _register_cli_kernels(["k_cli2=1,1,1,1,1,1,1,1,1"]) is None
    assert xblur.KERNEL_STAGES["k_cli2"]["scale"] == 9
    err = _register_cli_kernels(["nope"])
    assert err and "bad --kernel" in err
    err = _register_cli_kernels(["k_cli3=1,2"])
    assert err and "odd square" in err
