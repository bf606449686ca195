"""Histogram equalization: PIL-exact LUT build, gather apply, psum sharding.

Three-way exactness: PIL ``ImageOps.equalize`` (the external oracle) ==
the NumPy oracle (``equalize_oracle``) == the JAX gather path, plus the
psum row-split on a virtual mesh == single-device, plus the
serving/pipeline integrations.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hipe_tpu.ops import equalize as eq
from hipe_tpu.models import pipelines as plib


def _pil_equalize(img: np.ndarray) -> np.ndarray:
    from PIL import Image, ImageOps

    mode = "L" if img.ndim == 2 else "RGB"
    return np.asarray(ImageOps.equalize(Image.fromarray(img, mode)))


def _cases():
    rng = np.random.default_rng(42)
    cases = {
        "uniform": rng.integers(0, 256, (64, 80, 3), np.uint8),
        "lowrange": rng.integers(90, 110, (64, 64, 3), np.uint8),
        "skewed": np.clip(
            (rng.normal(40, 12, (128, 96, 3))), 0, 255
        ).astype(np.uint8),
        "constant": np.full((48, 48, 3), 77, np.uint8),
        "twovals": np.where(
            rng.random((64, 64, 3)) < 0.7, 10, 200
        ).astype(np.uint8),
        # step == 0: tiny image whose non-last mass is < 255 pixels
        "tiny": rng.integers(0, 256, (8, 8, 3), np.uint8),
    }
    # LUT-overflow case: most pixels in the last populated bin -> raw LUT
    # values exceed 255; PIL clamps (verified) and so must we.
    a = np.full((256, 256, 3), 200, np.uint8)
    flat = a.reshape(-1, 3)
    idx = rng.choice(len(flat), 5536, replace=False)
    flat[idx] = rng.integers(0, 21, (5536, 3)).astype(np.uint8)
    cases["overflow"] = a
    return cases


@pytest.mark.parametrize("name,img", _cases().items(),
                         ids=list(_cases().keys()))
def test_oracle_matches_pil(name, img):
    np.testing.assert_array_equal(eq.equalize_oracle(img), _pil_equalize(img))


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_jax_paths_match_oracle(jit):
    fn = jax.jit(eq.equalize_nhwc) if jit else eq.equalize_nhwc
    for name, img in _cases().items():
        got = np.asarray(fn(jnp.asarray(img)))
        np.testing.assert_array_equal(got, eq.equalize_oracle(img),
                                      err_msg=f"case {name} jit={jit}")


def test_grayscale_plane():
    img = np.random.default_rng(7).integers(0, 256, (64, 64), np.uint8)
    got = np.asarray(eq.equalize_planar(jnp.asarray(img)[None]))[0]
    np.testing.assert_array_equal(got, _pil_equalize(img))


def test_layout_consistency():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (2, 32, 48, 3), np.uint8)
    nhwc = np.asarray(eq.equalize_nhwc(jnp.asarray(x)))
    rows = np.asarray(
        eq.equalize_rows(jnp.asarray(x.reshape(2, 32, 48 * 3)), 3)
    ).reshape(2, 32, 48, 3)
    np.testing.assert_array_equal(nhwc, rows)
    for b in range(2):
        np.testing.assert_array_equal(nhwc[b], eq.equalize_oracle(x[b]))


def test_pipeline_registry_and_methods():
    pipe = plib.get("equalize")
    assert pipe.has_kernel is False
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (40, 56, 3), np.uint8)
    want = eq.equalize_oracle(x)
    np.testing.assert_array_equal(np.asarray(pipe(jnp.asarray(x))), want)
    np.testing.assert_array_equal(
        np.asarray(pipe.apply_nhwc(jnp.asarray(x)[None], use_pallas=True))[0],
        want,
    )
    rows = jnp.asarray(x.reshape(1, 40, 56 * 3))
    np.testing.assert_array_equal(
        np.asarray(pipe.apply_rows(rows, 3, use_pallas=False)).reshape(
            40, 56, 3
        ),
        want,
    )
    # use_pallas is accepted (no kernel: XLA); halo mode is refused.
    planes = jnp.asarray(x.transpose(2, 0, 1))
    np.testing.assert_array_equal(
        np.asarray(pipe.apply_planar(planes, use_pallas=True)),
        want.transpose(2, 0, 1),
    )
    with pytest.raises(ValueError, match="h_pad"):
        pipe.apply_planar(planes, h_pad=False)


def test_stream_scale_apply_chunks_bit_exact(monkeypatch):
    """Above GLOBAL_STATS_PLANE_CHUNK planes, apply_planar runs the op as
    a lax.map over image-aligned chunks (the unchunked equalize gather
    OOM'd HBM at the 5000-image resident stream on silicon: int32 index +
    output temps ~8 GB, "Used 16.48G of 15.75G"). Chunking must be
    bit-identical for every global-statistics family."""
    rng = np.random.default_rng(3)
    planes = jnp.asarray(rng.integers(0, 256, (12, 16, 24), np.uint8))
    cases = [
        ("equalize", {}),
        ("autocontrast", {"cutoff": 2}),
        ("contrast", {"factor": 1.4}),
        ("color", {"factor": 0.5}),
        ("sharpness", {"factor": 2.0}),
    ]
    assert plib._global_stats_chunk(12, 3) is None  # default limit: no-op
    # 15000-plane stream (the shape that OOM'd): chunks to 3000 planes.
    assert plib._global_stats_chunk(15000, 3) == 3000
    for name, kw in cases:
        pipe = plib.GlobalStatsPipeline(name, **kw)
        want = np.asarray(pipe.apply_planar(planes, use_pallas=False))
        monkeypatch.setattr(plib, "GLOBAL_STATS_PLANE_CHUNK", 6)
        assert plib._global_stats_chunk(12, 3) == 6
        got = pipe.apply_planar(planes)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)
        monkeypatch.setattr(plib, "GLOBAL_STATS_PLANE_CHUNK", 3072)


def test_no_radius_and_no_halo_fns():
    pipe = plib.get("equalize")
    with pytest.raises(ValueError, match="psum"):
        pipe.radius
    with pytest.raises(ValueError, match="psum"):
        pipe.nhwc_halo_fn()
    with pytest.raises(ValueError, match="psum"):
        pipe.nhwc_clamp_fn()
    with pytest.raises(KeyError):
        plib.get(["gaussian3", "equalize"])


@pytest.mark.parametrize("n_shards", [8, 4])
def test_row_split_psum_exact(n_shards):
    """n-way H sharding == single device."""
    from hipe_tpu.parallel.mesh import ROW_AXIS
    from hipe_tpu.parallel.row_split import make_equalize_row_split_fn
    from jax.sharding import Mesh

    devs = jax.devices("cpu")[:n_shards]
    mesh = Mesh(np.array(devs), (ROW_AXIS,))
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, (2, 64, 48, 3), np.uint8)
    fn = make_equalize_row_split_fn(mesh)
    got = np.asarray(fn(jnp.asarray(x)))
    for b in range(2):
        np.testing.assert_array_equal(got[b], eq.equalize_oracle(x[b]))


def test_row_split_psum_rows_layout_dp_sp():
    """DP x SP 2-D mesh on interleaved rows layout."""
    from hipe_tpu.parallel.mesh import ROW_AXIS
    from hipe_tpu.parallel.row_split import make_equalize_row_split_fn
    from jax.sharding import Mesh

    devs = jax.devices("cpu")[:8]
    mesh = Mesh(np.array(devs).reshape(2, 4), ("batch", ROW_AXIS))
    rng = np.random.default_rng(13)
    x = rng.integers(0, 256, (4, 32, 40, 3), np.uint8)
    fn = make_equalize_row_split_fn(mesh, batch_axis="batch", channels=3)
    rows = jnp.asarray(x.reshape(4, 32, 40 * 3))
    got = np.asarray(fn(rows)).reshape(4, 32, 40, 3)
    for b in range(4):
        np.testing.assert_array_equal(got[b], eq.equalize_oracle(x[b]))


def test_serving_pipeline_equalize():
    """decode -> equalize -> encode == PIL equalize of the decoded pixels."""
    from hipe_tpu.io_ import jpeg
    from hipe_tpu.runtime.serve import ServingPipeline

    rng = np.random.default_rng(17)
    imgs = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(2)]
    payloads = [jpeg.encode_bytes(im, 90) for im in imgs]
    px = ServingPipeline("equalize", use_pallas=False).process_batch(
        payloads, encode=False
    )
    for got, payload in zip(px, payloads):
        np.testing.assert_array_equal(
            got, eq.equalize_oracle(jpeg.decode_bytes(payload))
        )
    # Fused with the device decode (IDCT/upsample/color + equalize in one
    # jitted program) — same pixels.
    fused = ServingPipeline(
        "equalize", use_pallas=False, decode_on_device=True
    ).process_batch(payloads, encode=False)
    np.testing.assert_array_equal(np.stack(fused), np.stack(px))


def test_serving_equalize_encode_placements():
    """Host-encode, device-encode, and full transcode emit identical
    bytes for the global-statistics pipeline too."""
    from hipe_tpu.io_ import jpeg
    from hipe_tpu.runtime.serve import ServingPipeline

    rng = np.random.default_rng(37)
    payloads = [
        jpeg.encode_bytes(
            rng.integers(0, 256, (32, 48, 3), np.uint8), 90
        )
        for _ in range(2)
    ]
    ref = ServingPipeline("equalize", use_pallas=False).process_batch(
        payloads
    )
    for kwargs in ({"encode_on_device": True},
                   {"decode_on_device": True, "encode_on_device": True}):
        got = ServingPipeline(
            "equalize", use_pallas=False, **kwargs
        ).process_batch(payloads)
        assert got == ref, kwargs


def _pil_autocontrast(img: np.ndarray) -> np.ndarray:
    from PIL import Image, ImageOps

    mode = "L" if img.ndim == 2 else "RGB"
    return np.asarray(ImageOps.autocontrast(Image.fromarray(img, mode)))


def _ac_cases():
    rng = np.random.default_rng(23)
    cases = {
        "uniform": rng.integers(0, 256, (64, 80, 3), np.uint8),
        "narrow": rng.integers(100, 140, (64, 64, 3), np.uint8),
        "constant": np.full((32, 32, 3), 7, np.uint8),
        "fullrange": np.clip(
            rng.integers(-4, 260, (48, 48, 3)), 0, 255
        ).astype(np.uint8),
    }
    # The float64 quirk: lo=26, hi=33 -> scale=fl(255/7) < 255/7, so the
    # max pixel maps to 254, NOT 255. Bit-exactness with PIL means
    # reproducing exactly that.
    q = rng.integers(26, 34, (40, 40, 3)).astype(np.uint8)
    q[0, 0] = 26
    q[0, 1] = 33
    cases["float_quirk"] = q
    return cases


@pytest.mark.parametrize("name,img", _ac_cases().items(),
                         ids=list(_ac_cases().keys()))
def test_autocontrast_oracle_matches_pil(name, img):
    got = eq.autocontrast_oracle(img)
    np.testing.assert_array_equal(got, _pil_autocontrast(img))
    if name == "float_quirk":
        assert got[img == 33].max() == 254  # the fp64 rounding, reproduced


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_autocontrast_jax_matches_pil(jit):
    fn = jax.jit(eq.autocontrast_nhwc) if jit else eq.autocontrast_nhwc
    for name, img in _ac_cases().items():
        got = np.asarray(fn(jnp.asarray(img)))
        np.testing.assert_array_equal(
            got, _pil_autocontrast(img), err_msg=f"case {name} jit={jit}",
        )


@pytest.mark.parametrize("cutoff", [1, 2, 10, (1, 5), (0, 20)],
                         ids=["1", "2", "10", "1-5", "0-20"])
def test_autocontrast_cutoff_matches_pil(cutoff):
    from PIL import Image, ImageOps

    pil_cut = cutoff if isinstance(cutoff, tuple) else cutoff
    for name, img in _ac_cases().items():
        want = np.asarray(
            ImageOps.autocontrast(Image.fromarray(img, "RGB"),
                                  cutoff=pil_cut)
        )
        got_oracle = eq.autocontrast_oracle(img, cutoff=cutoff)
        np.testing.assert_array_equal(got_oracle, want,
                                      err_msg=f"oracle {name} {cutoff}")
        got = np.asarray(
            eq.autocontrast_nhwc(jnp.asarray(img), cutoff=cutoff)
        )
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"jax {name} {cutoff}")


def test_autocontrast_cutoff_validation_and_extreme():
    with pytest.raises(ValueError, match="cutoff"):
        eq.autocontrast_oracle(np.zeros((8, 8, 3), np.uint8), cutoff=2.5)
    with pytest.raises(ValueError, match="cutoff"):
        eq.autocontrast_nhwc(jnp.zeros((8, 8, 3), jnp.uint8),
                             cutoff=(60, 60))
    # Cuts consuming (nearly) the whole histogram still match PIL.
    from PIL import Image, ImageOps

    img = np.random.default_rng(41).integers(
        0, 256, (16, 16, 3), np.uint8
    )
    want = np.asarray(
        ImageOps.autocontrast(Image.fromarray(img, "RGB"), cutoff=49)
    )
    np.testing.assert_array_equal(
        np.asarray(eq.autocontrast_nhwc(jnp.asarray(img), cutoff=49)), want
    )


def test_autocontrast_cutoff_row_split_psum():
    """cutoff switches the sharded collective to psum; still exact."""
    from hipe_tpu.parallel.mesh import ROW_AXIS
    from hipe_tpu.parallel.row_split import make_autocontrast_row_split_fn
    from jax.sharding import Mesh

    devs = jax.devices("cpu")[:8]
    mesh = Mesh(np.array(devs), (ROW_AXIS,))
    rng = np.random.default_rng(43)
    x = rng.integers(20, 230, (2, 64, 48, 3), np.uint8)
    x[0, 2, 1, 0], x[1, 62, 3, 2] = 0, 255  # outliers the cutoff trims
    fn = make_autocontrast_row_split_fn(mesh, cutoff=2)
    got = np.asarray(fn(jnp.asarray(x)))
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], eq.autocontrast_oracle(x[b], cutoff=2)
        )


def test_autocontrast_cutoff_pipeline_field():
    pipe = plib.GlobalStatsPipeline("autocontrast", cutoff=2)
    rng = np.random.default_rng(47)
    x = rng.integers(0, 256, (32, 40, 3), np.uint8)
    rows = jnp.asarray(x.reshape(1, 32, 40 * 3))
    np.testing.assert_array_equal(
        np.asarray(pipe.apply_rows(rows, 3, use_pallas=True)).reshape(
            32, 40, 3
        ),
        eq.autocontrast_oracle(x, cutoff=2),
    )
    with pytest.raises(ValueError, match="autocontrast"):
        plib.GlobalStatsPipeline("equalize", cutoff=2)


def test_autocontrast_pipeline_and_registry():
    pipe = plib.get("autocontrast")
    assert pipe.has_kernel is False
    rng = np.random.default_rng(29)
    x = rng.integers(40, 200, (36, 44, 3), np.uint8)
    want = eq.autocontrast_oracle(x)
    rows = jnp.asarray(x.reshape(1, 36, 44 * 3))
    np.testing.assert_array_equal(
        np.asarray(pipe.apply_rows(rows, 3, use_pallas=True)).reshape(
            36, 44, 3
        ),
        want,
    )
    with pytest.raises(ValueError, match="make_autocontrast_row_split_fn"):
        pipe.radius


def test_autocontrast_row_split_pmin_pmax():
    """8-way H sharding (pmin/pmax collective) == single device."""
    from hipe_tpu.parallel.mesh import ROW_AXIS
    from hipe_tpu.parallel.row_split import make_autocontrast_row_split_fn
    from jax.sharding import Mesh

    devs = jax.devices("cpu")[:8]
    mesh = Mesh(np.array(devs), (ROW_AXIS,))
    rng = np.random.default_rng(31)
    # Place each channel's extrema inside DIFFERENT shards so local
    # extrema genuinely differ and the collective is load-bearing.
    x = rng.integers(60, 190, (2, 64, 48, 3), np.uint8)
    x[0, 3, 5, 0], x[0, 60, 7, 0] = 12, 240
    x[1, 35, 2, 2] = 255
    fn = make_autocontrast_row_split_fn(mesh)
    got = np.asarray(fn(jnp.asarray(x)))
    for b in range(2):
        np.testing.assert_array_equal(got[b], eq.autocontrast_oracle(x[b]))


def test_cli_approach2_rejects_equalize(capsys):
    """approach2 + equalize: one clean Error line, exit 1 (no traceback)."""
    import sys

    from hipe_tpu import cli

    argv, sys.argv = sys.argv, ["hipe_tpu", "approach2", "0.8", "25",
                                "--num-images", "50",
                                "--pipeline", "equalize"]
    try:
        rc = cli.main()
    finally:
        sys.argv = argv
    assert rc == 1
    err = capsys.readouterr().err
    assert "Error:" in err and "psum" in err


def test_fleet_image_level_runs_global_stats_pipelines():
    """Approach-1 fleets warm up and run radius-less pipelines (the halo
    computation is row-split-only; it used to be evaluated eagerly)."""
    from hipe_tpu.runtime.fleet import FleetEngine, LaneSpec
    from hipe_tpu.utils.images import checker_image

    img = checker_image(40, 32, 3, seed=2)
    devs = jax.devices("cpu")[:3]
    lanes = [LaneSpec(device=d, weight=1.0, name=f"cpu{i}")
             for i, d in enumerate(devs)]
    eng = FleetEngine(lanes, approach=1, batch_size=6, num_images=12,
                      pipeline="equalize")
    stats = eng.run(image=img)
    assert sum(c.images for c in stats.lanes) == 12
    np.testing.assert_array_equal(
        eng.first_output[0], eq.equalize_oracle(img)
    )


def test_device_stream_runner_equalize():
    """DeviceStreamRunner routes equalize; autotune times XLA alone."""
    from hipe_tpu.runtime.device_stream import DeviceStreamRunner

    img = np.random.default_rng(19).integers(0, 256, (32, 32, 3), np.uint8)
    r = DeviceStreamRunner("equalize", num_images=4, image=img,
                          use_pallas=True, tune_cache_path="/dev/null")
    assert r.verify_max_abs_err() == 0
    timings = r.autotune(passes=1, reps=1, cache=False)
    assert set(timings) == {"xla"}  # no kernel, so no kernel configs


@pytest.mark.parametrize("cutoff", [0, 2, (1, 3)])
def test_autocontrast_preserve_tone_matches_pil(cutoff):
    # PIL preserve_tone: ONE Pillow-luma-derived range applied to all
    # channels — per-image, like contrast. Oracle (literal walk on the
    # luma histogram) and JAX paths (eager and traced) vs PIL itself.
    from PIL import Image, ImageOps

    rng = np.random.default_rng(61)
    img = rng.integers(30, 220, (40, 48, 3)).astype(np.uint8)
    want = np.asarray(ImageOps.autocontrast(
        Image.fromarray(img), cutoff=cutoff, preserve_tone=True))
    np.testing.assert_array_equal(
        eq.autocontrast_oracle(img, cutoff, preserve_tone=True), want)
    fn = functools.partial(eq.autocontrast_nhwc, cutoff=cutoff,
                           preserve_tone=True)
    for f in (fn, jax.jit(fn)):
        got = np.asarray(f(jnp.asarray(img[None])))[0]
        np.testing.assert_array_equal(got, want)


def test_autocontrast_preserve_tone_pipeline_and_sharded():
    from hipe_tpu.models.pipelines import GlobalStatsPipeline
    from hipe_tpu.parallel import mesh as meshlib
    from hipe_tpu.parallel.row_split import make_autocontrast_row_split_fn

    rng = np.random.default_rng(67)
    batch = rng.integers(30, 220, (2, 64, 40, 3)).astype(np.uint8)
    for cutoff in (0, 2):
        want = np.stack([
            eq.autocontrast_oracle(b, cutoff, preserve_tone=True)
            for b in batch])
        pipe = GlobalStatsPipeline("autocontrast", cutoff=cutoff,
                                   preserve_tone=True)
        np.testing.assert_array_equal(
            np.asarray(pipe(jnp.asarray(batch))), want)
        # Sharded: pmin/pmax (cutoff 0) or psum (trim) over the LUMA.
        mesh = meshlib.make_mesh(8, axis=meshlib.ROW_AXIS)
        fn = make_autocontrast_row_split_fn(mesh, cutoff=cutoff,
                                            preserve_tone=True)
        np.testing.assert_array_equal(
            np.asarray(fn(jnp.asarray(batch))), want)
    with pytest.raises(ValueError, match="preserve_tone applies"):
        GlobalStatsPipeline("equalize", preserve_tone=True)
