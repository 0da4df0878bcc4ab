"""Pixel-band sharding of the port (arkoserenderer_torch/parallel/sharded.py)
on the CPU: gloo worlds of 1, 2, 4 and 8 ranks spawned by ``run_bands``,
each rank a process rendering its band.

The cases mirror tests/test_sharding.py at its size (128^2, tile 8x16, a
256^2 sun), plus the half-rate sky fetch over two bands (its upsample's
halo rows). Every case of one world size renders in one spawn, shared by
the tests through a module-scoped fixture, and each gathered frame is held
against the port's unsharded CPU ``Renderer`` (which the other
tests/test_torch_*.py files hold against JAX) within the reference's own
bound: the share of values off by more than 1e-5 below 1e-3. One band is
the Renderer bit for bit. Measured here: n = 2 equal bit for bit; n = 4 and
n = 8 differ in a few values by at most ~1.5e-6 (the (N, 4) x (4, 4)
matmuls of the world reconstruction take another path for another row
count).

Over several frames with TAA the band edges clamp TAA's history fetches, in
both packages (ROADMAP R10): the multi-frame case checks what the reference
checks (finite, a sane mean) and that the frame differs from the unsharded
one only on rows next to a seam.

The slice as a whole is held against JAX's ``ShardedRenderer`` once
(forward with Bloom and SSAO, n = 2, on the conftest's virtual mesh): the
two sharded frames within the goldens' bound, and the port's within the
reference's bound of its own unsharded frame. The reference's bound does
not hold across the packages: there 3 % of values differ by more than
1e-5 (up to 2.7e-4), from XLA:CPU's fused multiply-adds, sharded or not;
tests/test_sharding.py holds JAX's sharded frames to its unsharded ones.

The halo pieces (``blur3`` / ``upsample2x`` with ``halo_rows``,
``band_halo_rows``) and ``band_config`` are held against JAX's functions
without processes.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.assets.procedural import build_test_scene as t_build_test_scene
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.models.standard import Renderer as TRenderer
from arkoserenderer_torch.ops.image import band_halo_rows, blur3, upsample2x
from arkoserenderer_torch.parallel.sharded import BandJob, band_config, render_jobs, run_bands
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_torch.scene.lights import SpotLight
from arkoserenderer_torch.utils.imageio import to_u8
from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
from arkoserenderer_tpu.ops import image as j_image
from arkoserenderer_tpu.parallel.sharded import band_config as j_band_config
from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig

torch.set_num_threads(2)

W = H = 128
RASTER = dict(tile_h=8, tile_w=16, max_tris_per_tile=256)
CFG = TPipelineConfig(width=W, height=H, raster=TRasterConfig(**RASTER), shadow_map_size=256)
SCENE = functools.partial(t_build_test_scene, viewport=(W, H))
ONE_SPHERE = functools.partial(t_build_test_scene, viewport=(W, H), n_spheres=1)
# tests/test_sharding.py's lights: the spot of the atlas and icon case, and
# the casting spot of the RT cases (a source radius makes it soft).
ICON_SPOT = SpotLight(position=np.array([-2.0, 3.5, 0.0], np.float32),
                      direction=np.array([0.0, -1.0, 0.0], np.float32),
                      luminous_intensity_cd=60000.0, outer_cone_angle=np.radians(50.0),
                      inner_cone_angle=np.radians(35.0))
RT_SPOT = SpotLight(position=np.array([0.5, 3.0, 1.0], np.float32),
                    direction=np.array([-0.2, -1.0, -0.1], np.float32),
                    luminous_intensity_cd=150000.0, cast_shadows=True)
NO_POST = dict(taa=False, bloom=False)

# World size -> case -> the job every rank renders.
WORLDS = {
    1: {"forward_bloom": BandJob(SCENE, CFG)},
    2: {"forward_bloom": BandJob(SCENE, CFG),
        "forward_bloom_ssao": BandJob(SCENE, CFG, pipeline_kw=dict(ssao=True)),
        "sky_fetch_scale": BandJob(SCENE, dataclasses.replace(CFG, sky_fetch_scale=2),
                                   pipeline_kw=NO_POST)},
    4: {"spot_atlas_icons": BandJob(ONE_SPHERE, dataclasses.replace(CFG, local_shadow_map_size=64),
                                    pipeline_kw=dict(bloom=False, light_icons=True),
                                    spots=(ICON_SPOT,)),
        "ssao": BandJob(SCENE, CFG, pipeline_kw=dict(ssao=True, bloom=False)),
        "rt": BandJob(ONE_SPHERE, CFG, 2, dict(rt_shadows=True, rt_reflections=True, **NO_POST),
                      spots=(RT_SPOT,)),
        "ddgi": BandJob(ONE_SPHERE, CFG, 2, dict(ddgi=True, **NO_POST)),
        "soft_shadows": BandJob(ONE_SPHERE, CFG, 3, dict(rt_shadows=True, **NO_POST),
                                spots=(dataclasses.replace(RT_SPOT, source_radius=0.3),),
                                sun_angular_radius_deg=6.0)},
    8: {"forward_bloom": BandJob(SCENE, CFG),
        "multi_frame": BandJob(SCENE, CFG, 3, dict(bloom=False))},
}
MATCHED = [(n, case) for n, cases in WORLDS.items() if n > 1 for case in cases
           if case != "multi_frame"]


@pytest.fixture(scope="module")
def sharded():
    """(n, case) -> the gathered frame; one spawn of n ranks renders every
    case of world n."""
    frames = {}

    def get(n, case):
        if n not in frames:
            jobs = WORLDS[n]
            frames[n] = dict(zip(jobs, run_bands(render_jobs, n, "gloo", ["cpu"] * n,
                                                 list(jobs.values()))))
        return frames[n][case]

    return get


@pytest.fixture(scope="module")
def unsharded():
    """case -> the port's unsharded CPU frame of the case's job."""
    frames = {}

    def get(n, case):
        if case not in frames:
            job = WORLDS[n][case]
            scene, camera = job.scene()
            img = TRenderer(scene, camera, job.cfg, device="cpu", **job.pipeline_kw)
            frames[case] = img.render_frames(job.frames).numpy()
        return frames[case]

    return get


def off_share(a: np.ndarray, b: np.ndarray) -> tuple[float, int, float]:
    """(share of values off by more than 1e-5, values unequal, largest
    difference)."""
    diff = np.abs(a - b)
    return float((diff > 1e-5).mean()), int((diff > 0).sum()), float(diff.max())


def test_one_band_is_the_renderer_bit_for_bit(sharded, unsharded):
    np.testing.assert_array_equal(sharded(1, "forward_bloom"), unsharded(1, "forward_bloom"))


@pytest.mark.parametrize("n,case", MATCHED, ids=[f"n{n}-{c}" for n, c in MATCHED])
def test_bands_match_the_unsharded_renderer(sharded, unsharded, n, case):
    ours, ref = sharded(n, case), unsharded(n, case)
    assert ours.shape == (H, W, 3) and np.isfinite(ours).all()
    share, unequal, largest = off_share(ours, ref)
    assert share < 1e-3, (f"n={n} {case}: {share:.4%} of values off by > 1e-5 ({unequal} "
                          f"unequal, largest {largest:.3e})")


def test_low_rate_sky_bands_match_the_unsharded_frame(sharded, unsharded):
    """SkyView at sky_fetch_scale=2 over two bands: each band upsamples its
    half-rate sky with the other band's boundary row as its halo, so the
    gathered frame is the unsharded one within 1e-5, seam rows included."""
    ours, ref = sharded(2, "sky_fetch_scale"), unsharded(2, "sky_fetch_scale")
    assert ours.shape == (H, W, 3) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


class ThreadBands:
    """The band group of ``rank`` among ranks run as threads of this
    process: all_gather hands every rank the others' tensors."""

    def __init__(self, rank: int, size: int, slots: list, barrier):
        self.rank, self.size, self.slots, self.barrier = rank, size, slots, barrier

    def all_gather(self, x):
        self.slots[self.rank] = x
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts


def test_low_rate_sky_pass_bands_are_seam_exact():
    """SkyView at sky_fetch_scale=2 on a frame no geometry covers, for two
    bands run as threads and for the whole frame: the stacked bands equal
    the frame bit for bit (the rows at the seam upsample across it, through
    the halo; edge-clamped at the band's edge they would not)."""
    import threading

    from arkoserenderer_torch.rendering.passes.sky import SkyPass
    from arkoserenderer_torch.rendering.pipeline import FrameContext
    from arkoserenderer_torch.rendering.registry import Registry

    scene, cam = SCENE()
    arrays, cs = scene.build("cpu"), cam.state(0, "cpu")
    cfg = dataclasses.replace(CFG, sky_fetch_scale=2)

    def run(band_cfg, band=None):
        reg = Registry()
        for name, shape, dtype in (("SceneColor", (3,), torch.float32),
                                   ("SceneCoverage", (), torch.bool),
                                   ("SceneVelocity", (2,), torch.float32)):
            reg.create(name, (band_cfg.height, W) + shape, dtype)
        execute = SkyPass().construct(band_cfg, reg, torch.device("cpu"))
        state = {"SceneColor": torch.zeros(band_cfg.height, W, 3),
                 "SceneCoverage": torch.zeros(band_cfg.height, W, dtype=torch.bool),
                 "SceneVelocity": torch.zeros(band_cfg.height, W, 2)}
        rank = 0 if band is None else band.rank
        return execute(state, FrameContext(arrays, cs, 0, 1 / 60, rank * band_cfg.height, band))

    whole = run(cfg)
    slots, barrier, bands = [None, None], threading.Barrier(2, timeout=60), [None, None]

    def rank_run(rank):
        bands[rank] = run(band_config(cfg, 2), ThreadBands(rank, 2, slots, barrier))

    threads = [threading.Thread(target=rank_run, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and all(b is not None for b in bands)
    for key in ("SceneColor", "SceneVelocity"):
        stacked = torch.cat([bands[0][key], bands[1][key]])
        np.testing.assert_array_equal(stacked.numpy(), whole[key].numpy(), err_msg=key)
    seam = whole["SceneColor"][H // 2 - 1:H // 2 + 1]
    assert float(seam.std()) > 0.0 and not torch.equal(seam[0], seam[1])


def test_multi_frame_bands_differ_only_at_seams(sharded, unsharded):
    """Three TAA frames over 8 bands: finite with a sane mean, as the
    reference checks; where they differ from the unsharded frames, it is
    on rows within 4 of a seam (TAA's history taps clamp at the band's
    edge, R10)."""
    ours, ref = sharded(8, "multi_frame"), unsharded(8, "multi_frame")
    assert np.isfinite(ours).all() and 0.05 < ours.mean() < 0.95
    rows = np.nonzero((np.abs(ours - ref) > 1e-5).any(axis=(1, 2)))[0]
    seam_dist = np.abs((rows + 0.5) % (H // 8) - (H // 8) / 2)
    assert np.all(seam_dist >= H // 8 / 2 - 4), f"rows off the seams differ: {rows}"


def test_slice_against_jax_sharded_renderer(sharded, unsharded):
    from arkoserenderer_tpu.assets.procedural import build_test_scene
    from arkoserenderer_tpu.parallel.sharded import ShardedRenderer

    cfg = JPipelineConfig(width=W, height=H, raster=JRasterConfig(**RASTER),
                          shadow_map_size=256)
    scene, cam = build_test_scene(viewport=(W, H))
    jax_bands = np.array(ShardedRenderer(scene, cam, cfg, n_devices=2, ssao=True).render_frame())
    ours = sharded(2, "forward_bloom_ssao")
    assert off_share(ours, unsharded(2, "forward_bloom_ssao"))[0] < 1e-3
    diff = np.abs(to_u8(ours).astype(int) - to_u8(jax_bands).astype(int))
    assert diff.mean() < 1.5, f"mean abs diff {diff.mean():.3f}"
    assert (diff > 24).mean() < 0.005, f"{(diff > 24).mean():.2%} pixels changed"


# -- the halo pieces and band_config, without processes ----------------------------

class FakeBands:
    """The band group of ``rank`` among bands cut from one image: its
    all_gather returns each band's copy of what it is given."""

    def __init__(self, image: np.ndarray, rank: int, size: int):
        self.bands = np.split(image, size)
        self.rank, self.size = rank, size

    def all_gather(self, x):
        rows = [torch.from_numpy(np.concatenate([b[:1], b[-1:]])) for b in self.bands]
        assert rows[self.rank].shape == x.shape and torch.equal(rows[self.rank], x)
        return rows


def halos(rng, shape):
    h, w, c = shape
    return (rng.standard_normal((h, w, c)).astype(np.float32),
            rng.standard_normal((1, w, c)).astype(np.float32),
            rng.standard_normal((1, w, c)).astype(np.float32))


@pytest.mark.parametrize("shape", [(8, 16, 3), (1, 5, 1), (6, 4, 2)])
def test_blur3_with_halo_rows_matches_jax(shape):
    img, top, bottom = halos(np.random.default_rng(11), shape)
    ours = blur3(torch.from_numpy(img), (torch.from_numpy(top), torch.from_numpy(bottom)))
    ref = j_image.blur3(jnp.asarray(img), halo_rows=(jnp.asarray(top), jnp.asarray(bottom)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(4, 8, 3), (1, 3, 1), (5, 2, 2)])
def test_upsample2x_with_halo_rows_matches_jax(shape):
    img, top, bottom = halos(np.random.default_rng(12), shape)
    ours = upsample2x(torch.from_numpy(img), (torch.from_numpy(top), torch.from_numpy(bottom)))
    ref = j_image.upsample2x(jnp.asarray(img),
                             halo_rows=(jnp.asarray(top), jnp.asarray(bottom)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_band_halo_rows_make_banded_stencils_seam_exact():
    """Four bands of one image: each band's halo is its neighbours' edge rows
    (its own at the frame's edge), and the banded blur3 and upsample2x
    stacked are JAX's whole-image ones bit for bit."""
    img = np.random.default_rng(13).standard_normal((16, 12, 3)).astype(np.float32)
    blurred, upsampled = [], []
    for rank in range(4):
        group = FakeBands(img, rank, 4)
        band = torch.from_numpy(group.bands[rank])
        top, bottom = band_halo_rows(band, group)
        np.testing.assert_array_equal(top.numpy(), img[max(rank * 4 - 1, 0)][None])
        np.testing.assert_array_equal(bottom.numpy(), img[min(rank * 4 + 4, 15)][None])
        blurred.append(blur3(band, (top, bottom)).numpy())
        upsampled.append(upsample2x(band, (top, bottom)).numpy())
    np.testing.assert_array_equal(np.concatenate(blurred), np.asarray(j_image.blur3(img)))
    np.testing.assert_array_equal(np.concatenate(upsampled),
                                  np.asarray(j_image.upsample2x(jnp.asarray(img))))


# (height, tile_h, sun size, bands): the 1080p rejections at tile 8 (135 tiles
# of 8 rows split into no even bands), and the two 1080p/1024p splits the
# card runs.
BAND_SHAPES = [(1080, 8, 8192, 2), (1080, 8, 8192, 4), (1080, 8, 8192, 3),
               (1080, 4, 8192, 2), (1024, 8, 8192, 4), (128, 8, 256, 8), (128, 8, 256, 3)]


@pytest.mark.parametrize("height,tile_h,sun,n", BAND_SHAPES,
                         ids=[f"{h}-tile{t}-sun{s}-n{n}" for h, t, s, n in BAND_SHAPES])
def test_band_config_matches_jax(height, tile_h, sun, n):
    kw = dict(width=1920, height=height, shadow_map_size=sun)
    ours = TPipelineConfig(raster=TRasterConfig(tile_h=tile_h, tile_w=128), **kw)
    ref = JPipelineConfig(raster=JRasterConfig(tile_h=tile_h, tile_w=128), **kw)
    try:
        want = j_band_config(ref, n)
    except AssertionError:
        with pytest.raises(AssertionError):
            band_config(ours, n)
        return
    got = band_config(ours, n)
    fields = ("height", "full_height", "frame_height", "shard_axis", "shard_count", "width")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
