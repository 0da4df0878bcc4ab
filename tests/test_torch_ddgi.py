"""The port's DDGI against the JAX package's, module by module.

  * the ray-rotation normals (``core/prng``) for frames 0-63 against
    ``jax.random``: keys and uniforms bit for bit; the normals within
    NORMAL_ULPS ulps, because XLA's float32 erf_inv on the CPU evaluates
    log1p by its own approximation (the port rounds log1p once from
    float64 and each multiply-add once, as an FMA does; 4 of the 256
    values differ, by 2 ulps at most);
  * ``quat_rotate``, the octahedral encode and decode, ``_oct_wrap`` and
    ``_bilinear_atlas`` on seeded inputs: 1e-6 (unit vectors, texel
    coordinates) and 2e-6 (an atlas of values in [0, 2]);
  * ``ProbeGridConfig.fit_bounds``, ``probe_positions`` and ``init_state``:
    equal;
  * ``update_probes`` over three frames, each side's plain walk through
    the same BVH, each frame fed the JAX state of the frame before, on the
    rt scene (a 4x3x4 grid, 32 probes a frame: frame 0 starts cold, frames
    1 and 2 revisit warm probes and sample last frame's bounce) and on a
    closed box whose probe must move out: a probe ray's hit can flip on an
    ulp of its direction (the rotation differs by ulps, and XLA:CPU fuses
    multiply-adds), which moves a texel estimate, so the atlases are held
    like ShadowMask.*: irradiance to ATLAS_ATOL and visibility (distances
    and their squares, up to ~500) to ATLAS_RTOL of its magnitude, on all
    but FLIP_SHARE of the values (none differ that far in these runs);
    offsets to 1e-6;
  * ``sample_irradiance`` at seeded points and normals on that state: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.core import mathx as tmx
from arkoserenderer_torch.core import prng
from arkoserenderer_torch.ops import ddgi as tdd
from arkoserenderer_tpu.core import mathx as jmx
from arkoserenderer_tpu.ops import ddgi as jdd
from test_torch_bvh import rt_scene

torch.set_num_threads(2)

NORMAL_ULPS = 2
ATLAS_ATOL = 1e-5
ATLAS_RTOL = 1e-5
FLIP_SHARE = 0.005


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_rotation_normals_match_jax_random():
    key = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(prng.prng_key(7), np.asarray(jax.random.key_data(key)))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    worst = 0
    for frame in range(64):
        fk = jax.random.fold_in(key, frame)
        ours_key = prng.fold_in(prng.prng_key(7), frame)
        np.testing.assert_array_equal(ours_key, np.asarray(jax.random.key_data(fk)))
        np.testing.assert_array_equal(prng.random_bits(ours_key, 4),
                                      np.asarray(jax.random.bits(fk, (4,), jnp.uint32)))
        ref = np.asarray(jax.random.normal(fk, (4,)))
        ours = prng.ddgi_rotation_normals(frame)
        assert ours.dtype == np.float32 and ours.shape == (4,)
        worst = max(worst, int(_ulps(ours, ref).max()))
    assert worst <= NORMAL_ULPS, worst
    # The uniforms under the normals are JAX's bit for bit.
    for frame in (0, 5, 63):
        fk = jax.random.fold_in(key, frame)
        bits = prng.random_bits(prng.fold_in(prng.prng_key(7), frame), 4)
        one = np.array(1.0, np.float32).view(np.uint32)
        floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
        ours_u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
        np.testing.assert_array_equal(
            ours_u, np.asarray(jax.random.uniform(fk, (4,), minval=lo, maxval=1.0)))


def test_quat_rotate_and_octahedral_mapping_match_jax():
    rng = np.random.default_rng(21)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(tmx.quat_rotate(torch.from_numpy(q), torch.from_numpy(v)).numpy(),
                               np.asarray(jmx.quat_rotate(jnp.asarray(q), jnp.asarray(v))),
                               atol=1e-6, rtol=0)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:8] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
             [0.6, -0.8, 0], [0, 0.6, -0.8]]
    uv_t = tdd.octahedral_encode(torch.from_numpy(d))
    uv_j = jdd.octahedral_encode(jnp.asarray(d))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tdd.octahedral_decode(uv_t).numpy(),
                               np.asarray(jdd.octahedral_decode(uv_j)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tdd.octahedral_decode(uv_t).numpy(), d, atol=1e-5, rtol=0)
    for res in (tdd.IRRADIANCE_RES, tdd.VISIBILITY_RES):
        np.testing.assert_array_equal(tdd._texel_dirs(res), jdd._texel_dirs(res))


@pytest.mark.parametrize("res", [8, 16])
def test_oct_wrap_and_bilinear_atlas_match_jax(res):
    rng = np.random.default_rng(res)
    xi = rng.integers(-1, res + 1, 4096).astype(np.int32)
    yi = rng.integers(-1, res + 1, 4096).astype(np.int32)
    xt, yt = tdd._oct_wrap(torch.from_numpy(xi).long(), torch.from_numpy(yi).long(), res)
    xj, yj = jdd._oct_wrap(jnp.asarray(xi), jnp.asarray(yi), res)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert ((xt >= 0) & (xt < res) & (yt >= 0) & (yt < res)).all()

    c = 3 if res == 8 else 2
    atlas = rng.uniform(0.0, 2.0, (6, res, res, c)).astype(np.float32)
    probe = rng.integers(0, 6, 4096).astype(np.int32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    uv = np.array(jdd.octahedral_encode(jnp.asarray(d)))
    ours = tdd._bilinear_atlas(torch.from_numpy(atlas), torch.from_numpy(probe),
                               torch.from_numpy(uv)).numpy()
    ref = np.asarray(jdd._bilinear_atlas(jnp.asarray(atlas), jnp.asarray(probe), jnp.asarray(uv)))
    np.testing.assert_allclose(ours, ref, atol=2e-6, rtol=0)
    # A NaN uv (a lane whose result is discarded) fetches inside the atlas.
    nan_uv = torch.full((4, 2), float("nan"))
    assert tdd._bilinear_atlas(torch.from_numpy(atlas), torch.zeros(4, dtype=torch.int32),
                               nan_uv).shape == (4, c)


def test_grid_fit_positions_and_init_state_match_jax():
    for center, radius, kw in (((1.0, 2.0, 3.0), 5.0, {}),
                               ((0.1, -0.4, 0.0), 31.7, dict(dims=(16, 8, 16), rays_per_probe=256,
                                                             probes_per_frame=1024))):
        jg = jdd.ProbeGridConfig.fit_bounds(np.array(center), radius, **kw)
        tg = tdd.ProbeGridConfig.fit_bounds(np.array(center), radius, **kw)
        assert tg == bridge.probe_grid_from(jg)
        assert tg.num_probes == jg.num_probes
        np.testing.assert_array_equal(tdd.probe_positions(tg), jdd.probe_positions(jg))
    tg, jg = tdd.ProbeGridConfig(), jdd.ProbeGridConfig()
    assert tg == bridge.probe_grid_from(jg)
    for ours, ref in zip(tdd.init_state(tg, "cpu"), jdd.init_state(jg)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _box_scene(mod_procedural, mod_scene, mod_types):
    """A closed 2 m box (test_ddgi_oct.py's relocation scene)."""
    scene = mod_scene.Scene(limits=mod_types.SceneLimits(
        max_vertices=256, max_indices=256, max_drawables=4, max_materials=4,
        max_textures=8, texture_pool_texels=1 << 12))
    seg = mod_procedural.make_box((2.0, 2.0, 2.0))
    seg.material = scene.add_material(mod_scene.Material())
    scene.add_instance(scene.add_segment(seg), np.eye(4, dtype=np.float32))
    return scene


CASES = {
    # (scene, grid keywords, frames)
    "rt scene": ("rt", dict(dims=(4, 3, 4), rays_per_probe=96, probes_per_frame=32), 3),
    "box": ("box", None, 4),
}


def _case_scenes(kind):
    import arkoserenderer_tpu.assets.procedural as jproc
    import arkoserenderer_tpu.core.types as jtypes
    import arkoserenderer_tpu.scene.lights as jlights
    import arkoserenderer_tpu.scene.scene as jscene_mod

    if kind == "rt":
        js, jc = rt_scene(jproc, jlights)
        return js, float(jc.state(0).exposure)
    return _box_scene(jproc, jscene_mod, jtypes), 1.0


def _assert_atlas_close(key, ours, ref):
    diff = np.abs(ours - ref)
    bound = ATLAS_ATOL if key == "irradiance" else ATLAS_RTOL * np.maximum(np.abs(ref), 1.0)
    assert (diff > bound).mean() <= FLIP_SHARE, (key, float((diff > bound).mean()))


@pytest.fixture(scope="module", params=sorted(CASES))
def update_walk(request):
    """Both updates over the case's frames, each fed JAX's state:
    [(torch DDGIState, JAX DDGIState)], the grid and the final state."""
    kind, grid_kw, frames = CASES[request.param]
    js, exposure = _case_scenes(kind)
    jsa = js.build(with_bvh=True)
    tsa = bridge.scene_arrays_from_numpy(jsa._asdict(), "cpu")
    if grid_kw is None:
        jg = jdd.ProbeGridConfig(dims=(1, 1, 1), origin=(0.3, 0.2, 0.1), spacing=(2.0, 2.0, 2.0),
                                 rays_per_probe=64, probes_per_frame=1)
    else:
        center, radius = js.bounding_sphere()
        jg = jdd.ProbeGridConfig.fit_bounds(center, radius, **grid_kw)
    tg = bridge.probe_grid_from(jg)
    st = js.static_info()
    kw = dict(n_spots=st.n_spots, n_points=st.n_points, spot_casters=st.spot_shadow_casters,
              point_casters=st.point_shadow_casters)
    step = jax.jit(lambda s, i: jdd.update_probes(jsa, s, jg, i, np.float32(exposure), **kw))
    state = jdd.init_state(jg)
    out = []
    for frame in range(frames):
        ours = tdd.update_probes(tsa, bridge.ddgi_state_from_numpy(state, "cpu"), tg, frame,
                                 torch.tensor(exposure, dtype=torch.float32), **kw)
        state = step(state, jnp.asarray(frame, jnp.int32))
        out.append((ours, state))
    return request.param, out, jg, tg


def test_update_probes_matches_jax(update_walk):
    kind, out, _, _ = update_walk
    for ours, ref in out:
        for key in ("irradiance", "visibility"):
            _assert_atlas_close(key, getattr(ours, key).numpy(), np.asarray(getattr(ref, key)))
        np.testing.assert_allclose(ours.offsets.numpy(), np.asarray(ref.offsets), atol=1e-6,
                                   rtol=0)
    last = out[-1][1]
    assert np.isfinite(np.asarray(last.irradiance)).all()
    if kind == "box":
        # The probe inside the box moved toward a wall, within the clamp.
        off = np.asarray(last.offsets[0])
        assert np.abs(off).max() > 0.1 and (np.abs(off) <= 0.45 * 2.0 + 1e-5).all()
    else:
        # Warm probes were revisited: frame 1 blends into frame 0's texels.
        assert float(np.asarray(last.irradiance).max()) > 0.0
        assert (np.asarray(out[1][1].irradiance) != np.asarray(out[0][1].irradiance)).any()


def test_sample_irradiance_matches_jax(update_walk):
    _, out, jg, tg = update_walk
    state = out[-1][1]
    rng = np.random.default_rng(3)
    lo, hi = np.array(jg.origin), np.array(jg.origin) + np.array(jg.spacing) * (
        np.array(jg.dims) - 1)
    pts = rng.uniform(lo - 0.5, hi + 0.5, (4096, 3)).astype(np.float32)
    nrm = rng.normal(size=(4096, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    ref = np.asarray(jdd.sample_irradiance(state, jg, jnp.asarray(pts), jnp.asarray(nrm)))
    ours = tdd.sample_irradiance(bridge.ddgi_state_from_numpy(state, "cpu"), tg,
                                 torch.from_numpy(pts), torch.from_numpy(nrm)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    # Non-finite points and normals (sky pixels, missed rays) fetch in range.
    bad = torch.full((3, 3), float("nan"))
    assert tdd.sample_irradiance(bridge.ddgi_state_from_numpy(state, "cpu"), tg, bad,
                                 bad).shape == (3, 3)
