"""The port's flat BVH, binary two-level walk, chunked traces and no-BVH
placeholder (arkoserenderer_torch/ops/bvh.py, scene/scene.py) against the
JAX package's.

Tolerances:
  * ``build_bvh`` and the flat refit: every array equal, ints exactly and
    floats bit for bit (both run the same numpy build; the refit is
    min/max/subtract, exact in both);
  * the flat and the binary two-level walks: test_torch_bvh.py's — ``hit``
    and ``tri`` equal, ``t`` to rtol/atol 1e-5, ``u`` and ``v`` to atol
    1e-4 (XLA:CPU fuses the Moller-Trumbore multiply-adds, eager torch
    rounds each operation);
  * against brute force (``trace_rays_brute``): tests/test_bvh.py's bounds;
  * a chunked trace against the same walk unchunked: equal (each ray's
    walk is independent of the others);
  * the refit of a two-level BVH without wide records: test_torch_refit.py's
    — BLAS node bounds equal, the TLAS rows (instance boxes through the
    rotation, whose 3-term products the backends may round apart) and the
    children bounds read from them within 4 ulps;
  * ``bake_vertex_ao`` over a flat BVH: tests/test_torch_bake_ao.py's 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.ops import bvh as tb
from arkoserenderer_tpu.ops import bvh as jb
from test_bvh import _two_level_fixture, _world_pool, random_rays, scene_soup
from test_torch_bvh import instanced_inputs

torch.set_num_threads(2)

N_RAYS = 384
CHUNK_RAYS = 160  # the chunked traces: two full chunks of 64 and a partial one
ULPS = 4


def _ulps(a, b) -> int:
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max()) if ai.size else 0


@functools.partial(jax.jit, static_argnames=("any_hit", "max_steps"))
def j_trace(bvh, o, d, t_max, any_hit, max_steps):
    """JAX's trace_rays, jitted with the BVH as an argument."""
    return jb.trace_rays(bvh, o, d, t_max=t_max, any_hit=any_hit, max_steps=max_steps)


def to_port(jax_bvh):
    """A JAX BVH carried across as the port's, through the bridge's keys."""
    return tb.bvh_from_host(bridge.numpy_fields(jax_bvh), "cpu")


def assert_fields_equal(ours, ref):
    for f in tb.FlatBVH._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(ours, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f)


def assert_hits_close(ours, ref):
    np.testing.assert_array_equal(ours.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(ours.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.u.numpy(), np.asarray(ref.u), atol=1e-4)
    np.testing.assert_allclose(ours.v.numpy(), np.asarray(ref.v), atol=1e-4)


@pytest.fixture(scope="module")
def both():
    """The flat BVH of a 300-triangle soup (a tenth of its triangles
    invalid) and the binary two-level BVH of test_bvh.py's instanced
    fixture (wide records dropped), each in both packages, with seeded rays
    and per-ray t_max."""
    rng = np.random.default_rng(1234)
    verts, tris = scene_soup(rng)
    valid = np.ones(len(tris), bool)
    valid[::10] = False
    two, geos, inst_blas, o2w, pool_tris = _two_level_fixture(np.random.default_rng(7))
    binary = dataclasses.replace(two, **{f: None for f in (
        "wide_meta", "wide_src", "wide_cbounds", "wide_root_blas", "wide_rec", "quad_rec",
        "inst_rec")})
    o, d = random_rays(rng, N_RAYS)
    return {
        "soup": (verts, tris, valid),
        "flat": (jb.build_bvh(verts, tris, valid), tb.build_bvh(verts, tris, valid, "cpu")),
        "binary": (binary, to_port(binary)),
        "binary_pool": (_world_pool(geos, inst_blas, o2w), pool_tris),
        "rays": (o, d, rng.uniform(0.5, 12.0, N_RAYS).astype(np.float32)),
    }


def test_build_bvh_and_flat_refit_match_jax(both):
    verts, tris, valid = both["soup"]
    ref, ours = both["flat"]
    assert isinstance(ours, tb.FlatBVH)
    assert_fields_equal(ours, ref)
    moved = verts + np.random.default_rng(3).normal(size=verts.shape).astype(np.float32) * 0.3
    ref2 = jax.jit(jb.refit_bvh)(ref, jnp.asarray(moved), jnp.asarray(tris))
    ours2 = tb.refit_bvh(ours, torch.from_numpy(moved), torch.from_numpy(tris))
    assert_fields_equal(ours2, ref2)
    assert not np.array_equal(ours2.node_min.numpy(), ours.node_min.numpy())
    # In place, as streaming refits: the tensors keep their storage.
    kept = ours._replace(**{f: getattr(ours, f).clone() for f in tb.FlatBVH._fields})
    ptr = kept.tri_v0.data_ptr()
    tb.refit_bvh_in_place(kept, torch.from_numpy(moved), torch.from_numpy(tris))
    assert kept.tri_v0.data_ptr() == ptr
    assert_fields_equal(kept, ref2)
    # The two-level BVH without wide records refits without them, as JAX's.
    jbin, pbin = both["binary"]
    pool, pool_tris = both["binary_pool"]
    ref3 = jax.jit(jb.refit_bvh)(jbin, jnp.asarray(pool), jnp.asarray(pool_tris))
    again = tb.refit_bvh(pbin, torch.from_numpy(pool), torch.from_numpy(pool_tris))
    assert again.wide_rec is None and again.wide_cbounds is None
    nt = again.n_tlas
    for f in ("node_int", "tri_quad"):
        np.testing.assert_array_equal(getattr(again, f).numpy(), np.asarray(getattr(ref3, f)))
    for f in ("node_min", "node_max"):
        ours_f, ref_f = getattr(again, f).numpy(), np.asarray(getattr(ref3, f))
        np.testing.assert_array_equal(ours_f[nt:], ref_f[nt:], err_msg=f)
        assert _ulps(ours_f[:nt], ref_f[:nt]) <= ULPS, f
    assert _ulps(again.node_cbounds.numpy(), np.asarray(ref3.node_cbounds)) <= ULPS


# (walk, any_hit, per-ray t_max, max_steps)
WALKS = [("flat", False, False, 512), ("flat", True, True, 512), ("flat", False, True, 7),
         ("binary", False, False, 512), ("binary", True, True, 512),
         ("binary", False, True, 9)]


@pytest.mark.parametrize("walk,any_hit,per_ray,max_steps", WALKS)
def test_walk_matches_jax(both, walk, any_hit, per_ray, max_steps):
    jbvh, pbvh = both[walk]
    o, d, tm = both["rays"]
    t_max = tm if per_ray else np.float32(1e30)
    ref = j_trace(jbvh, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), any_hit=any_hit,
                  max_steps=max_steps)
    ours = tb.trace_rays(pbvh, torch.from_numpy(o), torch.from_numpy(d),
                         t_max=torch.from_numpy(np.asarray(t_max)), any_hit=any_hit,
                         max_steps=max_steps)
    assert_hits_close(ours, ref)
    assert ours.hit.any() and not ours.hit.all()
    if max_steps < 512:  # the cut leaves rays short of hits the full walk finds
        full = tb.trace_rays(pbvh, torch.from_numpy(o), torch.from_numpy(d),
                             t_max=torch.from_numpy(np.asarray(t_max)), any_hit=any_hit)
        assert (full.hit & ~ours.hit).any()


def test_flat_walk_matches_brute_force(both):
    """tests/test_bvh.py's oracle and bounds, closest and any hit."""
    verts, tris, valid = both["soup"]
    o, d, _ = both["rays"]
    _, pbvh = both["flat"]
    hit = tb.trace_rays(pbvh, torch.from_numpy(o), torch.from_numpy(d))
    ref_t, ref_tri = tb.trace_rays_brute(verts, tris, valid, o, d)
    j_t, j_tri = jb.trace_rays_brute(verts, tris, valid, o, d)
    np.testing.assert_array_equal(ref_tri, j_tri)
    np.testing.assert_array_equal(ref_t, j_t)
    got = hit.tri.numpy()
    np.testing.assert_array_equal(got >= 0, ref_tri >= 0)
    h = ref_tri >= 0
    assert h.sum() > 30
    np.testing.assert_allclose(hit.t.numpy()[h], ref_t[h], rtol=1e-4, atol=1e-4)
    assert (got[h] == ref_tri[h]).mean() > 0.995
    any_hit = tb.trace_rays(pbvh, torch.from_numpy(o), torch.from_numpy(d), any_hit=True)
    np.testing.assert_array_equal(any_hit.hit.numpy(), hit.hit.numpy())


@pytest.mark.parametrize("walk", ["flat", "binary", "wide"])
def test_chunked_trace_per_ray_t_max(both, walk):
    """tests/test_bvh.py's chunk_size case on each walk: a per-ray t_max
    goes along with its chunk, closest and any hit, and a broadcastable
    (1,) t_max acts as the scalar."""
    if walk == "wide":
        bvh = tb.build_two_level(*instanced_inputs(np.random.default_rng(9), 64, True),
                                 device="cpu")
    else:
        bvh = both[walk][1]
    o, d, tm = (torch.from_numpy(x[:CHUNK_RAYS]) for x in both["rays"])
    for any_hit in (False, True):
        whole = tb.trace_rays(bvh, o, d, t_max=tm, any_hit=any_hit)
        chunked = tb.trace_rays(bvh, o, d, t_max=tm, any_hit=any_hit, chunk_size=64)
        for x, y in zip(chunked, whole):
            assert torch.equal(x, y)
    one = tb.trace_rays(bvh, o, d, t_max=torch.tensor([7.5]), chunk_size=64)
    scalar = tb.trace_rays(bvh, o, d, t_max=7.5)
    assert torch.equal(one.tri, scalar.tri) and torch.equal(one.t, scalar.t)
    assert scalar.hit.any()


def test_no_bvh_scene_misses_as_the_reference():
    """A scene built without a BVH: the port's placeholder traces as JAX's
    ``_dummy_bvh()`` does (every ray a miss), through trace_rays and the
    RT shadow helper; its arrays carry the placeholder field for field."""
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_tpu.assets.procedural as jproc
    from arkoserenderer_torch.ops.rt import trace_shadow_mask
    from arkoserenderer_torch.scene.scene import _dummy_bvh
    from arkoserenderer_tpu.scene.scene import _dummy_bvh as j_dummy

    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    o[0] = [-1.0, 0.0, 0.0]  # through the placeholder's box at the origin
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d[0] = [1.0, 0.0, 0.0]
    ts, _ = tproc.build_test_scene(viewport=(32, 32))
    arrays = ts.build("cpu")
    assert_fields_equal(arrays.bvh, j_dummy())
    for any_hit in (False, True):
        ref = j_trace(j_dummy(), jnp.asarray(o), jnp.asarray(d), jnp.float32(1e4),
                      any_hit=any_hit, max_steps=512)
        ours = tb.trace_rays(_dummy_bvh("cpu"), torch.from_numpy(o), torch.from_numpy(d),
                             t_max=1e4, any_hit=any_hit)
        assert_hits_close(ours, ref)
        assert not ours.hit.any() and (ours.t == 1e4).all() and (ours.tri == -1).all()
    lit = trace_shadow_mask(arrays, torch.from_numpy(o), torch.from_numpy(d[0]),
                            torch.ones(256, dtype=torch.bool))
    assert (lit == 1.0).all()
    # A JAX scene without a BVH carries across with the same placeholder.
    js, _ = jproc.build_test_scene(viewport=(32, 32))
    assert_fields_equal(bridge.scene_arrays_from_numpy(js.build()._asdict(), "cpu").bvh,
                        j_dummy())


def test_bake_vertex_ao_over_a_flat_bvh_matches_jax():
    """bake_vertex_ao with the scene's BVH replaced by the flat BVH of its
    world-space triangles, as the reference's signature takes it: the test
    scene cut to 2,048 vertices, 2 rays a hemisphere."""
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_tpu.assets.procedural as jproc
    from arkoserenderer_torch.core.types import SceneLimits as TLimits
    from arkoserenderer_torch.models.pathtracer import world_space_vertices
    from arkoserenderer_torch.ops.bake_ao import bake_vertex_ao as t_bake
    from arkoserenderer_tpu.core.types import SceneLimits as JLimits
    from arkoserenderer_tpu.ops.bake_ao import bake_vertex_ao as j_bake

    lim = dict(max_vertices=1 << 11, max_indices=3 << 11, max_drawables=64, max_materials=32,
               max_textures=32, texture_pool_texels=1 << 19)
    js, _ = jproc.build_test_scene(limits=JLimits(**lim), viewport=(32, 32), n_spheres=1)
    ts, _ = tproc.build_test_scene(limits=TLimits(**lim), viewport=(32, 32), n_spheres=1)
    ja = js.build()
    ta = ts.build("cpu")
    wv = world_space_vertices(ta).astype(np.float32)
    idx, valid = ta.indices.numpy(), ta.tri_valid.numpy()
    jao, jbent = j_bake(ja._replace(bvh=jb.build_bvh(wv, idx, valid)), num_rays=2)
    tao, tbent = t_bake(ta._replace(bvh=tb.build_bvh(wv, idx, valid, "cpu")), num_rays=2)
    np.testing.assert_allclose(tao, jao, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tbent, jbent, atol=1e-5, rtol=0)
    assert 0.05 < (tao < 0.999).mean() < 0.95
