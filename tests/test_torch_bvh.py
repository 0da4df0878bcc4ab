"""The port's BVH (arkoserenderer_torch/ops/bvh.py) against the JAX package's:
the host build, and the plain torch 8-wide walk against ``_trace_wide``
and brute force.

Tolerances:
  * build: every array equal, ints exactly and floats bit for bit (both
    packages run the same numpy build and exact min/max/concat/bitcast
    derivations);
  * traversal: ``hit`` and ``tri`` equal; ``t`` to rtol 1e-5 (+ atol 1e-5)
    and ``u``, ``v`` to atol 1e-4. Not bit for bit, because XLA:CPU
    contracts the multiply-adds of the slab, transform and Moller-Trumbore
    arithmetic into fused multiply-adds (a jitted a * b + c over random
    float32 inputs equals the fused value on every element and the
    two-rounding value on 77 %), while eager torch rounds each operation as
    the CUDA kernel
    does; u and v are quotients by the determinant, so a grazing hit
    amplifies an ulp of it;
  * against brute force (``trace_rays_brute``, the reference's oracle):
    the reference test's own bounds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.ops import bvh as tb
from arkoserenderer_tpu.ops import bvh as jb
from test_bvh import _two_level_fixture, _world_pool, random_rays

torch.set_num_threads(2)


def assert_build_equal(ours: dict, ref):
    for f in dataclasses.fields(jb.TwoLevelBVH):
        a, b = np.asarray(getattr(ref, f.name)), np.asarray(ours[f.name])
        assert a.dtype == b.dtype and a.shape == b.shape, (f.name, a.dtype, b.dtype)
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f.name)


def instanced_inputs(rng, n_inst: int, grid: bool):
    """Two random meshes instanced ``n_inst`` times: random rigid + scale
    transforms, or rotated on a jittered grid (the deep-TLAS case)."""
    def soup(n, spread, size):
        c = rng.uniform(-spread, spread, (n, 3))
        v = (c[:, None] + rng.normal(size=(n, 3, 3)) * size).reshape(-1, 3).astype(np.float32)
        return v, np.arange(len(v), dtype=np.int32).reshape(-1, 3)

    geos = [soup(40, 0.4, 0.15), soup(25, 0.4, 0.15)]
    inst_blas = rng.integers(0, 2, n_inst).astype(np.int32)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n_inst, 1, 1))
    ang = rng.uniform(0, 2 * np.pi, n_inst)
    o2w[:, 0, 0], o2w[:, 0, 2] = np.cos(ang), np.sin(ang)
    o2w[:, 2, 0], o2w[:, 2, 2] = -np.sin(ang), np.cos(ang)
    if grid:
        side = int(round(n_inst ** (1 / 3)))
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
        o2w[:, :3, 3] = g[:n_inst] - (side - 1) / 2 + rng.uniform(-0.2, 0.2, (n_inst, 3))
    else:
        o2w[:, :3, :3] *= rng.uniform(0.5, 2.0, (n_inst, 1, 1)).astype(np.float32)
        o2w[:, :3, 3] = rng.uniform(-5, 5, (n_inst, 3))
    base = np.concatenate([[0], np.cumsum([len(geos[b][1]) for b in inst_blas])[:-1]])
    return geos, inst_blas, o2w, base.astype(np.int32)


@pytest.mark.parametrize("n_inst,grid,cap", [(6, False, None), (30, False, 94), (512, True, 576)])
def test_build_two_level_matches_jax(n_inst, grid, cap):
    geos, inst_blas, o2w, base = instanced_inputs(np.random.default_rng(n_inst), n_inst, grid)
    ref = jb.build_two_level(geos, inst_blas, o2w, base, inst_cap=cap)
    assert_build_equal(tb.build_two_level_host(geos, inst_blas, o2w, base, inst_cap=cap), ref)


def rt_scene(mod_procedural, mod_lights, res: int = 96):
    """The scene of test_golden.py's rt case: one sphere and a casting spot."""
    scene, cam = mod_procedural.build_test_scene(viewport=(res, res), n_spheres=1)
    scene.spots.append(mod_lights.SpotLight(
        position=np.array([0.5, 3.0, 1.0], np.float32),
        direction=np.array([-0.2, -1.0, -0.1], np.float32),
        luminous_intensity_cd=150000.0, cast_shadows=True))
    return scene, cam


def test_scene_bvh_matches_jax():
    """The rt golden's scene built with its BVH (64 parked TLAS slots) in
    both packages; the port's BVH lands on the device as built. A scene
    built without one carries the reference's one-leaf placeholder, field
    for field, and the reference's carries across as the same."""
    from arkoserenderer_torch.bridge import scene_arrays_from_numpy
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_torch.scene.lights as tlights
    import arkoserenderer_tpu.assets.procedural as jproc
    import arkoserenderer_tpu.scene.lights as jlights

    js, _ = rt_scene(jproc, jlights)
    ts, _ = rt_scene(tproc, tlights)
    ref = js.build(with_bvh=True).bvh
    host = ts._build_bvh(64)
    assert_build_equal(host, ref)
    assert host["n_tlas"] == ref.n_tlas and int((~host["inst_active"]).sum()) == 64
    on_device = ts.build("cpu", with_bvh=True).bvh
    assert isinstance(on_device, tb.TwoLevelBVH) and on_device.n_tlas == ref.n_tlas
    assert torch.equal(on_device.wide_rec, torch.from_numpy(host["wide_rec"]))
    ref_dummy = js.build().bvh
    for ours in (ts.build("cpu").bvh, scene_arrays_from_numpy(js.build()._asdict(), "cpu").bvh):
        assert isinstance(ours, tb.FlatBVH)
        for f in tb.FlatBVH._fields:
            a, b = np.asarray(getattr(ref_dummy, f)), getattr(ours, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def trace_cases():
    """{name: (jax bvh, port bvh, origins, dirs, per-ray t_max, brute (verts, tris) or None)}."""
    rng = np.random.default_rng(1234)
    bvh, geos, inst_blas, o2w, tris = _two_level_fixture(rng)
    origins, dirs = random_rays(rng, 512)
    parked = origins.copy()
    parked[::2] = -1e7  # rays the RT passes park: they must leave in one step
    base = np.asarray(jnp.asarray(bvh.inst_tri_base))
    host = tb.build_two_level_host(geos, inst_blas, o2w, base)
    brute = (_world_pool(geos, inst_blas, o2w), tris)
    t_max = rng.uniform(0.5, 12.0, 512).astype(np.float32)
    cases = {"two_level": (bvh, host, origins, dirs, t_max, brute),
             "parked": (bvh, host, parked, dirs, t_max, None)}
    geos, inst_blas, o2w, base = instanced_inputs(np.random.default_rng(16), 4096, True)
    deep_ref = jb.build_two_level(geos, inst_blas, o2w, base, inst_cap=4096 + 64)
    deep = tb.build_two_level_host(geos, inst_blas, o2w, base, inst_cap=4096 + 64)
    o = rng.uniform(-9, 9, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    cases["tlas4096"] = (deep_ref, deep, o, d, rng.uniform(0.5, 20.0, 512).astype(np.float32),
                         None)
    return cases


@functools.partial(jax.jit, static_argnames=("any_hit",))
def j_trace(bvh, o, d, t_max, any_hit):
    """JAX's trace_rays, jitted with the BVH as an argument (one compile per
    shape set and mode, not one per BVH)."""
    return jb.trace_rays(bvh, o, d, t_max=t_max, any_hit=any_hit)


@pytest.fixture(scope="module")
def traced():
    """Every case through JAX's _trace_wide and the port's plain walk,
    closest-hit and any-hit, with t_max scalar and per ray."""
    out = {}
    for name, (jbvh, host, o, d, tm, brute) in trace_cases().items():
        pbvh = tb.bvh_from_host(host, "cpu")
        for any_hit in (False, True):
            for per_ray in (False, True):
                t_max = tm if per_ray else 1e30
                ref = j_trace(jbvh, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max, jnp.float32), any_hit=any_hit)
                stats = {}
                ours = tb.trace_wide_plain(pbvh, torch.from_numpy(o), torch.from_numpy(d),
                                           t_max=torch.as_tensor(t_max), any_hit=any_hit,
                                           stats=stats)
                out[name, any_hit, per_ray] = (ours, ref, stats, o, d, brute)
    return out


@pytest.mark.parametrize("per_ray", [False, True], ids=["scalar_tmax", "per_ray_tmax"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("case", ["two_level", "parked", "tlas4096"])
def test_trace_matches_jax(traced, case, any_hit, per_ray):
    ours, ref, stats, o, _, _ = traced[case, any_hit, per_ray]
    np.testing.assert_array_equal(ours.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(ours.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.u.numpy(), np.asarray(ref.u), atol=1e-4)
    np.testing.assert_allclose(ours.v.numpy(), np.asarray(ref.v), atol=1e-4)
    assert ours.hit.any()
    parked = o[:, 0] == -1e7
    assert (stats["steps"].numpy()[parked] == 1).all()  # a parked ray leaves in one step
    assert not ours.hit.numpy()[parked].any()
    if case == "tlas4096":
        assert stats["steps"].max() > 40  # deep: many instance entries a ray


def test_trace_matches_brute_force(traced):
    """The reference test's oracle and bounds (test_bvh.py
    test_two_level_matches_brute_force)."""
    ours, _, _, o, d, (verts, tris) = traced["two_level", False, False]
    ref_t, ref_tri = jb.trace_rays_brute(verts, tris, np.ones(len(tris), bool), o, d)
    got_tri = ours.tri.numpy()
    np.testing.assert_array_equal(got_tri >= 0, ref_tri >= 0)
    h = ref_tri >= 0
    assert h.sum() > 30
    np.testing.assert_allclose(ours.t.numpy()[h], ref_t[h], rtol=1e-3, atol=1e-3)
    assert (got_tri[h] == ref_tri[h]).mean() > 0.99
    any_hit = traced["two_level", True, False][0]
    np.testing.assert_array_equal(any_hit.hit.numpy(), ref_tri >= 0)


@pytest.mark.parametrize("max_steps", [9, 20, 512])
def test_stack_overflow_and_step_cut_follow_the_reference(max_steps):
    """Hand-made records whose chain overflows the 64-entry stack
    (``trace_bench.overflow_case``: pushes past index 63 dropped, sp capped
    at 63), cut at 9 and 20 steps or run out: the plain walk equals JAX's
    exactly, and the hits show the overflow (no ray reaches the triangles
    of the levels past it)."""
    from arkoserenderer_torch.tools.trace_bench import overflow_case

    bvh, o, d = overflow_case("cpu")
    shell = jb.build_two_level([(np.eye(3, dtype=np.float32), np.array([[0, 1, 2]], np.int32))],
                               np.zeros(1, np.int32), np.eye(4, dtype=np.float32)[None],
                               np.zeros(1, np.int32))
    ref_bvh = dataclasses.replace(shell, **{k: jnp.asarray(getattr(bvh, k).numpy())
                                            for k in ("wide_rec", "quad_rec", "inst_rec")})
    r = jb._trace_wide(ref_bvh, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 1e30, 1e-4,
                       False, max_steps)
    stats = {}
    p = tb.trace_wide_plain(bvh, o, d, max_steps=max_steps, stats=stats)
    np.testing.assert_array_equal(p.tri.numpy(), np.asarray(r.tri))
    np.testing.assert_allclose(p.t.numpy(), np.asarray(r.t), rtol=1e-5, atol=1e-5)
    assert int(stats["steps"].max()) == min(max_steps, int(stats["steps"].max()))
    if max_steps == 512:
        assert p.hit.all() and int(p.tri.max()) < 7 * 9  # levels 9-11 never reached


def test_trace_rays_dispatch():
    """trace_rays walks CPU tensors with the plain version, and a scene
    built without a BVH (its one-leaf placeholder) misses every ray, as the
    reference's does: t = t_max, tri = -1, hit False, closest and any hit."""
    from arkoserenderer_torch.scene.scene import _dummy_bvh

    rng = np.random.default_rng(9)
    geos, inst_blas, o2w, base = instanced_inputs(rng, 8, False)
    bvh = tb.build_two_level(geos, inst_blas, o2w, base, device="cpu")
    o = torch.from_numpy(rng.uniform(-6, 6, (300, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    for x, y in zip(tb.trace_rays(bvh, o, d), tb.trace_wide_plain(bvh, o, d)):
        assert torch.equal(x, y)
    o[0] = torch.tensor([-1.0, 0.0, 0.0])  # a ray through the placeholder's box
    d[0] = torch.tensor([1.0, 0.0, 0.0])
    for any_hit in (False, True):
        h = tb.trace_rays(_dummy_bvh("cpu"), o, d, t_max=1e4, any_hit=any_hit)
        assert not h.hit.any() and (h.tri == -1).all() and (h.t == 1e4).all()
