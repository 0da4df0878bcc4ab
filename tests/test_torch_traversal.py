"""The traversal's measurement helpers on the CPU: the plain walk's per-ray
transform count (``inst_steps``) against a hand count, the bound that
charges a transform per ray and per instance entry, the edge rays of
``tools/trace_bench.edge_cases`` through the plain walk against JAX's
``_trace_wide``, the probe case's rays, and ``fibonacci_sphere`` against
the reference's.

Tolerances: counts and ``fibonacci_sphere`` exact; the edge rays: hit and
tri equal, t, u and v to atol 1e-4. XLA:CPU fuses multiply-adds (see
``tests/test_torch_bvh.py``), and these rays start next to surfaces inside
instance boxes: t is then a small difference of products of coordinates
of size ~10 (one ulp there is ~1e-6) divided by the determinant, so its
error is absolute, not relative to t (one ray of 4,099 at t = 0.048
differs by 1.4e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch.core import halton as t_halton
from arkoserenderer_torch.ops import bvh as tb
from arkoserenderer_torch.tools import trace_bench
from arkoserenderer_tpu.core import halton as j_halton
from arkoserenderer_tpu.ops import bvh as jb

torch.set_num_threads(2)


@pytest.mark.parametrize("count", [1, 7, 256, 1000])
def test_fibonacci_sphere_matches_the_reference(count):
    ours, ref = t_halton.fibonacci_sphere(count), j_halton.fibonacci_sphere(count)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


def two_instances():
    """Two instances of a 2-triangle square in the plane x = 0 (y, z in
    [-1, 1]), placed at x = 0 and x = 3."""
    verts = np.array([[0, -1, -1], [0, 1, -1], [0, 1, 1], [0, -1, 1]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    o2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    o2w[1, 0, 3] = 3.0
    return tb.build_two_level([(verts, tris)], np.zeros(2, np.int32), o2w,
                              np.array([0, 2], np.int32), device="cpu")


# (origin, direction, transforms: the TLAS entry + the instances entered)
HAND = [((-5.0, 0.1, 0.2), (1.0, 0.0, 0.0), 3),   # through both squares
        ((-5.0, 5.0, 5.0), (1.0, 0.0, 0.0), 1),   # past both boxes
        ((1.5, 0.1, 0.2), (1.0, 0.0, 0.0), 2),    # between them, toward the second
        ((-5.0, 0.1, 0.2), (-1.0, 0.0, 0.0), 1)]  # away from both


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_inst_steps_equal_a_hand_count(any_hit):
    """Closest-hit rays enter every instance whose box they cross (the far
    one too: its leaf was pushed before the near hit shrank t); an any-hit
    ray stops at the first square it hits."""
    bvh = two_instances()
    o = torch.tensor([h[0] for h in HAND])
    d = torch.tensor([h[1] for h in HAND])
    stats = {}
    hit = tb.trace_wide_plain(bvh, o, d, any_hit=any_hit, stats=stats)
    want = [h[2] for h in HAND]
    if any_hit:
        want[0] = 2
    assert stats["inst_steps"].tolist() == want
    assert hit.hit.tolist() == [True, False, True, False]
    assert hit.tri.tolist()[0] in (0, 1) and hit.tri.tolist()[2] in (2, 3)
    assert (stats["steps"] == stats["node_steps"] + stats["quad_steps"]).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_bound_charges_a_transform_per_ray_and_instance_entry(any_hit):
    """On a 64-instance TLAS: the operations bound counts 42 for the TLAS
    transform of each ray and for each instance entered, not for every
    step, and every step is a node or a quad step."""
    bvh, o, d, tm = trace_bench.tlas_case("cpu", n_inst=64, n_rays=512)
    stats = {}
    tb.trace_wide_plain(bvh, o, d, t_max=tm, any_hit=any_hit, stats=stats)
    n = 512
    entries = int((stats["inst_steps"] - 1).sum())
    assert (stats["inst_steps"] >= 1).all() and entries > 0
    assert (stats["steps"] == stats["node_steps"] + stats["quad_steps"]).all()
    assert int(stats["steps"].sum()) > int(stats["inst_steps"].sum())
    counts = {k: int(v.sum()) for k, v in stats.items()}
    ops = (trace_bench.OPS_TRANSFORM * (n + entries)
           + trace_bench.OPS_TRIANGLE * counts["triangle_tests"]
           + (trace_bench.OPS_SLAB + (0 if any_hit else trace_bench.OPS_SORT))
           * counts["node_steps"])
    rec_bytes = sum(getattr(bvh, k).numel() * 4 for k in ("wide_rec", "quad_rec", "inst_rec"))
    nbytes = n * (24 + 4 + 16) + rec_bytes
    want = max(ops / trace_bench.FP32_OPS_PER_S, nbytes / trace_bench.HBM_BYTES_PER_S) * 1e3
    got, kind = trace_bench.bound_ms(bvh, n, True, any_hit, counts)
    assert got == pytest.approx(want, rel=1e-12)
    assert kind == ("operations" if ops / trace_bench.FP32_OPS_PER_S
                    > nbytes / trace_bench.HBM_BYTES_PER_S else "bytes")


@pytest.fixture(scope="module")
def edge_rays():
    return trace_bench.edge_cases("cpu")


def test_edge_cases_cover_the_edges(edge_rays):
    """Ray counts 0, 1, 33 and 4,099 in both modes, zero and -0.0
    direction components, -0.0 origins, t_max inf and 0."""
    assert sorted({c["origins"].shape[0] for c in edge_rays}) == [0, 1, 33, 4099]
    full = next(c for c in edge_rays if c["origins"].shape[0] == 4099
                and isinstance(c["t_max"], torch.Tensor))
    o, d, tm = full["origins"], full["directions"], full["t_max"]
    neg0 = lambda x: (x == 0) & torch.signbit(x)  # noqa: E731
    assert bool(neg0(d).any()) and bool(((d == 0) & ~torch.signbit(d)).any())
    assert bool((d == 0).all(dim=1).any()) and bool(neg0(o).any())
    assert bool(torch.isinf(tm).any()) and bool((tm == 0).any())
    assert {c["any_hit"] for c in edge_rays} == {False, True}


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("per_ray", [True, False], ids=["per_ray_tmax", "tmax_inf"])
def test_edge_rays_match_jax(edge_rays, any_hit, per_ray):
    case = next(c for c in edge_rays if c["any_hit"] == any_hit
                and c["origins"].shape[0] == 4099
                and isinstance(c["t_max"], torch.Tensor) == per_ray)
    bvh = case["bvh"]
    stats = {}
    ours = tb.trace_wide_plain(bvh, case["origins"], case["directions"], t_max=case["t_max"],
                               any_hit=any_hit, stats=stats)
    shell = jb.build_two_level([(np.eye(3, dtype=np.float32), np.array([[0, 1, 2]], np.int32))],
                               np.zeros(1, np.int32), np.eye(4, dtype=np.float32)[None],
                               np.zeros(1, np.int32))
    ref_bvh = dataclasses.replace(shell, **{k: jnp.asarray(getattr(bvh, k).numpy())
                                            for k in ("wide_rec", "quad_rec", "inst_rec")})
    t_max = case["t_max"]
    t_max = jnp.asarray(t_max.numpy()) if per_ray else t_max
    ref = jax.jit(jb._trace_wide, static_argnums=(4, 5, 6))(
        ref_bvh, jnp.asarray(case["origins"].numpy()), jnp.asarray(case["directions"].numpy()),
        t_max, 1e-4, any_hit, 512)
    np.testing.assert_array_equal(ours.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(ours.hit.numpy(), np.asarray(ref.tri) >= 0)
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours.u.numpy(), np.asarray(ref.u), atol=1e-4)
    np.testing.assert_allclose(ours.v.numpy(), np.asarray(ref.v), atol=1e-4)
    assert 0.05 < ours.hit.float().mean().item() < 0.95
    assert int(stats["inst_steps"].sum()) > 4099  # rays enter instances


def test_probe_case_rays():
    """1,024 probes inside the scene's box shrunk by 10 %, each casting the
    same 256 unit directions: a rotation of fibonacci_sphere(256)."""
    from arkoserenderer_torch.assets.procedural import build_test_scene

    scene, _ = build_test_scene(viewport=(64, 64))
    o, d = trace_bench.probe_case(scene, "cpu")
    n = trace_bench.PROBES * trace_bench.PROBE_RAYS
    assert o.shape == d.shape == (n, 3) and n == 262144
    mins, maxs = scene.bounding_box()
    margin = 0.05 * (maxs - mins) - 1e-5
    assert (o.numpy() >= mins + margin).all() and (o.numpy() <= maxs - margin).all()
    assert len(np.unique(o.numpy(), axis=0)) == trace_bench.PROBES
    dirs = d.numpy()[:256]
    np.testing.assert_array_equal(d.numpy()[256:512], dirs)
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=1), 1.0, atol=1e-6)
    fib = t_halton.fibonacci_sphere(256)
    gram = dirs.astype(np.float64) @ dirs.T.astype(np.float64)
    np.testing.assert_allclose(gram, fib.astype(np.float64) @ fib.T, atol=1e-5)
    assert np.abs(dirs - fib).max() > 0.1  # rotated
