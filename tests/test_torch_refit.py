"""The port's per-frame BVH refit (``ops/bvh.refit_bvh``) against the JAX
package's, on the bench's test_anim scene with its clips
(``test_torch_animation.anim_scene(moving=True)``).

The frame's deformation is made once with JAX's ops (the morph block at
weight 0.8, the palette at t = 0.3) and the world matrices of four
instances are moved: the skinned box and a static sphere translated, the
static box and that sphere rotated about y. Both refits take the same
world-space vertices, the same pool indices and the same matrices, so:

  * BLAS node bounds (min/max of equal triangle bounds), the quad records
    and the wide records' descriptors: equal;
  * the transform-derived fields (the inverse transforms in ``inst_w2o``
    and ``inst_rec``, the instances' world boxes, so the TLAS node bounds
    and their wide records): within 4 ulps, for the adjugate inverse and
    the 3-term products may round differently on the two backends (they
    measured equal on this scene);
  * ``trace_wide_plain`` through the refitted BVH against JAX's
    ``trace_rays`` on 4,096 seeded rays: ``tri`` equal on all but 0.1 % of
    the rays (an ulp can flip a hit on an edge; none flipped here), ``t``
    to atol 1e-5 where ``tri`` agrees.

The records the kernel reads come out contiguous int32 of the widths its
wrapper checks, the refitted bounds contain their children, and two frames
from the same base pools give the same geometry and BVH (a morph applied
in place would add twice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.ops import bvh as tb
from arkoserenderer_tpu.ops import bvh as jb
from arkoserenderer_tpu.ops import skinning as jsk
from test_torch_animation import anim_scene
from test_torch_bvh import j_trace

torch.set_num_threads(2)

ULPS = 4
N_RAYS = 4096
BOX, SPHERE = 5, 6  # the skinned box's and the morphed sphere's instance ids


def _ulps(a, b) -> int:
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max()) if ai.size else 0


def _moved_world(world: np.ndarray) -> np.ndarray:
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    world = np.array(world)
    world[BOX, :3, 3] += (0.4, 0.0, -0.3)
    world[1, :3, 3] += (0.3, 0.1, 0.0)
    world[1, :3, :3] = rot @ world[1, :3, :3]
    world[4, :3, :3] = rot.T @ world[4, :3, :3]
    return world


@pytest.fixture(scope="module")
def refits():
    js, _ = anim_scene("jax", moving=True)
    jsa = js.build(with_bvh=True)
    palette = js.update_animations(0.3)
    base = js.static_info().morph_vertex_base[0]
    p, n = jsk.apply_morphs(jsa.positions, jsa.normals, jsa.morph_pos[0], jsa.morph_nrm[0],
                            jnp.asarray([0.8], jnp.float32), base)
    p, _, _ = jsk.skin_vertices(p, n, jsa.tangents, jsa.skin_joints, jsa.skin_weights,
                                jnp.asarray(palette))
    world = _moved_world(np.asarray(jsa.world))
    m = world[np.asarray(jsa.vertex_instance)]
    wp = (np.einsum("vij,vj->vi", m[:, :3, :3].astype(np.float64), np.asarray(p, np.float64))
          + m[:, :3, 3]).astype(np.float32)
    indices = np.array(jsa.indices)
    ref = jb.refit_bvh(jsa.bvh, jnp.asarray(wp), jnp.asarray(indices), world=jnp.asarray(world))
    built = tb.bvh_from_host(bridge.numpy_fields(jsa.bvh), "cpu")
    ours = tb.refit_bvh(built, torch.from_numpy(wp), torch.from_numpy(indices),
                        world=torch.from_numpy(world))
    rng = np.random.default_rng(21)
    o = rng.uniform(-6, 6, (N_RAYS, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.05, 3.0, N_RAYS)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    j_hit = j_trace(ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(1e4, jnp.float32),
                    any_hit=False)
    t_hit = tb.trace_wide_plain(ours, torch.from_numpy(o), torch.from_numpy(d), t_max=1e4)
    static = tb.trace_wide_plain(built, torch.from_numpy(o), torch.from_numpy(d), t_max=1e4)
    return dict(ref=ref, ours=ours, built=built, j_hit=j_hit, t_hit=t_hit, static=static,
                tri_instance=np.asarray(jsa.tri_instance), wp=wp)


def test_refit_matches_jax(refits):
    ref, ours = refits["ref"], refits["ours"]
    nt = ours.n_tlas
    for f in ("node_min", "node_max"):
        np.testing.assert_array_equal(getattr(ours, f).numpy()[nt:],
                                      np.asarray(getattr(ref, f))[nt:], err_msg=f)
        assert _ulps(getattr(ours, f).numpy()[:nt], np.asarray(getattr(ref, f))[:nt]) <= ULPS, f
    for f in ("tri_v0", "tri_e1", "tri_e2", "node_cbounds", "tri_quad"):
        assert _ulps(getattr(ours, f).numpy(), np.asarray(getattr(ref, f))) <= ULPS, f
    np.testing.assert_array_equal(ours.quad_rec.numpy(), np.asarray(ref.quad_rec))
    np.testing.assert_array_equal(ours.node_int.numpy(), np.asarray(ref.node_int))
    w_ours, w_ref = ours.wide_rec.numpy(), np.asarray(ref.wide_rec)
    np.testing.assert_array_equal(w_ours[:, 48:], w_ref[:, 48:])
    assert _ulps(w_ours[:, :48].view(np.float32), w_ref[:, :48].view(np.float32)) <= ULPS
    i_ours, i_ref = ours.inst_rec.numpy(), np.asarray(ref.inst_rec)
    np.testing.assert_array_equal(i_ours[:, 12:], i_ref[:, 12:])
    assert _ulps(i_ours[:, :12].view(np.float32), i_ref[:, :12].view(np.float32)) <= ULPS
    for f in ("inst_w2o", "inst_o2w", "wide_cbounds"):
        assert _ulps(getattr(ours, f).numpy(), np.asarray(getattr(ref, f))) <= ULPS, f
    # The refit moved the deformable BLASes' triangles and the moved instances.
    assert not torch.equal(ours.quad_rec, refits["built"].quad_rec)
    assert not torch.equal(ours.inst_rec, refits["built"].inst_rec)


def test_refit_records_are_what_the_kernel_reads(refits):
    """Contiguous int32 rows of the widths ``ops/bvh_cuda`` checks; parked
    slots stay parked (their boxes far below the scene)."""
    ours = refits["ours"]
    for f, width in (("wide_rec", 56), ("quad_rec", 40), ("inst_rec", 14)):
        rec = getattr(ours, f)
        assert rec.dtype == torch.int32 and rec.shape[1] == width and rec.is_contiguous(), f
    parked = ~ours.inst_active
    assert int(parked.sum()) == 64
    leaf = (ours.count[:ours.n_tlas] == -1).nonzero().squeeze(1)
    slots = ours.left[leaf].long()
    assert (ours.node_max[leaf][parked[slots]] < -1e8).all()
    assert (ours.node_min[leaf][~parked[slots]] > -1e8).all()


def test_refit_bounds_contain_children(refits):
    """Every internal node's box holds its children's, and every BLAS leaf's
    box holds its slots' triangles."""
    b = refits["ours"]
    nmin, nmax = b.node_min.numpy(), b.node_max.numpy()
    left, right, count = b.left.numpy(), b.right.numpy(), b.count.numpy()
    for node in np.nonzero(count == 0)[0]:
        for ch in (left[node], right[node]):
            assert (nmin[node] <= nmin[ch]).all() and (nmax[node] >= nmax[ch]).all()
    v0 = b.tri_v0.numpy()
    tris = np.stack([v0, v0 + b.tri_e1.numpy(), v0 + b.tri_e2.numpy()], 1)
    for node in np.nonzero(count > 0)[0]:
        s, e = b.node_start.numpy()[node], b.node_end.numpy()[node]
        assert (nmin[node] <= tris[s:e].min((0, 1))).all()
        assert (nmax[node] >= tris[s:e].max((0, 1))).all()


def test_trace_through_refit_matches_jax(refits):
    """4,096 seeded rays through the refitted BVH: the plain walk against
    JAX's traversal, and the deformed and moved instances are hit."""
    t_hit, j_hit = refits["t_hit"], refits["j_hit"]
    tri, j_tri = t_hit.tri.numpy(), np.asarray(j_hit.tri)
    agree = tri == j_tri
    assert agree.mean() >= 0.999
    np.testing.assert_allclose(t_hit.t.numpy()[agree], np.asarray(j_hit.t)[agree], atol=1e-5,
                               rtol=0)
    inst = refits["tri_instance"][np.maximum(tri, 0)]
    for i in (BOX, SPHERE, 1, 4):
        assert ((inst == i) & (tri >= 0)).sum() > 10, i
    assert (refits["static"].tri.numpy() != tri).mean() > 0.01  # the refit changed the hits


def test_animated_frames_repeat():
    """The port's Scene and BVHRefit passes run twice on one frame's inputs
    (palette and weights of t = 0.3) give the same geometry and BVH both
    times, and the scene's base pools stay as built."""
    from arkoserenderer_torch.core.types import RasterConfig
    from arkoserenderer_torch.models.standard import make_forward_pipeline
    from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig

    ts, cam = anim_scene("torch", moving=True)
    tsa = ts.build("cpu", with_bvh=True)
    base_pos = tsa.positions.clone()
    palette = ts.update_animations(0.3)
    tsa = tsa._replace(palette=torch.from_numpy(palette.copy()),
                       morph_weights=(torch.tensor([0.8]),))
    cfg = PipelineConfig(width=32, height=32, shadow_map_size=32, scene=ts.static_info(),
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64))
    pipe = make_forward_pipeline(cfg, device="cpu", ddgi=None, rt_shadows=True, rt_refit=True)
    executes = dict(pipe._executes)
    ctx = FrameContext(scene=tsa, camera=cam.state(0, "cpu"), frame_index=0, delta_time=1 / 60)
    outs = []
    for _ in range(2):
        state = executes["Scene"]({}, ctx)
        state.update(executes["BVHRefit"](state, ctx))
        outs.append(state)
    for key in ("geom.positions", "geom.normals", "geom.tangents"):
        assert torch.equal(outs[0][key], outs[1][key]), key
    for f in ("wide_rec", "quad_rec", "inst_rec"):
        assert torch.equal(getattr(outs[0]["scene.bvh"], f), getattr(outs[1]["scene.bvh"], f))
    assert torch.equal(tsa.positions, base_pos)
    moved = (outs[0]["geom.positions"] - base_pos).abs().amax(-1)
    vi = tsa.vertex_instance
    assert moved[vi == BOX].min() > 0.1 and moved[vi == SPHERE].max() > 0.1
    assert moved[(vi != BOX) & (vi != SPHERE)].max() == 0.0
