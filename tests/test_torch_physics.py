"""The port's rigid-body solver (``arkoserenderer_torch/physics/backend.py``)
against the JAX package's, and its own copies of the reference's behaviour
assertions.

Each scenario of ``tests/test_physics_solver.py`` and
``tests/test_system_physics.py:75-168`` is built with the JAX package's
backend; ``copy_bodies`` carries its bodies, planes and meshes into the
port's, so both start from the same state. Both step at 1/60 s, and every
body's transform, position, velocity, orientation, angular velocity and
sleep state is equal bit for bit after each of the first 120 steps (or of
the scenario's whole horizon when it is shorter): host numpy on both sides,
the same operations in the same float32 / float64 mix. Then the port alone
runs on to the reference test's horizon and meets its assertions (a stable
five-box stack that falls asleep, restitution's bounce ratio, a sleeping
body woken by an impulse, a tumbling box, a ball that bounces and settles,
rolling on a triangle mesh, PhysicsScene's commit). The friction and
box-box cases are in ``test_torch_physics_contacts.py``, so the two files
run on two workers.

The port's own construction (``add_body``, ``add_static_plane``,
``add_static_mesh``) gives the arrays the JAX package's gives.
"""

import numpy as np
import pytest

import arkoserenderer_torch.physics.backend as tphys
import arkoserenderer_tpu.physics.backend as jphys

COMPARE_STEPS = 120
DT = 1 / 60.0
BODY_LISTS = ("pos", "vel", "quat", "omega", "_inv_mass", "_inv_inertia_body", "_sleep_time",
              "asleep")


def copy_bodies(jb: jphys.BuiltinPhysicsBackend) -> tphys.BuiltinPhysicsBackend:
    """A port backend holding copies of the JAX backend's bodies (state,
    descriptions, inverse masses and inertias, sleep state), static planes
    and static meshes."""
    tb = tphys.BuiltinPhysicsBackend()
    for name in BODY_LISTS:
        setattr(tb, name, [v.copy() if isinstance(v, np.ndarray) else v
                           for v in getattr(jb, name)])
    tb.desc = [tphys.BodyDesc(d.shape, np.array(d.half_extents, copy=True), d.mass,
                              d.restitution, d.friction) for d in jb.desc]
    tb.planes = [(n.copy(), off) for n, off in jb.planes]
    tb.meshes = [tuple(a.copy() for a in mesh) for mesh in jb.meshes]
    return tb


def assert_same_state(tb, jb, step=None):
    for name in BODY_LISTS:
        for i, (t, j) in enumerate(zip(getattr(tb, name), getattr(jb, name), strict=True)):
            if isinstance(j, np.ndarray):
                assert t.dtype == j.dtype, (name, i, step)
                np.testing.assert_array_equal(t, j, err_msg=f"{name}[{i}] at step {step}")
            else:
                assert type(t) is type(j) and t == j, (name, i, step, t, j)
    for i in range(len(jb.pos)):
        np.testing.assert_array_equal(tb.body_transform(i), jb.body_transform(i),
                                      err_msg=f"transform {i} at step {step}")


def run_both(jb, steps: int = COMPARE_STEPS, dt: float = DT):
    """Copy ``jb`` into the port, step both ``steps`` times, comparing after
    every step; returns the port's backend."""
    tb = copy_bodies(jb)
    assert_same_state(tb, jb, 0)
    for s in range(steps):
        jb.step(dt)
        tb.step(dt)
        assert_same_state(tb, jb, s + 1)
    return tb


def floor(pkg):
    b = pkg.BuiltinPhysicsBackend()
    b.add_static_plane((0, 1, 0), 0.0)
    return b


def test_port_construction_matches_jax():
    bodies = [("box", [0.5, 0.4, 0.3], 2.0, (0.0, 3.0, 0.0), (1.0, 0.0, 0.0)),
              ("sphere", [0.2] * 3, 1.0, (1.0, 2.0, -1.0), (0, 0, 0)),
              ("box", [1.0, 1.0, 1.0], 0.0, (0.0, -1.0, 0.0), (0, 0, 0))]
    verts = np.array([[-2, 0, -2], [2, 1, -2], [2, 1, 2], [-2, 0, 2], [0, 0, 0]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3], [4, 4, 4]])  # the last is degenerate
    sides = []
    for pkg in (tphys, jphys):
        b = pkg.BuiltinPhysicsBackend()
        assert b.add_static_plane((0, 2, 0), 0.5) == 0
        assert b.add_static_mesh(verts, tris) == 0
        for k, (shape, he, m, p, v) in enumerate(bodies):
            assert b.add_body(pkg.BodyDesc(shape, np.array(he), mass=m), p, velocity=v) == k
        sides.append(b)
    tb, jb = sides
    assert_same_state(tb, jb)
    for (tn, to), (jn, jo) in zip(tb.planes, jb.planes, strict=True):
        np.testing.assert_array_equal(tn, jn)
        assert to == jo
    for tm, jm in zip(tb.meshes, jb.meshes, strict=True):
        for ta, ja in zip(tm, jm, strict=True):
            np.testing.assert_array_equal(ta, ja)
    assert len(tb.meshes[0][0]) == 2
    c = copy_bodies(jb)
    assert_same_state(c, jb)
    for k in range(3):
        tb.apply_impulse(k, (0.5, 1.0, -2.0))
        jb.apply_impulse(k, (0.5, 1.0, -2.0))
    assert_same_state(tb, jb)
    assert (tphys.SOLVER_ITERS, tphys.BAUMGARTE, tphys.SLOP, tphys.SLEEP_TIME) == (
        jphys.SOLVER_ITERS, jphys.BAUMGARTE, jphys.SLOP, jphys.SLEEP_TIME)
    np.testing.assert_array_equal(tphys.GRAVITY, jphys.GRAVITY)


def test_five_box_stack_is_stable():
    jb = floor(jphys)
    boxes = [jb.add_body(jphys.BodyDesc("box", np.array([0.5, 0.5, 0.5]), mass=1.0,
                                        restitution=0.0),
                         (0.0, 0.5 + 1.0 * k + 0.001 * k, 0.0)) for k in range(5)]
    b = run_both(jb)
    for _ in range(300 - COMPARE_STEPS):
        b.step(DT)
    for k, body in enumerate(boxes):
        p = b.pos[body]
        assert abs(p[0]) < 0.08 and abs(p[2]) < 0.08, (k, p)
        assert abs(p[1] - (0.5 + 1.0 * k)) < 0.06, (k, p)
        assert b.body_transform(body)[1, 1] > 0.99
    assert all(b.asleep[body] for body in boxes)


def test_restitution_bounce_ratio():
    jb = floor(jphys)
    ball = jb.add_body(jphys.BodyDesc("sphere", np.array([0.2] * 3), mass=1.0, restitution=0.5),
                       (0, 2.0, 0))
    b = copy_bodies(jb)
    heights = []
    for s in range(480):
        b.step(DT)
        if s < COMPARE_STEPS:
            jb.step(DT)
            assert_same_state(b, jb, s + 1)
        heights.append(float(b.pos[ball][1]))
    h = np.array(heights)
    touch = int(np.argmax(h < 0.25))
    seg = h[touch:]
    rising = np.nonzero((seg[1:-1] > seg[:-2]) & (seg[1:-1] >= seg[2:]))[0]
    apex1 = float(seg[rising[0] + 1]) - 0.2
    later = rising[rising > rising[0] + 5]
    apex2 = float(seg[later[0] + 1]) - 0.2
    assert 0.1 < apex2 / apex1 < 0.45


def test_ball_bounces_and_settles():
    jb = floor(jphys)
    ball = jb.add_body(jphys.BodyDesc("sphere", np.array([0.2, 0.2, 0.2]), mass=1.0,
                                      restitution=0.5), (0, 3.0, 0))
    b = copy_bodies(jb)
    heights = []
    for s in range(600):
        b.step(DT)
        if s < COMPARE_STEPS:
            jb.step(DT)
            assert_same_state(b, jb, s + 1)
        heights.append(float(b.pos[ball][1]))
    assert min(heights) >= 0.19
    assert abs(heights[-1] - 0.2) < 0.02
    first_touch = next(i for i, h in enumerate(heights) if h < 0.25)
    assert max(heights[first_touch:]) > 0.3


def test_sleeping_body_wakes_on_impulse():
    jb = floor(jphys)
    box = jb.add_body(jphys.BodyDesc("box", np.array([0.5, 0.5, 0.5]), mass=1.0,
                                     restitution=0.0), (0, 0.5, 0))
    b = run_both(jb)
    assert b.asleep[box] and jb.asleep[box]
    p0 = b.pos[box].copy()
    for _ in range(60):
        b.step(DT)
    assert np.allclose(b.pos[box], p0)
    b.apply_impulse(box, (4.0, 0.0, 0.0))
    jb.apply_impulse(box, (4.0, 0.0, 0.0))
    assert not b.asleep[box]
    for s in range(30):
        b.step(DT)
        jb.step(DT)
        assert_same_state(b, jb, COMPARE_STEPS + s + 1)
    assert b.pos[box][0] > 0.1


def test_box_tumbles_with_orientation():
    jb = floor(jphys)
    box = jb.add_body(jphys.BodyDesc("box", np.array([0.3, 0.3, 0.3]), mass=1.0), (0, 3.0, 0))
    jb.omega[box] = np.array([0.0, 0.0, 3.0], np.float32)
    b = run_both(jb, steps=20)
    m = b.body_transform(box)
    assert abs(m[0, 0] - 1.0) > 0.1
    assert abs(float(np.linalg.norm(b.quat[box])) - 1.0) < 1e-5


def test_triangle_mesh_collision():
    jb = jphys.BuiltinPhysicsBackend()
    verts = np.array([[-2, 0, -2], [2, 1, -2], [2, 1, 2], [-2, 0, 2]], np.float32)
    jb.add_static_mesh(verts, np.array([[0, 1, 2], [0, 2, 3]]))
    body = jb.add_body(jphys.BodyDesc("sphere", np.array([0.2] * 3, np.float32)), (0.5, 3.0, 0.0))
    b = run_both(jb, steps=90)
    p = b.pos[body]
    surface_y = (p[0] + 2) / 4
    assert 0.1 < p[1] - surface_y < 0.35
    assert p[0] < 0.2
    assert abs(p[2]) < 0.1
    assert float(b.omega[body][2]) > 1.0


@pytest.mark.parametrize("pair", ["sphere-sphere", "sphere-box"])
def test_pair_contacts_match_jax(pair):
    """The pair paths the scenarios above leave out: a sphere dropped on a
    sphere and on a box, resting on the floor."""
    jb = floor(jphys)
    jb.add_body(jphys.BodyDesc("sphere" if pair == "sphere-sphere" else "box",
                               np.array([0.4] * 3), mass=2.0), (0.0, 0.4, 0.0))
    jb.add_body(jphys.BodyDesc("sphere", np.array([0.25] * 3), mass=1.0, restitution=0.6),
                (0.1, 1.6, 0.05))
    b = run_both(jb, steps=60)
    # The falling body hit the lower one and moved it.
    assert np.abs(b.pos[0] - np.array([0.0, 0.4, 0.0], np.float32)).max() > 1e-4


def test_impulse_and_scene_sync():
    from arkoserenderer_torch.assets.procedural import build_test_scene

    scene, _ = build_test_scene(viewport=(64, 64), n_spheres=1)
    jb = floor(jphys)
    body = jb.add_body(jphys.BodyDesc("box", np.array([0.5, 0.5, 0.5]), mass=2.0), (0, 0.5, 0))
    jb.apply_impulse(body, (6.0, 0, 0))
    b = run_both(jb, steps=30)
    ps = tphys.PhysicsScene(backend=b, scene=scene)
    ps.attach(body, 1)
    old = scene.instances[1][1]
    ps.commit()
    sid, world, prev, band = scene.instances[1]
    np.testing.assert_array_equal(world, jb.body_transform(body))
    assert world[0, 3] > 0.1
    assert prev is old
