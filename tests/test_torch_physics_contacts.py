"""The port's rigid-body solver against the JAX package's on the friction
and box-box cases of ``tests/test_physics_solver.py`` (see
``test_torch_physics.py``: the same bodies in both packages, every body
equal bit for bit after each of the first 120 steps, then the port alone
meets the reference test's assertions at its horizon). They are the
costliest scenarios, so they run in a file of their own.
"""

import numpy as np
import pytest

import arkoserenderer_tpu.physics.backend as jphys
from test_torch_physics import COMPARE_STEPS, DT, assert_same_state, copy_bodies, floor, run_both


@pytest.mark.parametrize("mu", [0.6, 0.05])
def test_coulomb_friction_holds_and_releases_on_incline(mu):
    """tan(15 deg) = 0.27: the box holds with mu 0.6 and slides with 0.05."""
    theta = np.radians(15.0)
    n = np.array([-np.sin(theta), np.cos(theta), 0.0], np.float32)
    jb = jphys.BuiltinPhysicsBackend()
    jb.add_static_plane(n, 0.0)
    body = jb.add_body(jphys.BodyDesc("box", np.array([0.3, 0.3, 0.3]), mass=1.0,
                                      restitution=0.0, friction=mu),
                       np.array([0.0, 0.0, 0.0]) + n * 0.3)
    jb.quat[body] = np.array([0.0, 0.0, np.sin(theta / 2), np.cos(theta / 2)], np.float32)
    start = jb.pos[body].copy()
    b = run_both(jb)
    for _ in range(180 - COMPARE_STEPS):
        b.step(DT)
    moved = float(np.linalg.norm(b.pos[body] - start))
    if mu > 0.5:
        assert moved < 0.05
    else:
        assert moved > 0.5


def test_box_box_collision_transfers_momentum():
    jb = floor(jphys)
    a = jb.add_body(jphys.BodyDesc("box", np.array([0.4, 0.4, 0.4]), mass=1.0, restitution=0.1,
                                   friction=0.0), (-2.0, 0.4, 0.0), velocity=(4.0, 0.0, 0.0))
    c = jb.add_body(jphys.BodyDesc("box", np.array([0.4, 0.4, 0.4]), mass=1.0, restitution=0.1,
                                   friction=0.0), (0.0, 0.4, 0.0))
    b = copy_bodies(jb)
    for s in range(90):
        b.step(DT)
        jb.step(DT)
        assert_same_state(b, jb, s + 1)
    va, vc, pc = b.vel[a], b.vel[c], b.pos[c]
    assert pc[0] > 0.15
    assert vc[0] >= -1e-3
    assert float(va[0]) < 4.0
    assert np.isfinite(va).all() and np.isfinite(vc).all()
