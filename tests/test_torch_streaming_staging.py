"""``StreamingManager.tick``'s staging chunks (``rendering/streaming``) on
the CPU: four spheres streamed under a 16 KiB budget in chunks of 256 rows
into the rt scene's pools (its BVH's parked TLAS slots included) end
equal, field for field and bit for bit, to the same spheres written at once
by the blocking path (``Scene.stream_instance``), every pool tensor keeping
its storage.

The card's events are stood in for by events that complete only when the
test says so (the card a tick behind the host: a tick's events complete
after the next tick) or when the host waits on one: no staging chunk is
refilled before its event has completed, and both ways of getting a chunk
back (one whose copies are done, and a wait on the oldest when every
chunk of a kind is in flight) are taken.
"""

import numpy as np
import torch

import arkoserenderer_torch.assets.procedural as tproc
import arkoserenderer_torch.scene.lights as tlights
from arkoserenderer_torch import bridge
from arkoserenderer_torch.rendering import capture
from arkoserenderer_torch.rendering import streaming as tstream
from test_torch_bvh import rt_scene

WORLDS = [np.array([[1, 0, 0, x], [0, 1, 0, 0.6], [0, 0, 1, -2.0], [0, 0, 0, 1]], np.float32)
          for x in (-1.5, -0.5, 0.5, 1.5)]


class _Event:
    made: list = []

    def __init__(self):
        self.completed = False
        self.waited = False
        _Event.made.append(self)

    def query(self):
        return self.completed

    def synchronize(self):
        self.completed = self.waited = True


def scene_with_sphere():
    """The rt scene built with its BVH, and its first sphere's segment (a
    static BLAS an instance streamed into a parked TLAS slot shares)."""
    scene, _ = rt_scene(tproc, tlights, res=32)
    return scene, 1, scene.build("cpu", with_bvh=True)


def test_staged_ticks_equal_blocking_writes(monkeypatch):
    scene_a, sid_a, arrays_a = scene_with_sphere()
    for w in WORLDS:
        arrays_a = scene_a.stream_instance(arrays_a, sid_a, w)

    _Event.made = []
    monkeypatch.setattr(tstream, "_record_event", lambda device: _Event())
    fill = tstream._Staging.fill
    refills = []

    def checked_fill(self, src):
        assert self.event is None or self.event.completed, "refilled before its event"
        if self.used == 0:
            refills.append(self.event)
        return fill(self, src)

    monkeypatch.setattr(tstream._Staging, "fill", checked_fill)
    scene_b, sid_b, arrays_b = scene_with_sphere()
    ptrs = [t.data_ptr() for t in capture.leaves(arrays_b)]
    mgr = tstream.StreamingManager(scene_b, budget_bytes=16 << 10, chunk_rows=256)
    tickets = [mgr.enqueue_instance(sid_b, w) for w in WORLDS]
    ticks, seen = 0, 0
    while mgr.pending:
        before = len(_Event.made)
        assert mgr.tick(arrays_b) is arrays_b
        for e in _Event.made[seen:before]:  # the previous tick's copies are done
            e.completed = True
        seen = before
        ticks += 1
        assert ticks < 200
    assert all(t.state == tstream.LOADED for t in tickets) and ticks > 4
    assert [t.data_ptr() for t in capture.leaves(arrays_b)] == ptrs
    ref, ours = bridge.numpy_fields(arrays_a), bridge.numpy_fields(arrays_b)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    reused = [e for e in refills if e is not None]
    assert any(not e.waited for e in reused)  # a chunk whose copies were done
    assert any(e.waited for e in reused)      # a wait on the oldest chunk
    assert max(len(v) for v in mgr.staging.chunks.values()) == tstream.STAGING_CHUNKS
    assert int(arrays_b.bvh.inst_active.sum()) == len(scene_b.instances)
    assert torch.equal(arrays_b.lights.spot_pos, arrays_a.lights.spot_pos)
