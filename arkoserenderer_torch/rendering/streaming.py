"""Budgeted geometry and material streaming (port of
arkoserenderer_tpu/rendering/streaming.py).

A ``StreamingManager`` moves tickets through PENDING -> UPLOADING -> LOADED
under a byte budget a frame. ``enqueue_instance`` and ``enqueue_material``
take the upload plans of ``Scene.stage_instance`` / ``stage_material``;
``enqueue_async`` runs a prepare function on a ``core/taskgraph`` worker
first (host work only: it touches no CUDA tensor). ``tick(arrays)``, once a
frame on the frame loop's thread, writes up to the budget of rows, in
chunks of at most ``chunk_rows``, into the pools in place: every pool
tensor keeps its shape and its storage. A ticket's ``tri_valid`` and
``inst_valid`` rows come last in its plan, so a partly written instance
never rasters; when a ticket's last row is in, its lights are written and,
if it wired a parked TLAS slot, one refit folds the slot into the BVH.

The reference moves each chunk through a fixed staging buffer with a
masked, clamped dynamic_update_slice and rolls the staging rows to realign
near the pool's end; the effect is ``pool[off:off + n] = rows[:n]``, which
is what the port writes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from arkoserenderer_torch.core.taskgraph import schedule_task
from arkoserenderer_torch.ops.bvh import refit_bvh_in_place
from arkoserenderer_torch.scene.scene import pool_of, write_lights, write_rows

CHUNK_ROWS = 65536        # rows a chunk, at most
PENDING = "pending"       # the host prepare has not finished
UPLOADING = "uploading"   # rows being written under the budget
LOADED = "loaded"


@dataclasses.dataclass
class _Upload:
    field: str
    offset: int
    rows: np.ndarray
    done: int = 0

    @property
    def remaining(self) -> int:
        return self.rows.shape[0] - self.done

    @property
    def row_bytes(self) -> int:
        return int(self.rows.nbytes // max(self.rows.shape[0], 1))


def _uploads(plan: dict) -> list[_Upload]:
    return [_Upload(f, o, np.ascontiguousarray(r)) for f, o, r in plan["uploads"]]


@dataclasses.dataclass
class StreamTicket:
    """One streamed instance or material moving through the states."""

    uploads: list
    lights: object = None
    instance_id: int = -1
    material_id: int = -1
    state: str = UPLOADING
    prepare: object = None   # the Future of an asynchronous prepare

    @property
    def bytes_total(self) -> int:
        return sum(u.rows.nbytes for u in self.uploads)

    @property
    def bytes_done(self) -> int:
        return sum(u.done * u.row_bytes for u in self.uploads)


class StreamingManager:
    """The per-frame upload pump: ``tick(arrays)`` once a frame writes up to
    ``budget_bytes`` of queued rows into ``arrays``' pools and returns
    ``arrays``."""

    def __init__(self, scene, budget_bytes: int = 4 << 20, chunk_rows: int = CHUNK_ROWS):
        self.scene = scene
        self.budget_bytes = budget_bytes
        self.chunk_rows = chunk_rows
        self.queue: list[StreamTicket] = []
        self.loaded: list[StreamTicket] = []
        self.bytes_uploaded_last_tick = 0

    def enqueue_instance(self, segment_id: int, world, lod_band=None) -> StreamTicket:
        """Stage an instance of an existing segment for budgeted upload."""
        kw = {} if lod_band is None else {"lod_band": lod_band}
        plan = self.scene.stage_instance(segment_id, world, **kw)
        t = StreamTicket(uploads=_uploads(plan), lights=plan["lights"],
                         instance_id=plan["instance_id"])
        self.queue.append(t)
        return t

    def enqueue_material(self, mat) -> StreamTicket:
        """Stage a new material's texture chain for budgeted upload: the
        texel rows first, its record last."""
        plan = self.scene.stage_material(mat)
        t = StreamTicket(uploads=_uploads(plan), material_id=plan["material_id"])
        self.queue.append(t)
        return t

    def enqueue_async(self, prepare_fn, *args) -> StreamTicket:
        """Run ``prepare_fn(*args)`` on a background worker, then stream
        its result: ``(segment_id, world)`` or a plan from
        ``Scene.stage_instance``."""
        t = StreamTicket(uploads=[], state=PENDING)
        t.prepare = schedule_task(prepare_fn, *args, background=True)
        self.queue.append(t)
        return t

    @property
    def pending(self) -> int:
        return len(self.queue)

    def tick(self, arrays):
        """Advance the queue under the byte budget, first ticket first; a
        prepare that has not finished stops the tick, so the frames' order
        of work stays deterministic. Returns ``arrays``."""
        budget = self.budget_bytes
        spent = 0
        while self.queue and budget > 0:
            t = self.queue[0]
            if t.state == PENDING:
                if not t.prepare.done():
                    break
                result = t.prepare.result()
                plan = result if isinstance(result, dict) else \
                    self.scene.stage_instance(result[0], result[1])
                t.uploads = _uploads(plan)
                t.lights = plan["lights"]
                t.instance_id = plan["instance_id"]
                t.state = UPLOADING
            for u in t.uploads:
                while u.remaining > 0 and budget > 0:
                    n = min(u.remaining, self.chunk_rows)
                    # A blocking copy from the ticket's own host rows, which
                    # live until the ticket is dropped: no staging buffer is
                    # reused under a copy that has not read it yet.
                    write_rows(pool_of(arrays, u.field), u.offset + u.done,
                               u.rows[u.done:u.done + n])
                    u.done += n
                    budget -= n * u.row_bytes
                    spent += n * u.row_bytes
                if u.remaining > 0:
                    break
            if all(u.remaining == 0 for u in t.uploads):
                # Activation: the lights fitted to the grown bounds, then one
                # refit when the ticket wired a TLAS slot.
                if t.lights is not None:
                    write_lights(arrays, t.lights)
                if any(u.field.startswith("bvh.") for u in t.uploads):
                    refit_bvh_in_place(arrays.bvh, arrays.positions, arrays.indices)
                t.state = LOADED
                self.loaded.append(self.queue.pop(0))
        self.bytes_uploaded_last_tick = spent
        return arrays
