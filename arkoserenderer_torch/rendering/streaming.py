"""Budgeted geometry and material streaming (port of
arkoserenderer_tpu/rendering/streaming.py).

A ``StreamingManager`` moves tickets through PENDING -> UPLOADING -> LOADED
under a byte budget a frame. ``enqueue_instance`` and ``enqueue_material``
take the upload plans of ``Scene.stage_instance`` / ``stage_material``;
``enqueue_async`` runs a prepare function on a ``core/taskgraph`` worker
first (host work only: it touches no CUDA tensor). ``tick(arrays)``, once a
frame on the frame loop's thread, writes up to the budget of rows, in
chunks of at most ``chunk_rows``, into the pools in place: every pool
tensor keeps its shape and its storage, so a captured frame
(``RenderPipeline.compile``) replayed after a tick reads the new rows. A
ticket's ``tri_valid`` and ``inst_valid`` rows come last in its plan, so a
partly written instance never rasters; when a ticket's last row is in, its
lights are written and, if it wired a parked TLAS slot, one refit folds
the slot into the BVH.

The rows go through staging chunks, the reference's UploadBuffer: a chunk
holds ``chunk_rows`` rows of one dtype and row shape in host memory
(pinned for a pool on the card). A tick packs its chunks' rows into them
one after the other and copies each chunk's rows into
``pool[off:off + n]`` with ``non_blocking`` copies on the current stream
(the stream that replays the frame), then records an event on each chunk
it used. A chunk is refilled only once its event has completed: a tick
takes a chunk whose copies are done, else makes another (up to
STAGING_CHUNKS of a kind), else waits for the oldest. The reference's
masked, clamped dynamic_update_slice with its rolled staging rows near the
pool's end has the same effect, ``pool[off:off + n] = rows[:n]``.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from arkoserenderer_torch.core.taskgraph import schedule_task
from arkoserenderer_torch.ops.bvh import refit_bvh_in_place
from arkoserenderer_torch.scene.scene import host_rows, pool_of

CHUNK_ROWS = 65536        # rows a chunk, at most
STAGING_CHUNKS = 4        # staging chunks of one dtype and row shape, at most
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


def _record_event(device: torch.device):
    """An event recorded on ``device``'s current stream (None off the card,
    where a copy has finished when it returns)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class _Staging:
    """One staging chunk: ``rows`` rows of one dtype and row shape on the
    host, the rows the current tick has put in it, and the event recorded
    after the tick's copies out of it."""

    def __init__(self, rows: int, row_shape: tuple, dtype: torch.dtype, pinned: bool):
        self.host = torch.empty((rows, *row_shape), dtype=dtype, pin_memory=pinned)
        self.used = 0
        self.event = None

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def fill(self, src: torch.Tensor) -> torch.Tensor:
        """Put ``src``'s rows after those already in; returns their view."""
        n = src.shape[0]
        view = self.host[self.used:self.used + n]
        view.copy_(src)
        self.used += n
        return view


class _StagingChunks:
    """The staging chunks of each (dtype, row shape, device), oldest event
    first, and those the current tick is filling."""

    def __init__(self, chunk_rows: int):
        self.chunk_rows = chunk_rows
        self.chunks: dict = collections.defaultdict(list)
        self.filling: dict = {}

    def take(self, pool: torch.Tensor, n: int) -> _Staging:
        """A chunk of ``pool``'s kind with room for ``n`` more rows."""
        key = (pool.dtype, tuple(pool.shape[1:]), pool.device)
        st = self.filling.get(key)
        if st is not None and st.used + n <= self.chunk_rows:
            return st
        if st is not None:  # full: its copies go on, its event is recorded now
            self._close(key)
        ring = self.chunks[key]
        st = next((c for c in ring if c.done()), None)
        if st is None and len(ring) < STAGING_CHUNKS:
            st = _Staging(self.chunk_rows, key[1], pool.dtype, pool.device.type == "cuda")
        elif st is None:
            st = ring[0]
            st.event.synchronize()
        if st in ring:
            ring.remove(st)
        ring.append(st)
        st.used = 0
        self.filling[key] = st
        return st

    def _close(self, key) -> None:
        self.filling.pop(key).event = _record_event(key[2])

    def end_tick(self) -> None:
        """Record the event of every chunk this tick filled."""
        for key in list(self.filling):
            self._close(key)


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
        self.staging = _StagingChunks(chunk_rows)

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
                    self._write(pool_of(arrays, u.field), u.offset + u.done,
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
                    for k, v in t.lights.items():
                        dst = getattr(arrays.lights, k).view(-1)
                        self._write(dst, 0, np.asarray(v).reshape(-1))
                if any(u.field.startswith("bvh.") for u in t.uploads):
                    refit_bvh_in_place(arrays.bvh, arrays.positions, arrays.indices)
                t.state = LOADED
                self.loaded.append(self.queue.pop(0))
        self.staging.end_tick()
        self.bytes_uploaded_last_tick = spent
        return arrays

    def _write(self, pool: torch.Tensor, offset: int, rows: np.ndarray) -> None:
        """``pool[offset:offset + len(rows)] = rows`` through staging
        chunks, the copies queued on the current stream."""
        src = host_rows(pool, offset, rows)
        for i in range(0, src.shape[0], self.chunk_rows):
            part = src[i:i + self.chunk_rows]
            view = self.staging.take(pool, part.shape[0]).fill(part)
            pool[offset + i:offset + i + part.shape[0]].copy_(view, non_blocking=True)
