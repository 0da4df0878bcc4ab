"""The captured frame (``RenderPipeline.compile`` on the card): the whole
``frame_fn`` recorded in a ``torch.cuda.CUDAGraph`` and replayed, the
port's counterpart of the reference's jitted frame.

A graph reads and writes fixed addresses, so every input of the frame is a
buffer that each call fills before the replay:

  * the state's tensors: with ``donate_state`` the caller's own tensors,
    which the end of the graph overwrites with the frame's new values (the
    reference's donation); without, the graph's copies. The state's
    transient resources are not inputs (every frame recomputes them);
  * the scene's tensors: the caller's, as captured. A scene tensor the
    caller replaces by another of its layout is copied into the captured
    one, so a frame loop writes into the scene's tensors in place
    (``Scene.update_instance_transforms`` and ``Renderer.upload_animation``
    do) and nothing is copied;
  * the camera state, the frame index, the delta time and the passes'
    per-frame inputs (``RenderPass.frame_inputs``): the graph's buffers,
    copied into (a camera state the last call passed is not copied again).

The host's branches are a choice of graph: before each call every pass's
``host_step`` gives its branch from the state's host values, and each
tuple of branches has its own graph, so the reference's ``lax.cond`` of the
cached sun map becomes a steady frame's graph that holds no sun raster. A
graph is captured at the first call with its branches and its inputs'
layout, after a warm-up frame on a side stream (it builds the kernels, sets
their attributes, caches the traversal's occupancy query and makes the
device constants); the graphs of one compiled frame share one memory pool
and are replayed one at a time on one stream.

The kernels' launch counters are host counters their wrappers raise. A
replay calls no wrapper, so the launches recorded by the capture are added
at every replay, and the warm-up's and the capture's own are taken back
out: the counts are those of the frames rendered.

The outputs are the graph's buffers, which the next replay overwrites: a
caller that keeps a frame's image copies it.

Every graph writes the pipeline's frame record (``utils/profiling``) by
address: the timestamps before the first pass and after each pass and the
passes' counters are kernels of the graph, and the row is the frame index
(a graph input) modulo the ring's rows, chosen on the device. So each
replay leaves its frame's pass times and counts in the ring with nothing
read back.

The host's share of a call is three zones (spans while a profiler records,
and times in the frame's host row of the record):
``arkose.frame.capture`` (a capture, labelled with the parts of the key
that were new: ``new_parts``), ``arkose.frame.fill`` (the copies into the
graph's buffers), ``arkose.frame.replay`` (the replay, or the chain's).

A call with ``pass_events`` (a list) replays the frame as a chain of
graphs, one a pass (the prologue in the first pass's, the donation's copies
in the last's), with a CUDA event recorded between each two replays: the
per-pass table of the captured frame, the counterpart of the reference's
per-pass jitted programs. The chain is captured like the whole-frame graph
(for the same inputs and host branches, in the same memory pool) and fills
the same kind of buffers; its outputs equal the whole-frame graph's.
"""

from __future__ import annotations

import collections
import dataclasses
import warnings

import numpy as np
import torch

from arkoserenderer_torch.rendering.pipeline import tree_map_host
from arkoserenderer_torch.utils.profiling import zone

MAX_GRAPHS = 8  # graphs kept by one compiled frame; the least recently used goes
KEY_PARTS = ("state", "scene", "camera", "inputs", "chain", "branches")  # a graph's key


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor in it: dicts, tuples,
    lists, NamedTuples and dataclasses are rebuilt, other values kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def _children(tree):
    if isinstance(tree, dict):
        return tree.values()
    if isinstance(tree, (tuple, list)):
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return ()


def leaves(tree) -> list:
    """The tensors of ``tree``, in ``tree_map``'s order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for c in _children(tree) for t in leaves(c)]


def layout(tree):
    """A hashable description of ``tree``: its containers and keys, each
    tensor's shape, dtype and device, each numpy array's shape and dtype,
    and every other value (by identity where it cannot be hashed). Two
    trees of one layout fill the same graph."""
    if isinstance(tree, torch.Tensor):
        return ("T", tuple(tree.shape), tree.dtype, str(tree.device))
    if isinstance(tree, np.ndarray):
        return ("A", tree.shape, tree.dtype.str)
    if isinstance(tree, dict):
        return ("d", tuple((k, layout(v)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)) or (dataclasses.is_dataclass(tree)
                                           and not isinstance(tree, type)):
        return (type(tree), tuple(layout(c) for c in _children(tree)))
    try:
        hash(tree)
    except TypeError:
        return ("id", id(tree))
    return ("v", tree)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
                      and a.shape == b.shape and a.dtype == b.dtype and a.device == b.device)


def _fill(dst: list, src: list, always: bool = False) -> None:
    for d, s in zip(dst, src):
        if always or not _same(d, s):
            d.copy_(s)


def launch_counts() -> tuple:
    """The kernels' launch counters: (raster launches, by shape, traversal
    launches, by label, shading launches), read through their modules (a
    reloaded wrapper has its own)."""
    from arkoserenderer_torch.ops import bvh_cuda, packed_shading_cuda, raster_cuda

    r, t = raster_cuda.rasterize_tiles_cuda, bvh_cuda.trace_rays_cuda
    return (r.launches, collections.Counter(r.launches_by_shape), t.launches,
            collections.Counter(t.launches_by_label), packed_shading_cuda.shade_packed_cuda.launches)


def set_launch_counts(counts: tuple) -> None:
    from arkoserenderer_torch.ops import bvh_cuda, packed_shading_cuda, raster_cuda

    r, t = raster_cuda.rasterize_tiles_cuda, bvh_cuda.trace_rays_cuda
    r.launches = counts[0]
    r.launches_by_shape.clear()
    r.launches_by_shape.update(counts[1])
    t.launches = counts[2]
    t.launches_by_label.clear()
    t.launches_by_label.update(counts[3])
    packed_shading_cuda.shade_packed_cuda.launches = counts[4]


def add_launch_counts(delta: tuple) -> None:
    """Add a graph's launches (``launch_counts``' layout) to the counters."""
    from arkoserenderer_torch.ops import bvh_cuda, packed_shading_cuda, raster_cuda

    r, t = raster_cuda.rasterize_tiles_cuda, bvh_cuda.trace_rays_cuda
    r.launches += delta[0]
    r.launches_by_shape.update(delta[1])
    t.launches += delta[2]
    t.launches_by_label.update(delta[3])
    packed_shading_cuda.shade_packed_cuda.launches += delta[4]


def count_delta(after: tuple, before: tuple) -> tuple:
    """The launches between two ``launch_counts()`` readings."""
    return tuple(a - b for a, b in zip(after, before))


def copy_leaves(dst, src) -> None:
    """Copy each tensor of ``src`` into the tensor of ``dst`` at its place
    (two trees of one layout)."""
    _fill(leaves(dst), leaves(src), always=True)


def _has_tensor(value) -> bool:
    return bool(leaves(value))


@dataclasses.dataclass
class _Graph:
    graph: object          # the frame's CUDAGraph, or [(pass name, CUDAGraph)] of a chain
    state: dict            # the state's input buffers
    state_leaves: dict     # their tensors, by key
    scene_leaves: list     # the captured scene's tensors
    camera_leaves: list    # the camera buffers
    inputs: dict           # the per-frame input buffers, by resource
    frame_index: torch.Tensor
    delta_time: torch.Tensor
    out: dict              # the frame's outputs (the graph's buffers)
    launches: tuple        # the kernels' launches in one replay
    camera_seen: object = None
    scene_seen: object = None
    scene_seen_leaves: list | None = None


class CompiledFrame:
    """``RenderPipeline.compile(donate_state)``'s callable on the card:
    ``fn(state, scene, camera_state, frame_index, delta_time) -> state``.
    ``frame_index`` is a host int (a 0-d tensor is read on the host: the
    graph is chosen by it) and ``delta_time`` a float or a 0-d tensor."""

    def __init__(self, pipeline, donate_state: bool = True):
        self.pipeline = pipeline
        self.donate_state = bool(donate_state)
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0  # graphs captured so far
        self._pool = None

    def host_steps(self, host: dict, first_frame: bool) -> tuple[tuple, dict]:
        """Every pass's ``host_step`` in order: (the branches, the host
        values after the frame)."""
        running = dict(host)
        branches = []
        for p in self.pipeline.passes:
            branch, updates = p.host_step(running, first_frame)
            branches.append(branch)
            running.update(updates)
        return tuple(branches), running

    def __call__(self, state: dict, scene, camera_state, frame_index, delta_time=1 / 60,
                 pass_events: list | None = None) -> dict:
        """One frame. With ``pass_events`` (a list) the frame replays as the
        chain of per-pass graphs and each pass appends (name, start, end)
        CUDA events, as ``RenderPipeline.frame_fn`` appends its eager ones."""
        pipe = self.pipeline
        fi = int(frame_index)
        transient = set(pipe.registry.transient_names)
        host = {k: v for k, v in state.items() if k not in transient and not _has_tensor(v)}
        dev_state = {k: v for k, v in state.items() if k not in transient and k not in host}
        branches, host_out = self.host_steps(host, fi == 0)
        inputs = {k: v for k, v in pipe.frame_inputs(fi).items() if k not in dev_state}
        chain = pass_events is not None
        key = (layout(dev_state), layout(scene), layout(camera_state), layout(inputs), chain,
               branches)
        g = self.graphs.get(key)
        if g is None:
            with zone("arkose.frame.capture", frame=fi, detail=self.new_parts(key),
                      record=pipe.record):
                g = self._capture(key, dev_state, host, scene, camera_state, inputs, fi, chain)
        else:
            self.graphs.move_to_end(key)
        with zone("arkose.frame.fill", frame=fi, record=pipe.record):
            self._fill(g, dev_state, scene, camera_state, inputs, fi, delta_time)
        with zone("arkose.frame.replay", frame=fi, record=pipe.record):
            if chain:
                mark = torch.cuda.Event(enable_timing=True)
                mark.record()
                for name, graph in g.graph:
                    graph.replay()
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    pass_events.append((name, mark, end))
                    mark = end
            else:
                g.graph.replay()
        add_launch_counts(g.launches)
        return self._outputs(g, host_out)

    def new_parts(self, key: tuple) -> str:
        """Which parts of a graph's ``key`` (``KEY_PARTS``) no kept graph
        has: why a capture happens, e.g. "new branches"."""
        if not self.graphs:
            return "first graph"
        new = [name for k, name in enumerate(KEY_PARTS)
               if all(kept[k] != key[k] for kept in self.graphs)]
        return "new " + (",".join(new) if new else "combination")

    def _fill(self, g: _Graph, dev_state, scene, camera_state, inputs, fi, delta_time) -> None:
        for k, v in dev_state.items():
            _fill(g.state_leaves[k], leaves(v), always=not self.donate_state)
        if scene is not g.scene_seen:
            g.scene_seen, g.scene_seen_leaves = scene, leaves(scene)
        _fill(g.scene_leaves, g.scene_seen_leaves)
        if camera_state is not g.camera_seen:
            _fill(g.camera_leaves, leaves(camera_state), always=True)
            g.camera_seen = camera_state
        for k, v in inputs.items():
            for dst, src in zip(leaves(g.inputs[k]), v if isinstance(v, tuple) else (v,)):
                dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
        g.frame_index.fill_(fi)
        if isinstance(delta_time, torch.Tensor):
            g.delta_time.copy_(delta_time)
        else:
            g.delta_time.fill_(float(delta_time))

    def _outputs(self, g: _Graph, host_out: dict) -> dict:
        if self.donate_state:
            out = {**g.out, **g.state}
        else:
            out = {k: tree_map(torch.clone, v) for k, v in g.out.items()}
        out = {k: v for k, v in out.items() if _has_tensor(v)}
        out.update(host_out)
        return out

    def _donate(self, s_state: dict, out: dict) -> None:
        """Inside a capture: the frame's new persistent values copied into
        the donated state's buffers."""
        if self.donate_state:
            for k, v in s_state.items():
                if k in out and out[k] is not v:
                    _fill(leaves(v), leaves(out[k]))

    def _record(self, s_state, frame_state, scene, s_camera, s_fi, s_dt, first, chain):
        """Capture the frame: (its graph, or the chain [(pass, graph)]; the
        frame's outputs)."""
        pipe = self.pipeline
        if not chain:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool):
                out = pipe.frame_fn(frame_state, scene, s_camera, s_fi, s_dt, first_frame=first)
                self._donate(s_state, out)
            self._pool = self._pool or graph.pool()
            return graph, out
        steps, last = [], len(pipe._executes) - 1
        for i, (name, execute) in enumerate(pipe._executes):
            graph = torch.cuda.CUDAGraph()
            with warnings.catch_warnings(), torch.cuda.graph(graph, pool=self._pool):
                # A pass that launches nothing this branch (a cached map's
                # steady frame) is an empty graph, replayed as a no-op.
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                if i == 0:
                    out, ctx = pipe._prologue(frame_state, scene, s_camera, s_fi, s_dt, first)
                out.update(execute(out, ctx) or {})
                pipe.record.stamp(ctx.frame_index, i + 1)
                if i == last:
                    self._donate(s_state, out)
            self._pool = self._pool or graph.pool()
            steps.append((name, graph))
        return steps, out

    def _capture(self, key, dev_state, host, scene, camera_state, inputs, fi,
                 chain: bool = False) -> _Graph:
        pipe = self.pipeline
        dev = pipe.device
        s_state = dev_state if self.donate_state else tree_map(torch.clone, dev_state)
        s_inputs = {k: tree_map_host(v, dev) for k, v in inputs.items()}
        s_camera = tree_map(torch.clone, camera_state)
        s_fi = torch.zeros((), dtype=torch.int32, device=dev).fill_(fi)
        s_dt = torch.zeros((), dtype=torch.float32, device=dev)
        frame_state = {**s_state, **host, **s_inputs}
        first = fi == 0
        before = launch_counts()
        # The warm-up frame, eager on a side stream; its result is dropped.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            pipe.frame_fn(frame_state, scene, s_camera, s_fi, s_dt, first_frame=first)
        torch.cuda.current_stream(dev).wait_stream(side)
        at_capture = launch_counts()
        graph, out = self._record(s_state, frame_state, scene, s_camera, s_fi, s_dt, first,
                                  chain)
        after = launch_counts()
        set_launch_counts(before)
        g = _Graph(
            graph=graph, state=s_state,
            state_leaves={k: leaves(v) for k, v in s_state.items()},
            scene_leaves=leaves(scene), camera_leaves=leaves(s_camera), inputs=s_inputs,
            frame_index=s_fi, delta_time=s_dt, out=out,
            launches=count_delta(after, at_capture),
            scene_seen=scene, scene_seen_leaves=leaves(scene),
        )
        self.graphs[key] = g
        self.captures += 1
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        return g
