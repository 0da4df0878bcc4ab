"""The compiled frame (``RenderPipeline.compile``) on the CPU, at 64^2.

CUDA graphs exist only on the card, where ``chip_smoke.py`` phase 22 holds
every captured kind to its eager frames bit for bit. Here:

(a) the guard: a frame reads nothing back and uploads nothing, so a graph
    can hold it. ``frame_fn`` runs frames 0-2 with tensor inputs (the frame
    index, the delta time and the per-frame inputs as tensors, ``first_frame``
    given) while ``Tensor.item``, ``__bool__``, ``__int__``, ``__float__``,
    ``__index__``, ``tolist``, ``numpy``, ``cpu``, ``to`` a host device,
    ``new_tensor``, ``nonzero``, indexing by a mask or a list (a sync or a
    hidden upload on the card), ``torch.from_numpy``, ``torch.tensor``,
    ``torch.as_tensor`` of host data, ``torch.nonzero`` and their kin raise.
    The kernels' plain versions (``rasterize_tiles_plain``,
    ``trace_wide_plain``) stand in for the kernels on the CPU and may read:
    on the card the kernels run and read nothing. One warm-up frame runs
    first, unguarded, as ``compile()`` runs one before a capture: it makes
    the device constants (``core/constants.py``). The forward, full_post, rt
    and ddgi pipelines here; the other captured kinds in
    test_torch_capture_kinds.py.
(b) ``compile()``'s callable (on the CPU ``frame_fn`` itself) with the
    state fed forward over frames 0-2 against the JAX package's
    ``render_frame`` (its jitted frame) on the same inputs, for the forward
    (TAA's first-frame reset, the cached sun map) and rt frames (the soft
    and reflection denoisers' resets), within tests/test_torch_forward.py's
    bound on the TAA frame.
(c) ``rendering/capture.CompiledFrame``'s bookkeeping, through a stand-in
    for torch's graph API whose capture runs the frame (on the CPU) and
    whose replay does nothing: donation, the cache by ``donate_state``, the
    graphs by the host's branch, and the chain of per-pass graphs that
    ``pass_events`` replays.
(d) ``sample_blue_noise`` with a tensor frame index equals the host int's,
    bit for bit, for frames 0-1000.
"""

import contextlib

import numpy as np
import pytest
import torch

from arkoserenderer_torch import bridge
from arkoserenderer_torch.core.types import RasterConfig as TRasterConfig
from arkoserenderer_torch.ops import bvh as tbvh
from arkoserenderer_torch.ops import raster as traster
from arkoserenderer_torch.ops.noise import sample_blue_noise
from arkoserenderer_torch.rendering import capture
from arkoserenderer_torch.rendering.pipeline import PipelineConfig as TPipelineConfig
from arkoserenderer_torch.rendering.pipeline import tree_map_host

torch.set_num_threads(2)

RES = 64
RASTER = dict(tile_h=8, tile_w=16, max_tris_per_tile=256)
FRAMES = (0, 1, 2)


def small_cfg():
    return TPipelineConfig(width=RES, height=RES, shadow_map_size=128,
                           raster=TRasterConfig(**RASTER))


def _host_read(*args, **kwargs):
    raise AssertionError("a frame read the device back or uploaded host data")


@contextlib.contextmanager
def guarded(monkeypatch):
    """Within it every host read and upload of a tensor raises, except in
    the kernels' plain versions."""
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def restore():
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)

    get, put, to, as_tensor = (torch.Tensor.__getitem__, torch.Tensor.__setitem__,
                               torch.Tensor.to, torch.as_tensor)

    def checked(idx):
        for it in idx if isinstance(idx, tuple) else (idx,):
            if isinstance(it, list) or (isinstance(it, torch.Tensor) and it.dtype == torch.bool):
                _host_read()

    def getitem(self, idx):
        checked(idx)
        return get(self, idx)

    def setitem(self, idx, value):
        checked(idx)
        return put(self, idx, value)

    def to_device(self, *args, **kwargs):
        for a in (*args, *kwargs.values()):
            if isinstance(a, (str, torch.device)) and torch.device(a).type == "cpu":
                _host_read()
        return to(self, *args, **kwargs)

    def as_device_tensor(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            _host_read()
        return as_tensor(data, *args, **kwargs)

    def unguarded(fn):
        def run(*args, **kwargs):
            current = [(owner, name, getattr(owner, name)) for owner, name, _ in saved]
            restore()
            try:
                return fn(*args, **kwargs)
            finally:
                for owner, name, value in current:
                    setattr(owner, name, value)
        return run

    monkeypatch.setattr(traster, "rasterize_tiles_plain", unguarded(traster.rasterize_tiles_plain))
    monkeypatch.setattr(tbvh, "trace_wide_plain", unguarded(tbvh.trace_wide_plain))
    for name in ("item", "__bool__", "__int__", "__float__", "__index__", "tolist", "numpy",
                 "cpu", "new_tensor", "nonzero"):
        patch(torch.Tensor, name, _host_read)
    patch(torch.Tensor, "__getitem__", getitem)
    patch(torch.Tensor, "__setitem__", setitem)
    patch(torch.Tensor, "to", to_device)
    patch(torch, "as_tensor", as_device_tensor)
    for name in ("from_numpy", "tensor", "nonzero", "masked_select", "unique", "bincount"):
        patch(torch, name, _host_read)
    try:
        yield
    finally:
        restore()


def frame_inputs(renderer, frame: int) -> dict:
    """The persistent state a Renderer passes its pipeline, with the host's
    scene version and the frame's per-frame inputs on the CPU."""
    pipe = renderer.pipeline
    state = {k: renderer.state[k] for k in pipe.registry.persistent_names if k in renderer.state}
    if "scene.version" in state:
        state["scene.version"] = renderer._scene_version
    state.update({k: tree_map_host(v, "cpu") for k, v in pipe.frame_inputs(frame).items()})
    return state


def small_renderer(kind: str):
    """The CPU Renderer of a bench kind at 64^2, of phase 5's forward slice
    (no TAA, no Bloom), or of the showcase app's overlays (``--debug-draw
    --light-icons --ddgi --ddgi-probe-debug``, its lines drawn)."""
    from arkoserenderer_torch.models.standard import Renderer
    from arkoserenderer_torch.tools import bench

    if kind == "overlays":
        from arkoserenderer_torch.apps import showcase

        args = showcase.build_arg_parser().parse_args(
            ["--width", str(RES), "--height", str(RES), "--debug-draw", "--light-icons",
             "--ddgi", "--ddgi-probe-debug"])
        return showcase.make_renderer(args, *showcase.build_scene(args), "cpu")
    if kind == "forward_slice":
        scene, cam, cfg, kw = bench.build_scene("forward", small=True, cfg=small_cfg())
        kw = dict(kw, taa=False, bloom=False)
    else:
        scene, cam, cfg, kw = bench.build_scene(kind, small=True, cfg=small_cfg())
    return Renderer(scene, cam, cfg, device="cpu", **kw)


def guarded_frames(kind: str, monkeypatch) -> dict:
    """Frames 0-2 of ``kind``'s pipeline (``small_renderer``) under the
    guard, after one unguarded warm-up frame: {frame: None, or the error it
    raised}."""
    r = small_renderer(kind)
    cam = r.camera
    pipe = r.pipeline
    assert not pipe.capture_blockers
    pipe.frame_fn(frame_inputs(r, 0), r.scene_arrays, cam.state(0, "cpu"), 0)
    out = {}
    for frame in FRAMES:
        state = frame_inputs(r, frame)
        cs = cam.state(frame, "cpu")
        fi = torch.full((), frame, dtype=torch.int32)
        dt = torch.full((), 1 / 60, dtype=torch.float32)
        try:
            with guarded(monkeypatch):
                new = pipe.frame_fn(state, r.scene_arrays, cs, fi, dt, first_frame=frame == 0)
        except AssertionError as e:
            out[frame] = e
            break
        out[frame] = None
        r.state = new
        cam.post_render()
        cam.position = cam.position + np.array([0.05, 0.0, 0.0], np.float32)
    else:
        assert bool(torch.isfinite(r.state.get("LDRDisplay", r.state["LDR"])).all())
    return out


@pytest.fixture(scope="module")
def module_patch():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module", params=["forward", "full_post", "rt", "ddgi"])
def guard_run(request, module_patch):
    return request.param, guarded_frames(request.param, module_patch)


@pytest.mark.parametrize("frame", FRAMES)
def test_frame_reads_nothing_back(guard_run, frame):
    kind, out = guard_run
    assert frame in out, f"{kind}: an earlier frame failed"
    assert out[frame] is None, f"{kind} frame {frame}: {out[frame]}"


# ---------------------------------------------------------------------------
# (b) compile()'s callable against JAX's render_frame


def jax_and_port(kind: str):
    """Frames 0-2 of the forward (TAA, Bloom, the cached sun) or rt frame
    at 64^2, the camera moving: JAX's Renderer (its jitted frame) and the
    port's ``compile()`` callable on the same scene arrays and camera
    states, the port's state fed forward. Returns {frame: (port state, JAX
    state)}."""
    import arkoserenderer_torch.assets.procedural as tproc
    import arkoserenderer_torch.scene.lights as tlights
    import arkoserenderer_tpu.assets.procedural as jproc
    import arkoserenderer_tpu.scene.lights as jlights
    from arkoserenderer_tpu.core.types import RasterConfig as JRasterConfig
    from arkoserenderer_tpu.models.standard import Renderer as JRenderer
    from arkoserenderer_tpu.rendering.pipeline import PipelineConfig as JPipelineConfig
    from arkoserenderer_torch.models.standard import make_forward_pipeline
    from test_torch_bvh import rt_scene

    sizes = dict(width=RES, height=RES, shadow_map_size=128, local_shadow_map_size=128)
    if kind == "rt":
        jscene, jcam = rt_scene(jproc, jlights, res=RES)
        tscene, _ = rt_scene(tproc, tlights, res=RES)
        kw = dict(rt_shadows=True, rt_reflections=True)
    else:
        jscene, jcam = jproc.build_test_scene(viewport=(RES, RES))
        tscene, _ = tproc.build_test_scene(viewport=(RES, RES))
        kw = {}
    jr = JRenderer(jscene, jcam, JPipelineConfig(raster=JRasterConfig(**RASTER), **sizes), **kw)
    tcfg = TPipelineConfig(raster=TRasterConfig(**RASTER), scene=tscene.static_info(), **sizes)
    pipe = make_forward_pipeline(tcfg, device="cpu", **kw)
    assert [p.name for p in pipe.passes] == [p.name for p in jr.pipeline.passes]
    fn = pipe.compile()
    assert fn == pipe.frame_fn  # the CPU has no CUDA graphs
    tsa = bridge.scene_arrays_from_numpy(jr.scene_arrays._asdict(), "cpu")
    persistent = pipe.registry.persistent_names
    state = pipe.initial_state()
    if "scene.version" in state:
        state["scene.version"] = 0  # the host's scene version, as a Renderer keeps it
    out = {}
    for frame in FRAMES:
        jcam.position = jcam.position + np.array([0.15 * frame, 0.0, 0.0], np.float32)
        tcs = bridge.camera_state_from_numpy(jcam.state(frame)._asdict(), "cpu")
        jr.render_frame()
        new = fn({k: state[k] for k in persistent}, tsa, tcs, frame, 1 / 60)
        out[frame] = ({k: v.clone() if isinstance(v, torch.Tensor) else v
                       for k, v in new.items()},
                      {k: np.array(v) for k, v in jr.state.items() if hasattr(v, "shape")})
        state = new
    return out


@pytest.fixture(scope="module", params=["forward", "rt"])
def compiled_walk(request):
    return request.param, jax_and_port(request.param)


@pytest.mark.parametrize("frame", FRAMES)
def test_compiled_frame_matches_jax(compiled_walk, frame):
    """tests/test_torch_forward.py's bound on the TAA frame (the LDR within
    2e-4 on all but 0.2 % of values, their means within 1e-5, TAA's history
    within 1e-3 on all but 0.2 %); the cached sun map within 1e-6 and, after
    frame 0, the map of frame 0; the reflection denoiser's history (rt)
    within 1e-4 on all but 0.2 %."""
    kind, walk = compiled_walk
    ours, ref = walk[frame]
    ldr = ours["LDR"].numpy()
    diff = np.abs(ldr - ref["LDR"])
    assert (diff > 2e-4).mean() < 0.002, (diff > 2e-4).mean()
    assert abs(ldr.mean() - ref["LDR"].mean()) < 1e-5
    hist = np.abs(ours["TAAHistory"].numpy() - ref["TAAHistory"])
    assert (hist > 1e-3).mean() < 0.002
    if kind == "forward":
        sun = ours["ShadowMap.sun"].numpy()
        np.testing.assert_allclose(sun, ref["ShadowMap.sun"], atol=1e-6, rtol=0)
        assert ours["SunShadow.version"] == ours["scene.version"] == 0
        if frame > 0:
            assert np.array_equal(sun, walk[0][0]["ShadowMap.sun"].numpy())  # cached
    else:
        refl = np.abs(ours["RTRefl.history"].numpy() - ref["RTRefl.history"])
        assert (refl > 1e-4).mean() < 0.002, (refl > 1e-4).mean()
        counts = ours["RTRefl.moments"].numpy()[..., 2]
        assert counts.max() == frame + 1.0  # reset on frame 0, accumulating since


# ---------------------------------------------------------------------------
# (c) CompiledFrame's bookkeeping through a stand-in graph API


class _StandInGraph:
    def pool(self):
        return "pool"

    def replay(self):
        pass


class _StandInStream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """torch's graph API on the CPU: a capture runs the frame's code eagerly
    (so the graph's buffers hold that frame) and a replay does nothing."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", _StandInStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _StandInStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())


def forward_renderer():
    from arkoserenderer_torch.tools import bench

    return bench.build_renderer("forward", small=True, device="cpu", cfg=small_cfg())


def test_donation_and_the_cache_by_donate_state(stand_in_graphs):
    r = forward_renderer()
    pipe = r.pipeline
    state = frame_inputs(r, 0)
    clear = {k: v.clone() for k, v in state.items() if isinstance(v, torch.Tensor)}
    cs = r.camera.state(0, "cpu")

    kept = capture.CompiledFrame(pipe, donate_state=False)(state, r.scene_arrays, cs, 0)
    for k, v in clear.items():
        assert torch.equal(state[k], v), k  # the caller's state untouched
    assert kept["TAAHistory"] is not state["TAAHistory"]
    assert float(kept["TAAHistory"].abs().max()) > 0.0

    donated = capture.CompiledFrame(pipe, donate_state=True)(state, r.scene_arrays, cs, 0)
    assert donated["TAAHistory"] is state["TAAHistory"]  # the caller's buffer ...
    assert torch.equal(state["TAAHistory"], kept["TAAHistory"])  # ... holds the new frame
    assert donated["SunShadow.version"] == donated["scene.version"] == r._scene_version

    # compile()'s cache is keyed by donate_state, as the reference's.
    cpu, card = pipe.device, torch.device("cuda")
    pipe.device = card  # compile() does no CUDA work before a call
    a, b = pipe.compile(), pipe.compile(donate_state=False)
    assert a is pipe.compile(donate_state=True) and b is pipe.compile(donate_state=False)
    assert a is not b and a.donate_state and not b.donate_state
    pipe.device = cpu
    pipe.construct_all()
    pipe.device = card
    assert pipe.compile() is not a  # a new construct drops the captured frames
    pipe.device = cpu


def test_a_graph_for_each_host_branch(stand_in_graphs):
    """The cached sun map: frame 0 and a bumped scene version take the
    rendering graph, steady frames the other; each is captured once."""
    r = forward_renderer()
    fn = capture.CompiledFrame(r.pipeline)
    state = frame_inputs(r, 0)
    for frame, version in ((0, 0), (1, 0), (2, 0), (3, 1), (4, 1)):
        state["scene.version"] = version
        state = fn(state, r.scene_arrays, r.camera.state(frame, "cpu"), frame)
        assert state["SunShadow.version"] == version
        state = {k: state[k] for k in r.pipeline.registry.persistent_names}
    assert fn.captures == 2
    names = [p.name for p in r.pipeline.passes]
    want = [tuple(dirty if n == "SunShadow" else None for n in names) for dirty in (False, True)]
    assert sorted(key[-1] for key in fn.graphs) == want


class _StandInEvent:
    def __init__(self, **kwargs):
        pass

    def record(self):
        pass


def test_per_pass_chain(stand_in_graphs, monkeypatch):
    """With ``pass_events`` the frame is captured as a chain of graphs, one
    a pass in pipeline order, each appending (name, start, end) with one
    event between each two passes; its outputs (and, donated, the state it
    writes) equal the whole-frame graph's on the same inputs."""
    monkeypatch.setattr(torch.cuda, "Event", _StandInEvent)
    r = forward_renderer()
    cs = r.camera.state(0, "cpu")
    whole = capture.CompiledFrame(r.pipeline, donate_state=False)(
        frame_inputs(r, 0), r.scene_arrays, cs, 0)
    fn = capture.CompiledFrame(r.pipeline, donate_state=True)
    state = frame_inputs(r, 0)
    events = []
    chained = fn(state, r.scene_arrays, cs, 0, pass_events=events)
    names = [p.name for p in r.pipeline.passes]
    assert [name for name, _, _ in events] == names
    assert all(a[2] is b[1] for a, b in zip(events, events[1:]))
    (g,) = fn.graphs.values()
    assert [name for name, _ in g.graph] == names and fn.captures == 1
    for k, v in whole.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(chained[k], v), k
    assert torch.equal(state["TAAHistory"], whole["TAAHistory"])  # donated in the last graph
    fn(state, r.scene_arrays, cs, 1)  # the whole-frame graph is another entry
    assert fn.captures == 2


# ---------------------------------------------------------------------------
# (d) blue noise on the device's frame index


def test_blue_noise_tensor_frame_index_is_bit_exact():
    ys, xs = np.mgrid[0:16, 0:16]
    px = torch.from_numpy((xs * 37).ravel().astype(np.int32))
    py = torch.from_numpy((ys * 11).ravel().astype(np.int32))
    for salt in (0, 1, 2, 13, 14, 41):
        for frame in range(1001):
            host = sample_blue_noise(px, py, frame, salt)
            device = sample_blue_noise(px, py, torch.full((), frame, dtype=torch.int32), salt)
            assert torch.equal(host, device), (salt, frame)
