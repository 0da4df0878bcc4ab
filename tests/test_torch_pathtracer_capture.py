"""The path tracer's captured sample (``PathTracer`` on the card replays a
CUDA graph of one sample) on the CPU, at 16x16, one bounce. The guard:
after one eager warm-up sample, the capture of a sample (through a
stand-in for torch's graph API whose capture runs the code eagerly and
whose replay does nothing) runs with every host read and upload patched to
raise (test_torch_capture.py's guard), so a graph can hold it: the sample
index, the key and the camera come from buffers. The captured code's
sample equals the eager tracer's bit for bit, the accumulation keeps its
storage, and one capture serves every sample.

(test_torch_pathtracer.py holds the in-place accumulation, the reset and
the checkpoint round trip against JAX's tracer.)
"""

import contextlib

import torch

from arkoserenderer_torch.assets import procedural as tproc
from arkoserenderer_torch.models import pathtracer as tpt
from test_torch_capture import _StandInGraph, _StandInStream, guarded

torch.set_num_threads(2)

RES = 16


def tracer(seed: int = 3):
    scene, cam = tproc.build_test_scene(viewport=(RES, RES), n_spheres=1)
    return tpt.PathTracer(scene, cam, RES, RES, max_bounces=1, seed=seed, device="cpu")


def test_captured_sample_reads_nothing_back(monkeypatch):
    t = tracer()
    t.render_sample(1)  # the eager warm-up: the device constants are made
    accum = t.accum.data_ptr()
    captures = []

    @contextlib.contextmanager
    def graph(g, pool=None):
        captures.append(g)
        with guarded(monkeypatch):
            yield

    monkeypatch.setattr(tpt.PathTracer, "captured", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", _StandInStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _StandInStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    t.render_sample(2)  # sample 1 captured (the stand-in runs it), sample 2 replayed
    assert len(captures) == 1 and t.sample_count == 3
    assert t.accum.data_ptr() == accum
    monkeypatch.undo()
    eager = tracer()
    eager.render_sample(2)  # samples 0 and 1: what the stand-in ran
    assert torch.equal(t.accum, eager.accum)
