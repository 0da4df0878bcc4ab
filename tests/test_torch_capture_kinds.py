"""test_torch_capture.py's guard over the other captured frame kinds of the
port's bench, at 64^2: phase 5's forward slice (no TAA, no Bloom),
bindless, test_spot, forward_upscaled, rt_soft, stress, meshlet,
showcase, flagship, helmet and translucent, and the showcase app's
overlays (DebugDraw, DDGIProbeDebug, IconBillboards). Each runs frames
0-2 of its pipeline with tensor inputs while every host read and upload
raises (the kernels' plain versions excepted), after one unguarded
warm-up frame."""

import pytest

from test_torch_capture import FRAMES, guarded_frames

KINDS = ["forward_slice", "bindless", "test_spot", "forward_upscaled", "rt_soft", "stress",
         "meshlet", "showcase", "flagship", "helmet", "translucent", "overlays"]


@pytest.fixture(scope="module")
def module_patch():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module", params=KINDS)
def guard_run(request, module_patch):
    return request.param, guarded_frames(request.param, module_patch)


@pytest.mark.parametrize("frame", FRAMES)
def test_frame_reads_nothing_back(guard_run, frame):
    kind, out = guard_run
    assert frame in out, f"{kind}: an earlier frame failed"
    assert out[frame] is None, f"{kind} frame {frame}: {out[frame]}"
