"""DDGI pass (port of arkoserenderer_tpu/rendering/passes/ddgi.py): each
frame updates ``probes_per_frame`` probes round-robin by tracing their rays
through the scene's BVH (the frame's refitted one after a BVHRefitPass)
and blending the octahedral atlases with
hysteresis (``ops/ddgi.update_probes``).

The frame's four rotation normals (``core/prng.ddgi_rotation_normals``,
numpy threefry on the host) are a per-frame input, DDGI.rotation: the
pass's ``frame_inputs`` draws them for the frame index and the frame
reads them from the device, so a captured frame copies 16 bytes in before
each replay and keeps the host draw's bits (the reference draws them in
its program with ``jax.random``). A state without them (a caller of the
execute alone) draws them from the frame index on the host.

The atlases are persistent frame state: DDGI.irradiance (cleared to 0),
DDGI.visibility (cleared to ``max_distance`` in both channels, as the
reference's registry clears it, not to ``init_state``'s (d, d^2)) and
DDGI.offsets. The update's bounce term samples the atlases from before
this frame's update; RTReflections and LightingCompose, later in the
frame, sample the updated ones.
"""

from __future__ import annotations

import torch

from arkoserenderer_torch.core.prng import ddgi_rotation_normals
from arkoserenderer_torch.ops import ddgi as ddgi_ops
from arkoserenderer_torch.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer_torch.rendering.registry import Registry

STATE_KEYS = ("DDGI.irradiance", "DDGI.visibility", "DDGI.offsets")
ROTATION = "DDGI.rotation"


def ddgi_state(state: dict) -> ddgi_ops.DDGIState:
    """The DDGI atlases of a frame state."""
    return ddgi_ops.DDGIState(*(state[k] for k in STATE_KEYS))


class DDGIPass(RenderPass):
    name = "DDGI"

    def __init__(self, grid: ddgi_ops.ProbeGridConfig):
        self.grid = grid

    def construct(self, cfg: PipelineConfig, reg: Registry, device: torch.device):
        grid = self.grid
        p = grid.num_probes
        ir, vr = ddgi_ops.IRRADIANCE_RES, ddgi_ops.VISIBILITY_RES
        reg.create("DDGI.irradiance", (p, ir, ir, 3), torch.float32, persistent=True)
        reg.create("DDGI.visibility", (p, vr, vr, 2), torch.float32, persistent=True,
                   clear=float(grid.max_distance))
        reg.create("DDGI.offsets", (p, 3), torch.float32, persistent=True)
        # rt.py imports this module, so its helpers are imported here.
        from arkoserenderer_torch.rendering.passes.rt import scene_with_live_bvh, uses_live_bvh

        uses_live_bvh(reg)
        reg.publish(ROTATION)  # the host's input of each frame (frame_inputs)
        st = cfg.scene

        def execute(state: dict, ctx: FrameContext) -> dict:
            new = ddgi_ops.update_probes(
                scene_with_live_bvh(state, ctx), ddgi_state(state), grid, ctx.frame_index,
                ctx.camera.exposure,
                n_spots=st.n_spots, n_points=st.n_points,
                spot_casters=st.spot_shadow_casters, point_casters=st.point_shadow_casters,
                rotation=state.get(ROTATION),
            )
            return dict(zip(STATE_KEYS, new))

        return execute

    def frame_inputs(self, frame_index: int) -> dict:
        return {ROTATION: ddgi_rotation_normals(frame_index)}
