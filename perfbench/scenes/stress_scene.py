"""The culling stress scene (``assets.procedural.build_stress_scene``): a
grid of ``n_instances`` cells over a floor, each a sphere with a two-level
LOD chain, animated inside the frame by ``make_stress_animator`` when the
traffic mix animates it (its clock offset drawn from the seed).
``animation`` hands the reference what the animation is made of: which
instances move, each one's phase (a cell's LOD levels share it) and the
clock's offset; the motion itself the reference works out."""

import numpy as np


def build(prog, params: dict, viewport: tuple[int, int], traffic):
    scene, camera = prog.procedural.build_stress_scene(
        n_instances=int(params["n_instances"]), viewport=viewport)
    kw = {}
    if traffic.anim_offset is not None:
        kw["scene_animator"] = traffic.animator(prog.procedural.make_stress_animator(scene))
    return scene, camera, kw


def animation(scene, traffic):
    if traffic.anim_offset is None:
        return None
    sids, _side, _spacing, phases = scene._stress
    ids = [i for i, it in enumerate(scene.instances) if it[0] in sids]
    ph = np.asarray(phases, np.float32)[(np.arange(len(ids)) // len(sids)) % len(phases)]
    return {"instances": ids, "phases": ph, "offset": int(traffic.anim_offset)}
