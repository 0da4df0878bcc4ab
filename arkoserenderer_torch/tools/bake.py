"""Asset bake tool on the port's modules: glTF -> baked .arkscene.npz (the
counterpart of the reference's tools/bake.py, with its CLI).

Imports a glTF or GLB (textures resized to ``--max-texture`` and mipped,
tangents generated) and writes one baked scene file that
``assets/baked.load_baked`` reads without parsing; ``--meshlets`` also
reports how many meshlets the segments split into. A host program: no JAX,
no device.

Usage:
    python -m arkoserenderer_torch.tools.bake input.gltf output.arkscene.npz \\
        [--max-texture 512] [--meshlets]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input", help="glTF/GLB file")
    ap.add_argument("output", help="baked .arkscene.npz path")
    ap.add_argument("--max-texture", type=int, default=512)
    ap.add_argument("--meshlets", action="store_true",
                    help="also report meshlet statistics")
    args = ap.parse_args(argv)

    from arkoserenderer_torch.assets.baked import save_baked
    from arkoserenderer_torch.assets.gltf import load_gltf
    from arkoserenderer_torch.scene.scene import Scene
    from arkoserenderer_torch.tools.cooker import baking_limits

    t0 = time.perf_counter()
    scene = Scene(limits=baking_limits())
    res = load_gltf(scene, args.input, max_texture_size=args.max_texture)
    if args.meshlets:
        from arkoserenderer_torch.assets.meshopt import build_meshlets

        total = sum(build_meshlets(seg.positions, seg.indices).count for seg in scene.segments)
        print(f"meshlets: {total}")
    save_baked(scene, args.output)
    print(f"baked {args.input} -> {args.output}: {res.instance_count} instances, "
          f"{len(scene.materials)} materials in {time.perf_counter() - t0:.2f}s")


if __name__ == "__main__":
    main()
