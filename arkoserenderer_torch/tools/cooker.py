"""Asset cooker: dependency-tracked offline asset baking on the port's
modules (the counterpart of the reference's tools/cooker.py, with its CLI,
rules format, cook database and tool kinds).

It reads a TOML rules file, expands each rule's input glob and runs the
rule's bake tool for every output that is out of date. A JSON database next
to the rules file (``.cook.db.json``) records, for each output, the content
hashes of the inputs it was made from (the source and the files the tool
found it reading, such as a glTF's buffers and images) and the tool
version, so an edit rebuilds exactly the outputs it affects. Independent
bakes run in parallel on the port's task graph (``core/taskgraph``). The
tools are host programs: no JAX, no device.

rules.toml:
    [[rule]]
    name = "bake scenes"
    tool = "gltf"              # gltf | image | bc7 | ies | hair | copy
    input = "models/*.gltf"    # glob, relative to the rules file
    output = "baked/{stem}.arkscene.npz"   # {stem} and {name} of the input
    max_texture = 512          # tool options (gltf: max_texture; bc7:
                               # quality, rdo_lambda)

Usage:
    python -m arkoserenderer_torch.tools.cooker rules.toml [--force] [--dry-run]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import struct
import time
from pathlib import Path

import numpy as np

TOOL_VERSION = 2  # bump to invalidate every cooked output


def _hash_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:24]


def baking_limits():
    """The pool sizes a baked scene is imported with."""
    from arkoserenderer_torch.core.types import SceneLimits

    return SceneLimits(max_vertices=1 << 20, max_indices=3 << 20, max_drawables=4096,
                       max_materials=1024, max_textures=512, texture_pool_texels=1 << 24)


# ---------------------------------------------------------------------------
# The bake tools. Each writes ``out`` from ``inp`` and returns the other
# input files it read, which the cooker adds to the output's record.


def _tool_gltf(inp: Path, out: Path, rule: dict) -> list[Path]:
    """glTF -> baked .arkscene.npz (``assets/baked.save_baked``)."""
    from arkoserenderer_torch.assets.baked import save_baked
    from arkoserenderer_torch.assets.gltf import load_gltf
    from arkoserenderer_torch.scene.scene import Scene

    scene = Scene(limits=baking_limits())
    load_gltf(scene, str(inp), max_texture_size=int(rule.get("max_texture", 512)))
    save_baked(scene, str(out))
    deps = sorted(inp.parent.glob("*.bin"))
    for ext in ("*.png", "*.jpg", "*.jpeg"):
        deps += sorted(inp.parent.glob(ext))
    return deps


def _tool_image(inp: Path, out: Path, rule: dict) -> list[Path]:
    """Image -> its mip chain as uint8 arrays ``mip0``, ``mip1``, ... in a
    compressed .npz."""
    from arkoserenderer_torch.ops.mattex import _mip_chain
    from arkoserenderer_torch.utils.imageio import load_image_rgba

    mips = _mip_chain(load_image_rgba(str(inp)).astype(np.float32))
    np.savez_compressed(out, **{f"mip{i}": m.astype(np.uint8) for i, m in enumerate(mips)})
    return []


def dds_bc7(blocks: np.ndarray, height: int, width: int) -> bytes:
    """A DX10 .dds file of BC7_UNORM ``blocks`` for a height x width image
    (both multiples of 4)."""
    pf = struct.pack("<II4sIIIII", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
    hdr = (b"DDS " + struct.pack("<7I", 124, 0x1007, height, width, 0, 0, 1)
           + b"\0" * 44 + pf + b"\0" * 20)
    dx10 = struct.pack("<5I", 98, 3, 0, 1, 0)  # DXGI_FORMAT_BC7_UNORM, 2D
    return hdr + dx10 + blocks.tobytes()


def _tool_bc7(inp: Path, out: Path, rule: dict) -> list[Path]:
    """Image -> BC7 .dds, zero-padded to whole 4x4 blocks. ``quality``:
    "fast" | "balanced" | "thorough"; ``rdo_lambda`` > 0 adds the
    rate-distortion pass."""
    from arkoserenderer_torch.assets.bc7 import compress_bc7
    from arkoserenderer_torch.utils.imageio import load_image_rgba

    img = load_image_rgba(str(inp))
    h = (img.shape[0] + 3) // 4 * 4
    w = (img.shape[1] + 3) // 4 * 4
    padded = np.zeros((h, w, 4), np.uint8)
    padded[: img.shape[0], : img.shape[1]] = img
    blocks = compress_bc7(padded, quality=rule.get("quality", "balanced"),
                          rdo_lambda=float(rule.get("rdo_lambda", 0.0)))
    out.write_bytes(dds_bc7(blocks, h, w))
    return []


def _tool_ies(inp: Path, out: Path, rule: dict) -> list[Path]:
    """IES photometric file -> its angular LUT (``lut``) in a .npz."""
    from arkoserenderer_torch.assets.external import IESProfile

    lut = IESProfile.parse(inp.read_text(errors="replace")).to_lut()
    np.savez_compressed(out, lut=np.asarray(lut, np.float32))
    return []


def _tool_hair(inp: Path, out: Path, rule: dict) -> list[Path]:
    """Cem Yuksel .hair file -> ``points`` and ``segments`` in a .npz."""
    from arkoserenderer_torch.assets.external import HairFile

    hf = HairFile.load(str(inp))
    np.savez_compressed(out, points=hf.points, segments=np.asarray(hf.segments, np.int64))
    return []


def _tool_copy(inp: Path, out: Path, rule: dict) -> list[Path]:
    out.write_bytes(inp.read_bytes())
    return []


TOOLS = {
    "gltf": _tool_gltf,
    "image": _tool_image,
    "bc7": _tool_bc7,
    "ies": _tool_ies,
    "hair": _tool_hair,
    "copy": _tool_copy,
}


# ---------------------------------------------------------------------------


class Cooker:
    """The rules of one rules file and its cook database."""

    def __init__(self, rules_path: Path):
        import tomllib

        rules_path = Path(rules_path)
        self.root = rules_path.parent
        self.rules = tomllib.loads(rules_path.read_text()).get("rule", [])
        self.db_path = self.root / ".cook.db.json"
        try:
            self.db = json.loads(self.db_path.read_text())
        except (OSError, json.JSONDecodeError):
            self.db = {}

    @staticmethod
    def _hashes(inputs: list[Path]) -> dict:
        return {str(p): _hash_file(p) for p in inputs if p.exists()}

    def _stale(self, out: Path, inputs: list[Path]) -> bool:
        rec = self.db.get(str(out))
        return (not out.exists() or rec is None or rec.get("tool_version") != TOOL_VERSION
                or rec.get("inputs", {}) != self._hashes(inputs))

    def plan(self):
        """Yields (rule, input path, output path, stale) for every input of
        every rule, in rule order and sorted input order."""
        for rule in self.rules:
            if rule["tool"] not in TOOLS:
                raise ValueError(f"unknown tool {rule['tool']!r}; one of {sorted(TOOLS)}")
            for inp in sorted(self.root.glob(rule["input"])):
                out = self.root / rule["output"].format(stem=inp.stem, name=inp.name)
                known = self.db.get(str(out), {}).get("inputs", {})
                deps = [inp] + [Path(p) for p in known if p != str(inp)]
                yield rule, inp, out, self._stale(out, deps)

    def cook(self, force: bool = False, dry_run: bool = False) -> dict:
        """Bake every stale output (every one with ``force``); ``dry_run``
        only lists them. Returns {"built": [...], "skipped": [...]} of
        output paths."""
        from arkoserenderer_torch.core.taskgraph import schedule_task, wait_for_completion

        built, skipped, futures = [], [], []
        for rule, inp, out, stale in self.plan():
            if not (stale or force):
                skipped.append(str(out))
                continue
            built.append(str(out))
            if dry_run:
                continue

            def job(rule=rule, inp=inp, out=out):
                out.parent.mkdir(parents=True, exist_ok=True)
                extra = TOOLS[rule["tool"]](inp, out, rule)
                return out, [inp] + list(extra)

            futures.append(schedule_task(job))
        wait_for_completion(futures)
        for f in futures:
            out, inputs = f.result()
            self.db[str(out)] = {"tool_version": TOOL_VERSION, "inputs": self._hashes(inputs)}
        if not dry_run:
            self.db_path.write_text(json.dumps(self.db, indent=1, sort_keys=True))
        return {"built": built, "skipped": skipped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("rules", help="rules.toml path")
    ap.add_argument("--force", action="store_true", help="rebuild everything")
    ap.add_argument("--dry-run", action="store_true", help="list what would be built")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    res = Cooker(Path(args.rules)).cook(force=args.force, dry_run=args.dry_run)
    print(f"cooked {len(res['built'])} asset(s), {len(res['skipped'])} "
          f"up-to-date in {time.perf_counter() - t0:.2f}s")
    for b in res["built"]:
        print(f"  built {b}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
