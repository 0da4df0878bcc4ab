"""arkbake on the port's modules: re-serialise an .ark* asset in the Binary
storage flavour (the counterpart of the reference's tools/arkbake.py, with
its CLI).

Loads an asset of any supported type in either storage flavour (cereal
JSON or Binary, told apart by the file's magic) and writes it back as
AssetStorage::Binary, the compact flavour shipped assets use.

Usage:
    python -m arkoserenderer_torch.tools.arkbake <SourceArkFile> <TargetArkFile>

Supported: .arkmsh .arkmat .arklvl .arkskel .arkanim .arkset .arkhair
"""

from __future__ import annotations

import sys
from pathlib import Path

from arkoserenderer_torch.assets import cereal_binary as cb
from arkoserenderer_torch.assets.ark import read_ark_document

# extension -> the JSON document's top-level key (e.g. "mesh" for .arkmsh)
_KEYS = {ext: cb.MAGICS[m][0] for ext, m in cb._EXT_TO_MAGIC.items()}


def main(argv: list[str]) -> int:
    """``argv`` as ``sys.argv``: [program, source, target]. Returns the
    exit code (1 with a message on stderr for a wrong call)."""
    if len(argv) != 3:
        print("arkbake: must be called as\n"
              "> python -m arkoserenderer_torch.tools.arkbake <SourceArkFile> <TargetArkFile>",
              file=sys.stderr)
        return 1
    src, dst = Path(argv[1]), Path(argv[2])
    ext = src.suffix
    if ext not in _KEYS:
        print(f"arkbake: unknown arkose asset type '{ext}'", file=sys.stderr)
        return 1
    if dst.suffix != ext:
        print(f"arkbake: source/target extension mismatch ({ext} vs {dst.suffix})",
              file=sys.stderr)
        return 1
    cb.write_ark_binary(dst, read_ark_document(src, _KEYS[ext]))
    print(f"arkbake: wrote binary {dst} ({dst.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
