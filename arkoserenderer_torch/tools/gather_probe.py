"""How long torch takes to gather image rows by their width, on the card.

``flat[idx]`` over the 2,073,600 rows of a 1920x1080 image, for rows of 1 to
8 float32, in raster order and at shuffled indices, beside ``depth_of_field``
(24 taps) and ``motion_blur`` (8 taps) at that size. Rows of 16 bytes (and
32) go to another gather kernel of torch's than the other widths, which is
why ``ops.image.bilinear_sample_many`` fetches images apart instead of
concatenated to 4 channels.

    python -m arkoserenderer_torch.tools.gather_probe

Prints the card line and one JSON line. Needs a GPU.
"""

from __future__ import annotations

import json

import torch

from arkoserenderer_torch.ops import postprocess as pp
from arkoserenderer_torch.tools.raster_bench import card_line, events_ms

H, W = 1080, 1920


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gather_probe: torch.cuda.is_available() is False; this needs a GPU")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = H * W
    order = torch.arange(n, device=dev)
    shuffled = torch.randperm(n, device=dev, generator=gen)
    out = {"rows": n, "gather_ms": {}, "gather_shuffled_ms": {}}
    for c in range(1, 9):
        flat = torch.rand(n, c, device=dev, generator=gen)
        out["gather_ms"][c] = events_ms(lambda: flat[order], 20)
        out["gather_shuffled_ms"][c] = events_ms(lambda: flat[shuffled], 20)
    color = torch.rand(H, W, 3, device=dev, generator=gen)
    coc = (torch.rand(H, W, device=dev, generator=gen) * 2 - 1) * 2
    coc[:300] = 16.0  # a sky band at the largest circle of confusion
    vel = torch.randn(H, W, 2, device=dev, generator=gen) * 3
    out["depth_of_field_24_taps_ms"] = events_ms(lambda: pp.depth_of_field(color, coc, 24), 5)
    out["motion_blur_8_taps_ms"] = events_ms(lambda: pp.motion_blur(color, vel, coc, tile=8), 5)
    out["card"] = card_line()
    print(out["card"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
