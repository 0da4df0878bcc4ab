"""The packed deferred-shading kernel (csrc/packed_shading.cu) against its
plain torch version, and the dispatch and checks around it.

The ``cuda`` cases need an NVIDIA GPU and nvcc and skip without one; the
file imports no JAX, so they also run on a machine that has only PyTorch:

    python -m pytest tests/test_torch_shading_kernel.py --noconftest -o addopts="" -q

Each builds seeded inputs (records of big random triangles with every
lane the layout has, packed material chains of random images, a VSM, spot
maps, ray-traced masks, VIS_NONE tiles, double-sided materials, a device
frame index) and holds the kernel's G-buffer to ``shade_packed_plain``'s on
the card under ``tools.shading_bench``'s tolerances: SceneCoverage bit for
bit; each float output within a mean |difference| of 1e-5 of its mean
|plain| (the kernel performs the plain operations in their order; only a
transcendental's rounding can differ); and fewer than 0.1 % of the pixels
off by more than 1e-3 relative (a mip level, a wrapped texel or a
stochastic pick that flips where a floor or round meets a boundary).

The CPU cases run in the tier-1 gate: on CPU tensors ``shade_packed`` is
the plain version bit for bit and launches nothing; the wrapper refuses CPU,
non-contiguous and wrongly typed inputs, and what the kernel does not take,
with ValueError; its by-value arguments mirror the kernel's ``Args``.
"""

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from arkoserenderer_torch.core.halton import fibonacci_disc
from arkoserenderer_torch.core.types import VIS_NONE
from arkoserenderer_torch.ops import mattex, packed_shading, packed_shading_cuda
from arkoserenderer_torch.ops.packed_shading import MREC_SIZE, layout_of
from arkoserenderer_torch.scene.camera import Camera
from arkoserenderer_torch.scene.lights import (
    DirectionalLight,
    LightArrays,
    PointLight,
    SpotLight,
    build_light_arrays,
)
from arkoserenderer_torch.scene.scene import Material

W, H, TILE = 64, 48, 8
N_TRIS, VSM_SIZE, LOCAL_SIZE = 24, 64, 32
CU = Path(__file__).resolve().parents[1] / "arkoserenderer_torch" / "csrc" / "packed_shading.cu"


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the shading kernel has no CPU mode")
    return torch.device("cuda")


def random_images(rng) -> list:
    """Bindless images: ids 0-3 the defaults, then base, normal,
    metallic-roughness, emissive and occlusion images of other sizes and
    wrap modes."""
    images = [(np.zeros((1, 1, 4), np.uint8), True, 0)] * 4
    for (h, w), wrap in (((16, 16), 0), ((8, 32), 1), ((64, 64), 0), ((4, 4), 1), ((32, 16), 0)):
        images.append((rng.integers(0, 256, (h, w, 4), dtype=np.uint8), True, wrap))
    return images


def material_records(rng, materials, meta) -> np.ndarray:
    """(M, 32) material records (ops/packed_shading.py's lanes)."""
    rec = np.zeros((len(materials), MREC_SIZE), np.float32)
    for i, m in enumerate(materials):
        rec[i, 0:4] = m.base_color_factor
        rec[i, 4:7] = m.emissive_factor
        rec[i, 7] = m.metallic_factor
        rec[i, 8] = m.roughness_factor
        rec[i, 9] = float(m.double_sided)
        rec[i, 10] = m.clearcoat
        rec[i, 11] = m.clearcoat_roughness
        rec[i, 12] = m.subsurface
    rec[:, 15:15 + mattex.META_LANES] = meta
    return rec


def shading_inputs(seed: int, device, has_prev: bool = True, has_tan: bool = False,
                   n_spots: int = 0, n_points: int = 0, rt_masks: bool = False) -> dict:
    """Seeded arguments of one ``shade_packed`` call on a W x H grid."""
    rng = np.random.default_rng(seed)
    layout = layout_of(has_prev, has_tan)
    images = random_images(rng)
    materials = []
    for i in range(6):
        m = Material(
            base_color_factor=rng.uniform(0.2, 1.0, 4).astype(np.float32),
            emissive_factor=(rng.uniform(0, 50, 3) if i % 3 == 0 else np.zeros(3)).astype(
                np.float32),
            metallic_factor=float(rng.uniform()), roughness_factor=float(rng.uniform(0.02, 1)),
            base_color_tex=4 + i % 5, normal_tex=5 if i % 2 else 2, mr_tex=6,
            emissive_tex=7 if i % 3 == 0 else 0, occlusion_tex=8 if i % 2 == 0 else 0,
            double_sided=bool(i % 2), clearcoat=float(rng.uniform()) if i % 2 else 0.0,
            clearcoat_roughness=float(rng.uniform()), subsurface=float(rng.uniform()),
        )
        materials.append(m)
    rows, meta = mattex.build_packed_materials(materials, images)
    mrec = material_records(rng, materials, meta)

    cs = layout.c_stride
    recs = np.zeros((N_TRIS, layout.rec_size), np.float32)
    for t in range(N_TRIS):
        # A big triangle around the screen, so its barycentrics are tame.
        corners = np.array([[-0.5 * W, -0.5 * H], [2.5 * W, -0.3 * H], [0.2 * W, 2.5 * H]])
        recs[t, 0:6] = (corners + rng.uniform(-0.2, 0.2, (3, 2)) * (W, H)).ravel()
        recs[t, 6:9] = rng.uniform(0.2, 1.0, 3)
        uv_scale = (0.3, 3.0, 40.0)[t % 3]
        for k in range(3):
            c = recs[t, 9 + k * cs:9 + (k + 1) * cs]
            c[0:3] = rng.uniform(-1.5, 1.5, 3)
            if has_prev:
                c[layout.o_prev:layout.o_prev + 3] = c[0:3] + rng.uniform(-0.05, 0.05, 3)
            c[layout.o_nrm:layout.o_nrm + 3] = rng.normal(size=3) + (0, 1.5, 0)
            if has_tan:
                c[layout.o_tan:layout.o_tan + 3] = rng.normal(size=3)
                c[layout.o_tan + 3] = rng.choice([-1.0, 1.0])
            c[layout.o_uv:layout.o_uv + 2] = rng.uniform(-1, 1, 2) * uv_scale
        mo = 9 + 3 * cs
        recs[t, mo:mo + MREC_SIZE] = mrec[t % len(materials)]
    # A triangle id a tile, a few tiles empty, so a warp's pixels share one.
    tiles = rng.integers(0, N_TRIS, (H // TILE, W // TILE))
    tiles[rng.uniform(size=tiles.shape) < 0.15] = VIS_NONE
    vis = np.repeat(np.repeat(tiles, TILE, 0), TILE, 1).astype(np.int32).ravel()

    sun = DirectionalLight(direction=np.array([0.35, -1.0, -0.25], np.float32))
    spots = [SpotLight(position=np.array([0.5 * i, 3.0, 0.3], np.float32),
                       direction=np.array([0.1, -1.0, -0.1 * i], np.float32),
                       luminous_intensity_cd=3000.0, cast_shadows=i == 0,
                       outer_cone_angle=np.radians(60.0), inner_cone_angle=np.radians(35.0),
                       ies_lut=rng.uniform(0.2, 1.0, 256).astype(np.float32))
             for i in range(n_spots)]
    points = [PointLight(position=np.array([-1.0 + i, 1.5, 1.0], np.float32),
                         luminous_intensity_cd=500.0) for i in range(n_points)]
    host = build_light_arrays(sun, spots, points, 1e-4, np.zeros(3, np.float32), 3.0)
    lights = LightArrays(**{k: torch.from_numpy(np.array(v)).to(device)
                            for k, v in host.items()})
    cam = Camera(viewport=(W, H))
    cam.look_at((0.4, 1.8, 4.0), (0.0, 0.2, 0.0))
    cam.post_render()
    cam.look_at((0.5, 1.7, 4.1), (0.0, 0.2, 0.0))  # moved: velocities are not zero

    n = W * H
    mean = rng.uniform(0.2, 0.8, (VSM_SIZE, VSM_SIZE))
    moments = np.stack([mean, mean * mean + rng.uniform(0, 0.01, mean.shape)], -1)
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5,
                         np.arange(H, dtype=np.float32) + 0.5)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return dict(
        scene=types.SimpleNamespace(
            mat_tex=mattex.PackedTexturePool(rows=dev(rows.view(np.int32), torch.int32)),
            lights=lights),
        cam=cam.state(3, device), vis_flat=dev(vis, torch.int32),
        depth_flat=dev(rng.uniform(size=n)), records=dev(recs), px=dev(xs.ravel()),
        py=dev(ys.ravel()), width=W, height=H,
        shadow_moments=dev(moments), sun_shadow_vp=lights.sun_view_proj,
        local_shadow_maps=dev(rng.uniform(size=(max(n_spots, 1), LOCAL_SIZE, LOCAL_SIZE))),
        spot_shadow_flags=tuple(bool(s.cast_shadows) for s in spots),
        rt_spot_masks=dev(rng.uniform(size=(max(n_spots, 1), n))) if rt_masks else None,
        rt_point_masks=dev(rng.uniform(size=(max(n_points, 1), n))) if rt_masks else None,
        n_spots=n_spots, n_points=n_points,
        frame_index=torch.tensor(11, dtype=torch.int32, device=device),
        layout=layout,
    )


def call(inputs: dict, fn, **overrides):
    kw = dict(inputs, **overrides)
    args = [kw.pop(k) for k in ("scene", "cam", "vis_flat", "depth_flat", "records", "px", "py",
                                "width", "height")]
    return fn(*args, **kw)


# (name, shading_inputs keywords, shade_packed keywords): the layouts, every
# texture quality and none, each sun source, the local lights with and
# without ray-traced masks, the mip bias and a host frame index.
CASES = [
    ("static", dict(has_prev=False), {}),
    ("moving", dict(has_prev=True), {}),
    ("tangents", dict(has_prev=False, has_tan=True), {}),
    ("moving_tangents", dict(has_prev=True, has_tan=True), {}),
    ("bilinear", {}, dict(texture_quality="bilinear")),
    ("aniso4", dict(has_tan=True), dict(texture_quality="aniso4")),
    ("aniso3", {}, dict(texture_quality="aniso3")),
    ("stochastic", {}, dict(texture_quality="stochastic")),
    ("stochastic1", dict(has_tan=True), dict(texture_quality="stochastic1")),
    ("untextured", {}, dict(any_tex=False)),
    ("sun_mask", {}, dict(shadow_mask="rand")),
    ("vsm_stochastic", {}, dict(shadow_filter="stochastic")),
    ("unshadowed", {}, dict(shadow_moments=None, sun_shadow_vp=None)),
    ("lights_pcf", dict(n_spots=2, n_points=2), {}),
    ("lights_rt", dict(n_spots=2, n_points=2, rt_masks=True), dict(shadow_mask="rand")),
    ("mip_bias", {}, dict(mip_bias=-0.75, texture_quality="stochastic1",
                          shadow_filter="stochastic")),
    ("host_frame", {}, dict(frame_index=5, texture_quality="stochastic")),
]
NAMES = [c[0] for c in CASES]


def case_inputs(name: str, device, seed: int = 0) -> tuple[dict, dict]:
    _, make, kw = CASES[NAMES.index(name)]
    inputs = shading_inputs(seed, device, **make)
    kw = dict(kw)
    if kw.get("shadow_mask") == "rand":
        kw["shadow_mask"] = torch.rand(W * H, generator=torch.Generator().manual_seed(seed)).to(
            device)
    return inputs, kw


@pytest.mark.parametrize("name", NAMES)
def test_cpu_is_the_plain_version(name):
    inputs, kw = case_inputs(name, "cpu")
    launches = packed_shading_cuda.shade_packed_cuda.launches
    ours = call(inputs, packed_shading.shade_packed, **kw)
    plain = call(inputs, packed_shading.shade_packed_plain, **kw)
    assert packed_shading_cuda.shade_packed_cuda.launches == launches
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)
    assert ours.valid.any() and not ours.valid.all()
    assert all(bool(torch.isfinite(t).all()) for t in ours[:5])


def test_wrapper_refuses_cpu_inputs():
    inputs, kw = case_inputs("moving", "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(inputs, packed_shading_cuda.shade_packed_cuda, **kw)


@pytest.mark.parametrize("field,make,match", [
    ("records", lambda t: torch.cat([t, t], 1)[:, ::2], "contiguous"),
    ("px", lambda t: torch.stack([t, t], 1)[:, 0], "contiguous"),
    ("vis_flat", lambda t: t.float(), "torch.int32"),
    ("py", lambda t: t.double(), "torch.float32"),
    ("records", lambda t: t[:, :-8].contiguous(), "shape"),
])
def test_wrapper_refuses_bad_tensors(field, make, match):
    inputs, kw = case_inputs("moving", "cpu")
    inputs[field] = make(inputs[field])
    with pytest.raises(ValueError, match=match):
        call(inputs, packed_shading_cuda.shade_packed_cuda, **kw)


@pytest.mark.parametrize("kw,match", [
    (dict(texture_quality="cubic"), "unknown texture quality"),
    (dict(n_spots=32), "spots"),
    (dict(layout=layout_of(True, False)._replace(o_uv=3)), "layouts"),
    (dict(frame_index=2**31), "int32"),
    (dict(sun_shadow_vp=None), "sun_shadow_vp"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(kw, match):
    inputs, _ = case_inputs("moving", "cpu")
    with pytest.raises(ValueError, match=match):
        call(inputs, packed_shading_cuda.shade_packed_cuda, **kw)


def test_branch_codes():
    q = packed_shading_cuda.quality_code
    assert q(False, "cubic") == (packed_shading_cuda.Q_NONE, 0)
    assert q(True, "auto") == q(True, "sorted") == (packed_shading_cuda.Q_TRILINEAR, 0)
    assert q(True, "aniso") == (packed_shading_cuda.Q_ANISO, 4)
    assert q(True, "aniso8") == (packed_shading_cuda.Q_ANISO, 8)
    assert q(True, "stochastic1") == (packed_shading_cuda.Q_STOCHASTIC1, 0)
    s = packed_shading_cuda.sun_mode
    assert s(1, 1, "stochastic") == packed_shading_cuda.SUN_MASK
    assert s(None, 1, "stochastic") == packed_shading_cuda.SUN_VSM_STOCHASTIC
    assert s(None, 1, "auto") == packed_shading_cuda.SUN_VSM
    assert s(None, None, "stochastic") == packed_shading_cuda.SUN_NONE
    bits = packed_shading_cuda.spot_pcf_bits
    assert bits(3, None, 1, (True, False, True)) == 0b101
    assert bits(1, None, 1, (True, False, True)) == 0b1
    assert bits(3, 1, 1, (True, True, True)) == 0
    assert bits(3, None, None, (True, True, True)) == 0
    disc = (fibonacci_disc(8) * (1.5 / 512)).ravel()
    assert packed_shading_cuda.pcf_disc(512) == [float(v) for v in disc]


def test_args_mirror_the_kernel_struct():
    """ShadeArgs lists csrc/packed_shading.cu's Args fields in order, with
    their C types."""
    body = re.search(r"struct Args \{(.*?)\n\};", CU.read_text(), re.S).group(1)
    fields = re.findall(r"^\s*(?:const )?([a-z ]+?)\s*(\*?)\s*(\w+)(\[[^\]]*\])?;", body, re.M)
    ctypes_of = {"int": ctypes.c_int, "float": ctypes.c_float}
    theirs = [(name, ctypes.c_void_p if star else ctypes_of[ty.strip()])
              for ty, star, name, _ in fields]
    ours = [(name, ty if not hasattr(ty, "_length_") else ty._type_)
            for name, ty in packed_shading_cuda.ShadeArgs._fields_]
    assert ours == theirs
    assert ctypes.sizeof(packed_shading_cuda.ShadeArgs) == 35 * 8 + 17 * 4 + 3 * 4 + 16 * 4


def test_layouts_match_record_layout():
    """layout_of is record_layout's arithmetic, and the kernel's Layout:
    the rows are 80 lanes on the stress path (prev, no tangents)."""
    assert layout_of(True, False).rec_size == 80
    for prev in (False, True):
        for tan in (False, True):
            lay = layout_of(prev, tan)
            o_nrm = 6 if prev else 3
            assert lay.o_nrm == o_nrm and lay.c_stride == o_nrm + 5 + (4 if tan else 0)
            assert lay.rec_size % 8 == 0 and lay.rec_size >= 9 + 3 * lay.c_stride + MREC_SIZE


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain(cuda_device, name):
    from arkoserenderer_torch.tools import shading_bench as sb

    inputs, kw = case_inputs(name, cuda_device, seed=3)
    launches = packed_shading_cuda.shade_packed_cuda.launches
    ours = call(inputs, packed_shading.shade_packed, **kw)
    assert packed_shading_cuda.shade_packed_cuda.launches == launches + 1
    plain = call(inputs, packed_shading.shade_packed_plain, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ours.valid, plain.valid)
    assert ours.depth is inputs["depth_flat"]
    agree = sb.agreement(ours, plain)
    assert sb.within_tolerance(agree), agree
