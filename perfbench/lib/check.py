"""What decides ``correct``: the program's frames against the plain reference
of the configuration (``reference/<name>.py``, found through ``Spec``),
rendered from the same authored inputs (``lib/inputs.py``) and the same
camera path.

Two frames are compared, both rendered through the program's
``render_frame`` at the cell's sizes:

  * ``start``: frame ``START_FRAME``. Program and reference each render
    frames 0 to ``START_FRAME`` from their own initial state, so the raster,
    shading and post chain and the TAA history they build are all the
    reference's own;
  * ``step``: the frame after the window (and after the traced stretch of a
    ``--trace 1`` run), a graph replay of the timed path. The reference
    cannot follow the window's hundreds of frames in the time a run has, so
    it renders this frame from a copy of the program's persistent state
    taken just before it (every floating-point entry of the program's
    registry: TAA and upscaler histories, the RT denoisers' histories,
    moments and depths, the DDGI probes; the one thing it takes from the
    program), and the state it carries on (``state.<name>``, each entry the
    reference returns, which holds every entry it read) is compared too.

The numbers, each named ``<frame>.<resource>[.<statistic>]``:

  * ``Visibility``: the share of pixels that show another scene triangle
    (each side's setup row mapped to the pool triangle it came from);
  * for a float resource, ``.mean``: the mean absolute difference over the
    reference's mean magnitude (edge pixels that flip barely move it, an
    error over a region does), and ``.worst``: the largest absolute
    difference over the reference's largest magnitude, over the pixels
    whose 5x5 neighbourhood shows the same triangles on both sides, in this
    frame and (for ``start``) in each earlier one whose colour its TAA
    history carries (so a triangle edge that lands on the other side of a
    pixel centre does not set it, and one wrong pixel anywhere else does; a
    resource of another size than the frame takes every texel)."""

from __future__ import annotations

import torch

START_FRAME = 2


def grab(renderer, names: list[str], state: bool = True) -> dict:
    """The compared resources of ``renderer``'s last frame, and (``state``)
    the persistent state it wrote (``state.<name>``), on the host."""
    st = renderer.state
    out = {}
    for n in names:
        if n == "Visibility":
            vis = st["Visibility"].long()
            orig = st["vis.setup"].orig_tri.long()
            ok = (vis >= 0) & (vis < orig.numel())
            out[n] = torch.where(ok, orig[vis.clamp(0, max(orig.numel() - 1, 0))], -1).cpu()
        else:
            out[n] = st[n].detach().float().cpu().clone()
    for k, v in (persistent(renderer) if state else {}).items():
        out["state." + k] = v.detach().float().cpu().clone()
    return out


def persistent(renderer) -> dict:
    """The floating-point entries of the program's persistent state, by
    name: the tensors themselves."""
    st = renderer.state
    return {k: st[k] for k in renderer.pipeline.registry.persistent_names
            if isinstance(st.get(k), torch.Tensor) and st[k].is_floating_point()}


def reference_frames(module, inputs: dict, config: dict, device, step_frame: int,
                     step_state: dict, tf32: bool = False) -> tuple[dict, dict]:
    """The reference's frame ``START_FRAME`` (from frame 0 on its own state)
    and its frame ``step_frame`` from ``step_state`` (the program's
    persistent state, by name); ``tf32`` computes its float32 matrix
    products in TF32 (the control)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        frame = module.Frame(inputs, config, device)
        state, earlier = {}, []
        for f in range(START_FRAME + 1):
            out, state = render(frame, f, state)
            if "Visibility" in out:
                earlier.append(out["Visibility"].cpu())
        start = host(out, state)
        if earlier:
            start["Visibility.earlier"] = torch.stack(earlier[:-1])
        handed = {k: v.to(device, copy=True) for k, v in step_state.items()}
        out, state = render(frame, step_frame, handed)
        return start, host(out, state)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class Handed(dict):
    """The state handed to a reference's ``render``, noting each entry whose
    value it reads."""

    def __init__(self, state: dict):
        super().__init__(state)
        self.read: set = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def __iter__(self):  # so that dict(handed) and {**handed} go through __getitem__
        return super().__iter__()

    def get(self, k, default=None):
        if k in self:
            self.read.add(k)
        return super().get(k, default)

    def pop(self, k, *default):
        if k in self:
            self.read.add(k)
        return super().pop(k, *default)

    def items(self):
        self.read.update(self.keys())
        return super().items()

    def values(self):
        self.read.update(self.keys())
        return super().values()


def render(frame, f: int, state: dict) -> tuple[dict, dict]:
    """``frame.render(f, state)``, refusing a reference that reads an entry
    of the state it is handed and does not return it: ``render`` returns the
    whole state it carries into the next frame, so each entry it builds on
    is compared (``state.<name>``)."""
    handed = Handed(state)
    out, written = frame.render(f, handed)
    dropped = sorted(handed.read - set(written))
    if dropped:
        raise ValueError(f"the reference read {dropped} of its state and did not return it")
    return out, written


def host(out: dict, state: dict) -> dict:
    res = {k: v.detach().cpu() for k, v in out.items()}
    res.update({"state." + k: v.detach().float().cpu() for k, v in state.items()})
    return res


def agreed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(H, W) bool: the two Visibility buffers agree on every pixel within
    two of this one."""
    off = (a != b).float()[None, None]
    return torch.nn.functional.max_pool2d(off, 5, 1, padding=2)[0, 0] == 0


def differences(prog: dict, ref: dict) -> dict:
    """One or two numbers for each resource the reference has (see the module)."""
    out = {}
    same = None
    if "Visibility" in ref and "Visibility" in prog and prog["Visibility"].shape == ref["Visibility"].shape:
        same = agreed(prog["Visibility"], ref["Visibility"])
        a, b = prog.get("Visibility.earlier"), ref.get("Visibility.earlier")
        if a is not None and b is not None and a.shape == b.shape:
            for i in range(a.shape[0]):
                same &= agreed(a[i], b[i])
    for k, r in ref.items():
        if k == "Visibility.earlier":
            continue
        p = prog.get(k)
        if p is None or tuple(p.shape) != tuple(r.shape):
            out[k] = float("inf")
            continue
        if k == "Visibility":
            out[k] = float((p != r).float().mean())
            continue
        gap = torch.nan_to_num((p.double() - r.double()).abs(), nan=float("inf"))
        mag = r.double().abs()
        out[k + ".mean"] = float(gap.mean() / max(float(mag.mean()), 1e-30))
        mask = same if same is not None and tuple(same.shape) == tuple(r.shape[:2]) else None
        if mask is not None:
            gap = gap[mask]
        out[k + ".worst"] = (float(gap.max()) / max(float(mag.max()), 1e-30)
                             if gap.numel() else 0.0)
    return out


def numbers(prog_start: dict, prog_step: dict, ref_start: dict, ref_step: dict) -> dict:
    """Every number, named ``start.<...>`` / ``step.<...>``."""
    out = {f"start.{k}": v for k, v in differences(prog_start, ref_start).items()}
    out.update({f"step.{k}": v for k, v in differences(prog_step, ref_step).items()})
    return out


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number within its limit, {name: [value, limit]}).
    The configuration's ``limits`` name the numbers compared; one it names
    that the run did not produce reads infinite, and fails."""
    if not limits:
        raise ValueError("the configuration names no compared number (its limits)")
    table = {k: [values.get(k, float("inf")), float(lim)] for k, lim in limits.items()}
    return all(v <= lim for v, lim in table.values()), table
