"""Named-resource registry with dependency recording (port of
arkoserenderer_tpu/rendering/registry.py).

Passes construct against it: they declare the tensors they create and
publish or consume resources by name, each read recording a (producer,
consumer) edge; reading a name no earlier pass published fails at
construct time. At run time the resources are entries of the frame-state
dict.

  * transient  — recomputed by their producer every frame;
  * persistent — survive across frames; ``initial_state()`` allocates them
    with their clear values on the device;
  * host       — persistent Python values the host branches on without
    reading the device (the scene-version counters of the static shadow
    cache).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class ResourceDesc:
    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype | None   # None: a host value
    persistent: bool = False
    clear: float | int = 0
    producer: str | None = None


class Registry:
    def __init__(self):
        self._resources: dict[str, ResourceDesc] = {}
        self._edges: set[tuple[str, str]] = set()  # (producer, consumer)
        self._current_node: str | None = None
        self._published_by: dict[str, str] = {}

    # -- construct-time API -----------------------------------------------------

    def set_current_node(self, name: str | None):
        self._current_node = name

    def create(self, name: str, shape: tuple[int, ...], dtype: torch.dtype | None, *,
               persistent: bool = False, clear: float | int = 0) -> str:
        """Declare and publish a resource; ``dtype=None`` declares a host
        value (always persistent). Returns the handle (its name)."""
        if name in self._resources:
            raise ValueError(f"resource '{name}' already created by "
                             f"'{self._resources[name].producer}'")
        self._resources[name] = ResourceDesc(
            name=name, shape=tuple(shape), dtype=dtype,
            persistent=persistent or dtype is None, clear=clear,
            producer=self._current_node,
        )
        self._published_by[name] = self._current_node or "<external>"
        return name

    def publish(self, name: str) -> str:
        """Publish a name produced at execute time without a static desc
        (a NamedTuple such as TriSetup)."""
        if name in self._published_by:
            raise ValueError(f"'{name}' already published by {self._published_by[name]}")
        self._published_by[name] = self._current_node or "<external>"
        return name

    def get(self, name: str) -> str:
        """Declare a dependency on a previously published resource."""
        if name not in self._published_by:
            raise KeyError(
                f"node '{self._current_node}' reads '{name}' which no earlier "
                f"node published (published: {sorted(self._published_by)})"
            )
        self._edges.add((self._published_by[name], self._current_node or "<external>"))
        return name

    def has(self, name: str) -> bool:
        return name in self._published_by

    def desc(self, name: str) -> ResourceDesc:
        """The declaration of a created resource."""
        return self._resources[name]

    # -- runtime ------------------------------------------------------------------

    def initial_state(self, device) -> dict:
        """Persistent resources at their clear values (host values as
        Python numbers, tensors on ``device``)."""
        return {r.name: self.clear_value(r.name, device)
                for r in self._resources.values() if r.persistent}

    def clear_value(self, name: str, device="cuda"):
        """Resource ``name`` at its clear value (a host value as itself)."""
        r = self._resources[name]
        if r.dtype is None:
            return r.clear
        return torch.full(r.shape, r.clear, dtype=r.dtype, device=device)

    @property
    def persistent_names(self) -> list[str]:
        return [r.name for r in self._resources.values() if r.persistent]

    @property
    def transient_names(self) -> list[str]:
        """The created resources every frame recomputes."""
        return [r.name for r in self._resources.values() if not r.persistent]

    def dependency_edges(self) -> set[tuple[str, str]]:
        """The (producer, consumer) pass pairs of every read."""
        return set(self._edges)

    def describe(self) -> str:
        """One line per created resource: its class, name, shape, dtype,
        size and producer, as the reference prints them; a host value
        reads "host" for its dtype and 0 MB."""
        lines = []
        for r in self._resources.values():
            kind = "persistent" if r.persistent else "transient "
            if r.dtype is None:
                dtype, size = "host", 0
            else:
                dtype = str(r.dtype).removeprefix("torch.")
                size = math.prod(r.shape) * r.dtype.itemsize
            lines.append(f"{kind} {r.name:32s} {str(r.shape):24s} {dtype:10s}"
                         f" {size / 1e6:8.2f} MB  by {r.producer}")
        return "\n".join(lines)
