"""The entry points of the program (``arkoserenderer_torch``) that the
harness drives: the scene builders, ``PipelineConfig`` and its
``RasterConfig``, DDGI's ``ProbeGridConfig`` and ``Renderer``; and
``module(path)``, any other module of the program by its path in the
package, for a scene builder that needs one (lights, materials, loaders)."""

from __future__ import annotations

import importlib
import types


def package(name: str) -> types.SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{name}.{path}")

    return types.SimpleNamespace(
        name=name,
        module=mod,
        procedural=mod("assets.procedural"),
        PipelineConfig=mod("rendering.pipeline").PipelineConfig,
        RasterConfig=mod("core.types").RasterConfig,
        ProbeGridConfig=mod("ops.ddgi").ProbeGridConfig,
        Renderer=mod("models.standard").Renderer,
    )
