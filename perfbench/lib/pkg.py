"""The entry points of the program (``arkoserenderer_torch``) that the
harness drives: the scene builders, ``PipelineConfig`` and its
``RasterConfig``, and ``Renderer``."""

from __future__ import annotations

import importlib
import types


def package(name: str) -> types.SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{name}.{path}")

    return types.SimpleNamespace(
        name=name,
        procedural=mod("assets.procedural"),
        PipelineConfig=mod("rendering.pipeline").PipelineConfig,
        RasterConfig=mod("core.types").RasterConfig,
        Renderer=mod("models.standard").Renderer,
    )
