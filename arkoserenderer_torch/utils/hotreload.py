"""Hot reload: source watching, module reload and pipeline reconstruction
(port of arkoserenderer_tpu/utils/hotreload.py).

The reference's shader hot reload (arkose/rendering/backend/shader/
ShaderManager.h:49-51, a thread polling shader files' timestamps, read by
Arkose.cpp:49-73's ``checkOnShaderFileWatching``, which calls
``reconstructRenderPipelineResources``). Here the "shaders" are the
passes' and ops' Python modules: ``ModuleWatcher.poll`` checks the loaded
modules' source mtimes and ``importlib.reload``s the changed ones, deepest
first; the caller then calls ``Renderer.reconstruct(rebuild_passes=True)``,
which makes new passes from the reloaded code and keeps the persistent
state. Only ``.py`` files are watched. Reloading a kernel wrapper
(``ops/raster_cuda.py``, ``ops/bvh_cuda.py``) resets its library handle;
its next launch loads the library already built for the same sources (the
file name carries their hash) without compiling again.
"""

from __future__ import annotations

import importlib
import os
import sys
import time


class ModuleWatcher:
    """Polls the loaded modules under the given root paths for mtime changes."""

    def __init__(self, roots: list[str] | None = None, poll_interval: float = 0.5):
        if roots is None:
            import arkoserenderer_torch

            roots = [os.path.dirname(arkoserenderer_torch.__file__)]
        self.roots = [os.path.abspath(r) for r in roots]
        self.poll_interval = poll_interval
        self._mtimes: dict[str, float] = {}
        self._last_poll = 0.0
        self._scan(initial=True)

    def _watched(self):
        for name, mod in list(sys.modules.items()):
            f = getattr(mod, "__file__", None)
            if not f or not f.endswith(".py"):
                continue
            f = os.path.abspath(f)
            if any(f.startswith(root + os.sep) or f == root for root in self.roots):
                yield name, mod, f

    def _scan(self, initial: bool = False) -> list[str]:
        changed = []
        for name, mod, f in self._watched():
            try:
                m = os.stat(f).st_mtime
            except OSError:
                continue
            old = self._mtimes.get(f)
            self._mtimes[f] = m
            if not initial and old is not None and m > old:
                changed.append(name)
        return changed

    def poll(self) -> list[str]:
        """The names of the modules reloaded (empty when none changed).

        Deepest modules first (the ops before the passes that import them),
        as the reference recompiles shader files before relinking
        pipelines."""
        now = time.monotonic()
        if now - self._last_poll < self.poll_interval:
            return []
        self._last_poll = now
        changed = self._scan()
        if not changed:
            return []
        changed.sort(key=lambda n: -n.count("."))
        reloaded = []
        for name in changed:
            mod = sys.modules.get(name)
            if mod is None:
                continue
            try:
                importlib.reload(mod)
                reloaded.append(name)
            except Exception as e:  # noqa: BLE001 - a broken save must not stop
                # the app: the old code keeps running, as the reference shows
                # the error and retries (ShaderManager.cpp compileWithRetry),
                # and the next good save reloads.
                print(f"hot-reload: {name} failed: {e!r}", file=sys.stderr)
        return reloaded
