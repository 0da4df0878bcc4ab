"""arkoserenderer_torch — the PyTorch / CUDA port of arkoserenderer_tpu.

The JAX package beside this one is the reference; this package renders the
same frames with PyTorch on an NVIDIA GPU (Hopper, sm_90a) and on the CPU.
It mirrors the reference's layout and names:

  core/       — constants, host (numpy) matrix math, tensor helpers
  assets/     — procedural scenes (the test scene, the bindless scene)
  scene/      — Camera, lights, Scene -> SceneArrays (tensors on a device)
  rendering/  — Registry, RenderPipeline and the render passes
  ops/        — raster, packed shading, shadows, BRDF, sky, tonemap, image
                helpers, SSAO and the post-process functions
  csrc/       — hand-written CUDA kernels (built with nvcc at first use)
  models/     — make_forward_pipeline and the Renderer frame loop
  tools/      — the frame-time bench and the raster kernel's measurements
  bridge.py   — carries the reference's SceneArrays / CameraState / frame
                state across

Nothing here imports jax or arkoserenderer_tpu; only the parity tests do.
"""

__version__ = "0.1.0"
