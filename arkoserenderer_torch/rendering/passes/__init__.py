from arkoserenderer_torch.rendering.passes.scenepass import ScenePass  # noqa: F401
from arkoserenderer_torch.rendering.passes.geometry import GeometryPass  # noqa: F401
from arkoserenderer_torch.rendering.passes.shadow import LocalShadowPass, SunShadowPass  # noqa: F401
from arkoserenderer_torch.rendering.passes.shading import VisibilityShadingPass  # noqa: F401
from arkoserenderer_torch.rendering.passes.rt import (  # noqa: F401
    RTLocalShadowPass,
    RTReflectionsPass,
    RTShadowPass,
)
from arkoserenderer_torch.rendering.passes.post import (  # noqa: F401
    CASPass,
    DepthOfFieldPass,
    FogPass,
    FXAAPass,
    LightingComposePass,
    MotionBlurPass,
    SSAOPass,
)
from arkoserenderer_torch.rendering.passes.sky import SkyPass  # noqa: F401
from arkoserenderer_torch.rendering.passes.bloom import BloomPass  # noqa: F401
from arkoserenderer_torch.rendering.passes.taa import TAAPass  # noqa: F401
from arkoserenderer_torch.rendering.passes.translucent import TranslucentPass  # noqa: F401
from arkoserenderer_torch.rendering.passes.output import OutputPass  # noqa: F401
from arkoserenderer_torch.rendering.passes.upscale import TemporalUpscalePass, UpscalePass  # noqa: F401
