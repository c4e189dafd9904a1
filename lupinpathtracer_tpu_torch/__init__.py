"""lupinpathtracer_tpu_torch — the path tracer on PyTorch and CUDA.

A port of the JAX package `lupinpathtracer_tpu` (which stays the reference)
to PyTorch tensors, with hand-written CUDA kernels for an NVIDIA H100
(sm_90a) in place of the Pallas TPU kernels. The package imports neither
JAX nor the JAX package. Entry points run on the GPU (`device="cuda"`)
unless the caller passes `device="cpu"`, which runs the plain PyTorch
versions of the kernels.

It does what the JAX package does: scene building (dense scenes and BVH
scenes, single-level and two-level), the pathtrace dispatch under all four
integrators, the falsecolor AOVs and debug heatmaps, tonemapping and the
à-trous denoiser; the scene and image files (io/: binary PLY, Yocto/GL
JSON scenes, textures, OpenEXR, Radiance HDR); the apps (apps/: the render
CLI, the golden runner, the kernel check, the headless viewer, the scaling
study); and multi-device rendering (parallel/sharding.py: image tiles or
sample sets over a list of devices). Left out by design: the JAX package's
packet probe and its LUPIN_PACKET_STREAM scalar-memory ring (TPU
mechanisms), and bench.py (ROADMAP.md).
"""

from .core.types import (
    AccumulationParams,
    AdvancedParams,
    BakedPathtraceParams,
    CameraParams,
    Environment,
    FalsecolorType,
    Material,
    MaterialType,
    PathtraceDesc,
    PathtraceType,
    SceneCamera,
    TileParams,
    get_num_tiles,
)
from .scene.scene import (
    InstanceCPU,
    MeshCPU,
    SceneCPU,
    TextureCPU,
    get_scene_stats,
    validate_scene,
)
from .scene.flatten import SceneTorch, build_scene_torch, scene_from_numpy
from .render.renderer import (
    new_accumulation_buffer,
    pathtrace_scene,
    pathtrace_scene_debug,
    pathtrace_scene_falsecolor,
    render_progressive,
)
from .render.tonemap import TonemapDesc, tonemap, tonemap_and_fit_aspect
from .denoise.atrous import DenoiseDesc, denoise

__all__ = [
    "AccumulationParams", "AdvancedParams", "BakedPathtraceParams",
    "CameraParams", "DenoiseDesc", "Environment", "FalsecolorType",
    "InstanceCPU", "Material", "MaterialType", "MeshCPU", "PathtraceDesc",
    "PathtraceType", "SceneCPU", "SceneCamera", "SceneTorch", "TextureCPU",
    "TileParams", "TonemapDesc", "build_scene_torch", "denoise",
    "get_num_tiles", "get_scene_stats", "new_accumulation_buffer",
    "pathtrace_scene", "pathtrace_scene_debug", "pathtrace_scene_falsecolor",
    "render_progressive", "scene_from_numpy", "tonemap",
    "tonemap_and_fit_aspect", "validate_scene",
]
