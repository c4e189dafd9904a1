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
sample sets over a list of devices).

The environment switches it reads, at each call as the JAX package does:
LUPIN_NO_PACKET (no kernel B4), LUPIN_FORCE_PACKET (B4 on bounce batches
too; kernels/intersect.py) and LUPIN_SPP_STREAMS (sample streams,
render/renderer.py). Eight more are retired, each to the one setting
every caller ran: LUPIN_PACKET_RAYSORT (B4's coherence sort, off and
removed with its code), LUPIN_PACKET_MAX_GSL, LUPIN_WF_Q, LUPIN_WF_Q_DIV,
LUPIN_WF_Q_TAIL and LUPIN_WF_TAIL_C (now constants of kernels/intersect.py),
LUPIN_DISPATCH_RAY_STRIDE_BUDGET (the JAX package's rays x stride dispatch
rule, removed) and LUPIN_DISPATCH_TILE_FLOOR (a constant of
render/renderer.py, whose dispatch self-bound splits a frame only where its
working set would pass half of the device's memory). The port reads none of
them.

Without a counterpart, by design: the JAX package's packet probe
(LUPIN_SKIP_PROBE) and its scalar-memory ring (LUPIN_PACKET_STREAM), TPU
mechanisms; LUPIN_PACKET_GEO_VMEM_MAX and LUPIN_PACKET_REFS_SMEM_MAX, the
TPU's VMEM and SMEM budgets for a staged top tree (B4 here reads the tree
from global memory and is gated by its own limits, intersect.packet_eligible);
LUPIN_PACKET_EV_PREC, which no JAX code reads; and bench.py (ROADMAP.md).
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
