"""videorenderer_tpu_torch — the PyTorch/CUDA port of ``videorenderer_tpu``.

The main path (4K HDR10 -> SDR: chroma upsample, YUV->RGB, Lanczos3 resize,
PQ EOTF, Hable, BT.2020->709, gamma, ordered dither, packed surface) runs on
an NVIDIA Hopper card through two hand-written CUDA kernels
(``csrc/banded_resize.cu``, ``csrc/rows3_tail.cu``), built with ``nvcc`` at
their first launch.  On CPU tensors the same functions run their plain
PyTorch versions.  This package imports torch and numpy, never jax.

    vp = VideoProcessor(settings, src, dst, device="cuda", pack_surface=True)
    surface = vp.process((y, u, v))
"""

from .config import Settings
from .formats import ColorFormat, get_format_info
from .pipeline import (OutputDescriptor, SourceDescriptor, VideoProcessor,
                       make_frame_fn, plan_pipeline)

__all__ = ["Settings", "ColorFormat", "get_format_info", "SourceDescriptor",
           "OutputDescriptor", "VideoProcessor", "make_frame_fn",
           "plan_pipeline"]
