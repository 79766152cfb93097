"""videorenderer_tpu_torch — the PyTorch/CUDA port of ``videorenderer_tpu``.

The main path (4K HDR10 -> SDR: chroma upsample, YUV->RGB, Lanczos3 resize,
PQ EOTF, Hable, BT.2020->709, gamma, ordered dither, packed surface) runs on
an NVIDIA Hopper card through two hand-written CUDA kernels
(``csrc/banded_resize.cu``, ``csrc/rows3_tail.cu``), built with ``nvcc`` at
their first launch; the Jinc2 upscale and motion-adaptive deinterlacing
have kernels of their own (``csrc/jinc2_*.cu``, ``csrc/deint3_rows_dual.cu``,
``csrc/cols3_tail.cu``), as do Dolby Vision (``csrc/rows3_mid.cu``) and a
letterboxed output (``csrc/banded_resize_rows.cu``); HDR10+'s guided curve
and Dolby Vision's L2 trims run in the tails of ``csrc/rows3_tail.cu`` and
``csrc/cols3_tail.cu``.  On CPU tensors the
same functions run their plain PyTorch versions.  This package imports torch and numpy, never jax.

    vp = VideoProcessor(settings, src, dst, device="cuda", pack_surface=True)
    surface = vp.process((y, u, v))

    session = DeinterlaceSession(plan, double_rate=True, pack_surface=True,
                                 device="cuda")
    field0, field1 = session.push_batch((y, u, v))

    serve = make_serving_fn(plan_pipeline(settings, dovi_src, dst),
                            pack_surface=True)
    surface = serve((y, u, v), {"dovi_curves": serve.pack_curves(scene)})

    vr = VideoRenderer(settings, pack_surface=True, device="cuda")
    vr.open(src, dst)
    vr.set_subtitle_provider(load_srt("movie.srt"))
    surface = vr.process_frame((y, u, v), time=12.5)

The renderer facade (:class:`~.api.VideoRenderer`) composites subtitles, an
alpha bitmap and the stats OSD on the surface; ``VideoProcessor.process_packed``
unpacks packed frame bytes on the device and :func:`~.runner.run_clip`
streams host batches with the copies overlapped.
"""

from .config import (ChromaScaling, Deinterlacing, Downscaling, Settings,
                     SuperResolution, SwapEffect, TexFormat, ToneMapType,
                     Upscaling)
from .csputils import CSP, ChromaLocation, Levels, Primaries, TRC
from .formats import ColorFormat, PlanarFrame, get_format_info, unpack_frame
from .pipeline import (HDR10Metadata, OutputDescriptor, OutputSignalInfo,
                       SourceDescriptor, VideoProcessor, make_deint_fields_fn,
                       make_deint_frame_fn, make_frame_fn, make_serving_fn,
                       output_signal_info, plan_pipeline)
from .runner import DeinterlaceSession, run_clip

__version__ = "0.3.0"

from .api import VideoRenderer  # noqa: E402  (needs __version__ above)

__all__ = [
    "CSP", "ChromaLocation", "ChromaScaling", "ColorFormat", "Deinterlacing",
    "DeinterlaceSession", "Downscaling", "HDR10Metadata", "Levels",
    "OutputDescriptor", "OutputSignalInfo", "PlanarFrame", "Primaries",
    "Settings", "SourceDescriptor",
    "SuperResolution", "SwapEffect", "TRC", "TexFormat", "ToneMapType",
    "Upscaling", "VideoProcessor", "VideoRenderer", "get_format_info",
    "make_deint_fields_fn", "make_deint_frame_fn", "make_frame_fn",
    "make_serving_fn", "output_signal_info", "plan_pipeline", "run_clip",
    "unpack_frame",
]
