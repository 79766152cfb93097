"""Public control surface — the renderer facade, the port of
``videorenderer_tpu.api``.

Mirrors the verbs of the reference's COM surface so a reference user finds
everything:

 * ``IVideoRenderer``: GetVideoProcessorInfo / GetActive / Get/SetSettings /
   SaveSettings (Source/IVideoRenderer.h:188-197)
 * ``IExFilterConfig`` string-keyed control plane: rotation / flip /
   stereo3dTransform / statsEnable / displayedImage / cmd_redraw / user
   pre/post-scale shader injection (Source/VideoRenderer.cpp:1335-1559)
 * screenshot APIs GetCurrentImage (source-sized) and displayedImage
   (output-sized) (Source/VideoRenderer.cpp:947-993,1397-1412)
 * media-type negotiation: open() = SetMediaType/InitMediaType; process
   frames; live reconfiguration Configure() diffing
   (Source/DX11VideoProcessor.cpp:3812-4062)

The renderer runs on one torch device, the card unless the caller asks for
the CPU: planes are moved there, the frame function (:mod:`.pipeline`)
launches the CUDA kernels on a card, and subtitles, the alpha bitmap and the
stats OSD are rasterised on the host and blended there
(:mod:`.ops.overlay`), onto the packed backbuffer when ``pack_surface``.
A "user shader" is a Python callable ``fn(rgb_chw) -> rgb_chw`` on float
tensors, run at the same point of the post-scale chain as
AddPre/PostScaleShader.  The learned SuperRes / RTX Video HDR slots take
the models of :mod:`.models` (their weights moved to the renderer's device
once, when they are set) and run first in the float tail.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import numpy as np
import torch

from . import __version__
from .config import Settings
from .csputils import TRC, Primaries
from .formats import (PlanarFrame, get_format_info, pack_rgb8, pack_rgb10,
                      rgb10_dwords_to_bgr48, unpack_rgb10, unpack_rgba8)
from .kernels import resize as rk
from .models import superres as sr_model
from .models import videohdr as vh_model
from .ops import dither as dither_ops
from .ops import geometry as geo_ops
from .ops import scale as scale_ops
from .ops.overlay import blend_in_rect, blend_in_rect_packed, sdr_bitmap_to_pq
from .pipeline import (HDR10Metadata, OutputDescriptor, SourceDescriptor,
                       check_device, make_frame_fn, output_signal_info,
                       plan_pipeline, route_of, surface_pack_format)
from .runner import DeinterlaceSession
from .stats import Metrics, precise_tick
from .utils import trace

# the CUDA runtime's own error (a lost or faulted device), the one error the
# device-lost retry catches; a kernel's build error or a wrapper's refusal
# is not one of these
DEVICE_ERRORS = tuple(e for e in (getattr(torch, "AcceleratorError", None),)
                      if e is not None)


class VideoRenderer:
    """Session object: owns Settings, the current media type, the built
    pipeline, metrics, and the last displayed frame (for screenshots and
    paused redraw, Source/VideoRenderer.cpp:555-560)."""

    def __init__(self, settings: Settings | None = None,
                 pack_surface: bool = False, *,
                 device: torch.device | str = "cuda"):
        """``pack_surface``: emit packed R10G10B10A2/RGBA8 int32 dword
        surfaces (the swap-chain backbuffer format) instead of planar float
        — the kernels pack in-kernel and subtitles/OSD/alpha-bitmap
        composite directly onto the packed surface, as the reference draws
        onto the backbuffer after FinalPass
        (Source/DX11VideoProcessor.cpp:2741-2767).  ``device``: the card
        unless the caller asks for the CPU; a CUDA device with no CUDA
        raises."""
        self.device = check_device(device)
        self.settings = (settings or Settings()).validate()
        self._pack_surface = bool(pack_surface)
        self._out_fmt: str | None = None      # "rgb10a2"/"rgba8" when packed
        self._src: SourceDescriptor | None = None
        self._dst: OutputDescriptor | None = None
        self._plan = None
        self._fn = None
        self._fn_cache: dict = {}             # trace key -> built pipeline
        self._shot_cache = None               # (key, source-size frame fn)
        self._rotation = 0
        self._flip = False
        self._stereo3d_transform = 0
        self._user_post_fns: list[Callable] = []
        self._user_pre_fns: list[Callable] = []
        self._last_input = None
        self._last_output = None
        self._deint = None                 # settings-driven VP deint session
        self._deint_prev_time = None       # stream time of the pending frame
        self._subpic_queue = None          # subtitles.SubPicQueue(-NoThread)
        self._alpha_bitmap = None          # (rgb (3,h,w), alpha (h,w), x, y)
        self._superres = None              # SuperRes on self.device
        self._videohdr = None              # VideoHDR on self.device
        self._uploads: dict = {}           # id(host bitmap) -> device copy
        self._stereo3d_offset = 4          # MediaSideData3DOffset (default 4,
                                           # Source/VideoProcessor.h:162)
        self._stepping = 0                 # armed frame-step counter
        self._step_complete = False
        self._on_step_complete = None      # optional EC_STEP_COMPLETE cb
        self.metrics = Metrics()

    # -- IVideoRenderer -------------------------------------------------------

    def get_active(self) -> bool:
        return self._fn is not None

    def get_settings(self) -> Settings:
        return self.settings

    def set_settings(self, settings: Settings) -> None:
        """Live reconfiguration: rebuilds only if the new settings change the
        computation (Configure's diff-and-rebuild,
        Source/DX11VideoProcessor.cpp:3812-4062): an unchanged pipeline is
        a hit of the cache of built frame functions."""
        old = self.settings
        self.settings = settings.validate()
        if self._src is not None and self.settings != old:
            self._rebuild()
            if self._last_input is not None:
                self._last_output = self._fn(self._last_input)

    def save_settings(self, path: str) -> None:
        self.settings.save(path)

    def get_video_processor_info(self) -> str:
        """GetVPInfo analogue (Source/DX11VideoProcessor.cpp:3698-3810)."""
        cuda = self.device.type == "cuda"
        lines = [f"videorenderer_tpu_torch {__version__}"]
        lines.append("Device: " + (torch.cuda.get_device_name(self.device)
                                   if cuda else "cpu"))
        lines.append(f"Backend: {self.device.type}"
                     + (f" ({torch.cuda.device_count()} device(s))"
                        if cuda else ""))
        if self._plan:
            psrc = self._plan.src  # post-SpecifyExtendedFormat values
            info = get_format_info(psrc.format)
            lines.append(f"Input: {info.name} {psrc.width}x{psrc.height}"
                         f" matrix={psrc.matrix.name}"
                         f" primaries={psrc.primaries.name}"
                         f" transfer={psrc.transfer.name}")
        if self._dst:
            lines.append(f"Output: {self._dst.width}x{self._dst.height}"
                         f" {self._dst.bits}-bit hdr={self._dst.hdr}")
        if self._plan:
            p = self._plan
            s = p.settings
            lines.append(f"ConvertToSDR: {p.convert_to_sdr}; "
                         f"HLG->PQ: {p.hlg_to_pq}; "
                         f"LocalToneMap: {p.local_tonemap}; "
                         f"DolbyVision: {p.dovi is not None}")
            lines.append(f"Chroma scaling: {s.chroma_scaling.name}; "
                         f"Upscaling: {s.upscaling.name}; "
                         f"Downscaling: {s.downscaling.name}; "
                         f"Dither: {'ordered' if s.use_dither else 'round'}")
            path = ("fused linear-prefix" if route_of(p) == "fused"
                    else "staged")
            if s.use_accel_backend and cuda:
                backend = "CUDA kernels (sm_90a)"
            else:
                backend = f"plain PyTorch ({'CUDA' if cuda else 'CPU'})"
            lines.append(f"Pipeline: {path}; resampling backend: {backend}")
            if self._deint is not None:
                rate = "double" if self.settings.deint_double else "single"
                lines.append(f"Deinterlacing: motion-adaptive ({rate}-rate)")
            if self._superres is not None:
                lines.append(f"SuperRes model: loaded "
                             f"(engaged: {self._superres_engaged()})")
            if self._videohdr is not None:
                lines.append(f"VideoHDR model: loaded "
                             f"(engaged: {self._videohdr_engaged()})")
        return "\n".join(lines)

    # -- IExFilterConfig ("Flt_Get*/Flt_Set*") ---------------------------------

    def flt_get(self, key: str):
        if key == "displayedImage":
            return self.get_displayed_image()
        return {
            "rotation": self._rotation,
            "flip": self._flip,
            "stereo3dTransform": self._stereo3d_transform,
            "statsEnable": self.settings.show_stats,
            "lessRedraws": getattr(self, "_less_redraws", False),
            "version": __version__,
        }[key]

    def flt_set(self, key: str, value) -> None:
        if key == "rotation":
            if value not in (0, 90, 180, 270):
                raise ValueError("rotation must be 0/90/180/270")
            self._rotation = value
        elif key == "flip":
            self._flip = bool(value)
        elif key == "stereo3dTransform":
            self._stereo3d_transform = int(value)
        elif key == "statsEnable":
            self.settings = dataclasses.replace(self.settings,
                                                show_stats=bool(value))
        elif key == "lessRedraws":
            self._less_redraws = bool(value)
            return
        elif key == "cmd_addPostScaleShader":
            self._user_post_fns.append(value)
        elif key == "cmd_addPreScaleShader":
            self._user_pre_fns.append(value)
        elif key == "cmd_clearPostScaleShaders":
            self._user_post_fns.clear()
        elif key == "cmd_clearPreScaleShaders":
            self._user_pre_fns.clear()
        elif key == "cmd_redraw":
            if self._last_input is not None:
                self._last_output = self._fn(self._last_input)
            return
        else:
            raise KeyError(key)
        if self._src is not None:
            self._rebuild()

    # -- media type / processing ----------------------------------------------

    def _on_device(self, model):
        """``model`` with its weights on the renderer's device: the model
        itself when they are there already, else a moved copy (the
        caller's model stays where it is)."""
        if all(p.device == self.device for p in model.parameters()):
            return model
        return copy.deepcopy(model).to(self.device)

    def set_superres_params(self, params) -> None:
        """Load the learned upscaler (the SuperRes slot,
        Source/D3D11VP.cpp:712-844): ``params`` a
        :class:`~.models.superres.SuperRes` (or None to unload).  Engages when
        ``Settings.vp_superres`` gates allow it and the target is larger
        than the source; it then *replaces* the separable upscaler like the
        vendor block replaces VP scaling."""
        self._superres = None if params is None else self._on_device(params)
        if self._src is not None:
            self._rebuild()

    def set_videohdr_params(self, params) -> None:
        """Load the learned SDR->HDR model (the RTX Video HDR slot,
        Source/D3D11VP.cpp:846-891): ``params`` a
        :class:`~.models.videohdr.VideoHDR` (or None); engages per
        ``vp_rtx_video_hdr`` on 8-bit SDR sources with an HDR output."""
        self._videohdr = None if params is None else self._on_device(params)
        if self._src is not None:
            self._rebuild()

    def open(self, src: SourceDescriptor, dst: OutputDescriptor) -> None:
        """SetMediaType + InitMediaType + InitSwapChain analogue."""
        self._src = src
        self._dst = dst
        self._rebuild()

    def get_output_signal_info(self):
        """What the output pixels are — colorspace/transfer + HDR10
        mastering/CLL metadata (the SetColorSpace1/SetHDRMetaData state,
        Source/DX11VideoProcessor.cpp:2629-2739).  With 90/270 rotation the
        plan runs at swapped dims (SuperRes runs it 1:1); this reports the
        real surface, PQ / BT.2020 when VideoHDR makes it."""
        info = dataclasses.replace(output_signal_info(self._plan),
                                   width=self._dst.width,
                                   height=self._dst.height)
        if self._videohdr_engaged():
            # the net emits PQ/BT.2020 (RTX Video HDR analogue)
            info = dataclasses.replace(
                info, primaries=Primaries.BT_2020.name, transfer=TRC.PQ.name,
                bits=self._dst.bits, hdr10=info.hdr10 or HDR10Metadata())
        return info

    def _superres_engaged(self) -> bool:
        """The size gate alone decides (SetSuperRes semantics,
        Source/D3D11VP.cpp:804-844) — non-integer upscale targets engage
        too: the net performs its native 2x and a classical resample
        covers the remainder (see _rebuild)."""
        if self._superres is None:
            return False
        return sr_model.superres_engages(self.settings.vp_superres,
                                         self._src.width, self._src.height,
                                         self._dst.width, self._dst.height)

    def _superres_resample(self, target_w: int, target_h: int):
        """None when the target is exactly the net's native scale; else the
        (H map, W map) resampling the net's output to the target, as float32
        tensors on the renderer's device — chosen by the plan's own scaler
        selection rule per axis.  ``target_*`` are the pipeline-side dims
        (rotation-swapped by the caller)."""
        s = self._superres.cfg.scale
        nw, nh = self._src.width * s, self._src.height * s
        if (target_w, target_h) == (nw, nh):
            return None
        st = self.settings
        cx = scale_ops.select_scaler(nw, target_w, st.upscaling,
                                     st.downscaling, st.interpolate_at_50pct)
        cy = scale_ops.select_scaler(nh, target_h, st.upscaling,
                                     st.downscaling, st.interpolate_at_50pct)
        return tuple(
            None if m is None else torch.as_tensor(
                m, dtype=torch.float32, device=self.device)
            for m in (scale_ops.build_axis_matrix(cy, nh, target_h),
                      scale_ops.build_axis_matrix(cx, nw, target_w)))

    def _videohdr_engaged(self) -> bool:
        return (self._videohdr is not None
                and self.settings.vp_rtx_video_hdr
                and self._dst.hdr
                and get_format_info(self._src.format).depth == 8
                and not self._src.is_hdr)

    def _trace_key(self):
        """Everything that determines the built pipeline (Configure's diff
        set).  Models and user shader fns key by identity; may raise
        TypeError when a descriptor holds arrays (DoVi metadata) — the
        caller then skips the cache."""
        sr, vh = self._superres, self._videohdr
        key = (self.settings.trace_relevant(), self._src, self._dst,
               self._rotation, self._flip, self._stereo3d_transform,
               tuple(self._user_pre_fns), tuple(self._user_post_fns),
               None if sr is None else id(sr),
               None if vh is None else id(vh),
               self._pack_surface)
        hash(key)
        return key

    def _rebuild(self) -> None:
        self._uploads = {}
        try:
            key = self._trace_key()
            hit = self._fn_cache.get(key)
        except TypeError:
            key = hit = None
        if hit is not None:
            self._plan, self._fn, self._out_fmt, self._deint = hit
            if self._deint is not None:
                # re-Configure resets the VP reference-frame ring; the built
                # field functions stay on the session
                self._deint.reset()
            return

        src, dst = self._src, self._dst
        if self._rotation in (90, 270):
            # the reference resizes into the rotated destination (axis-swapped
            # scaling shaders, ResizeShaderPass DX11VideoProcessor.cpp:3125-3135):
            # run the pipeline at swapped dims, rotate into the real surface
            vr = dst.video_rect
            dst = dataclasses.replace(
                dst, width=dst.height, height=dst.width,
                video_rect=None if vr is None else (vr[1], vr[0], vr[3], vr[2]))
        sr_engaged = self._superres_engaged()
        hdr_engaged = self._videohdr_engaged()
        sr_maps = None
        if sr_engaged:
            # the model replaces the separable upscaler: the pipeline runs
            # 1:1, the net performs its native 2x expansion; non-integer
            # targets get a classical resample from the net's output (the
            # driver SR blocks serve arbitrary upscales the same way)
            sr_maps = self._superres_resample(dst.width, dst.height)
            dst = dataclasses.replace(dst, width=src.width, height=src.height)
        if hdr_engaged:
            # deliver SDR RGB from the pipeline; the net produces PQ/2020
            dst = dataclasses.replace(dst, hdr=False)
        self._plan = plan_pipeline(self.settings, src, dst)
        # reference post-scale order: corrections -> tone map -> USER
        # SHADERS -> halfOU interlace -> FinalPass dither
        # (Source/DX11VideoProcessor.cpp:3337-3428).  With user shaders,
        # the stereo transform or a resample after SuperRes active, the
        # pipeline's final dither must move AFTER them: build the base
        # undithered and quantize at the end of the wrapper chain.
        ext_tail = (bool(self._user_pre_fns) or bool(self._user_post_fns)
                    or self._stereo3d_transform == 1 or sr_maps is not None)
        ext_dither = (self._plan.dither_bits
                      if ext_tail and self._plan.dither_bits else 0)
        base_plan = (dataclasses.replace(self._plan, dither_bits=0)
                     if ext_dither else self._plan)
        # packed-surface output: when nothing post-processes the planar RGB
        # the kernels pack in-kernel; a float tail (user shaders, stereo)
        # defers the packing to the end of the wrapper chain — either way
        # self._fn emits packed dwords
        fmt = surface_pack_format(self._dst) if self._pack_surface else None
        float_tail = (ext_tail or sr_engaged or hdr_engaged
                      or bool(self._rotation) or self._flip)
        # rotation/flip permute whole pixels, and a packed dword IS one
        # pixel: when geometry is the ONLY float tail, keep the in-kernel
        # pack and rotate the packed int32 surface instead.  The dither
        # phase stays pre-rotation either way (the plan runs at swapped
        # dims), matching the reference's rotated-resize semantics
        # (ResizeShaderPass, Source/DX11VideoProcessor.cpp:3125-3135).
        geo_only_tail = (fmt is not None and float_tail and not ext_tail
                         and not sr_engaged and not hdr_engaged)
        in_kernel_pack = fmt is not None and (not float_tail or geo_only_tail)
        rotation, flip = self._rotation, self._flip
        # geometry-only tails hand rotation to make_frame_fn (on the
        # one-pass Jinc2 route a transposed store); the deinterlace session
        # rotates its packed fields in its post function
        base = make_frame_fn(base_plan, pack_surface=in_kernel_pack,
                             rotation=rotation if geo_only_tail else 0,
                             flip=flip if geo_only_tail else False)
        stereo = self._stereo3d_transform
        shaders = tuple(self._user_pre_fns) + tuple(self._user_post_fns)
        sr = self._superres if sr_engaged else None
        vh = self._videohdr if hdr_engaged else None

        def tail(rgb):
            # the float tail (not the geometry-only one): the learned
            # enhancement slots first (they replace/extend the VP stage,
            # Source/D3D11VP.cpp:712-891), then the geometry + user-shader
            # chain rides the post-scale ring
            # (Source/DX11VideoProcessor.cpp:3337-3428), then the pack
            if sr is not None:
                rgb = sr_model.enhance_plane_chw(sr, rgb)
                if sr_maps is not None:
                    my, mx = sr_maps
                    if mx is not None:
                        rgb = scale_ops.resize_axis(rgb, mx, -1)
                    if my is not None:
                        rgb = scale_ops.resize_axis(rgb, my, -2)
            if vh is not None:
                rgb = vh_model.enhance_plane_chw(vh, rgb)
            if rotation or flip:
                rgb = geo_ops.rotate_flip(rgb, rotation, flip)
            for f in shaders:
                rgb = f(rgb)
            if stereo == 1:
                rgb = geo_ops.half_overunder_to_interlace(rgb)
            if ext_dither:
                rgb = torch.clamp(rgb, 0.0, 1.0)
                rgb = (dither_ops.quantize(rgb, -ext_dither) if ext_dither < 0
                       else dither_ops.ordered_dither(rgb, ext_dither))
            if fmt is not None:
                rgb = rk.pack_surface(rgb, fmt)
            return rgb

        if float_tail and not geo_only_tail:
            self._fn = lambda planes: tail(base(planes))
        else:
            self._fn = base
        self._out_fmt = fmt
        # settings-driven VP deinterlacing (InitMediaType routes interlaced
        # sources through the rate-converting VP per vp_deinterlacing /
        # deint_double, Source/DX11VideoProcessor.cpp:2209-2225; deint_blend
        # instead folds a field blend into the pipeline itself)
        deint_on = (self._src.interlaced
                    and self.settings.vp_deinterlacing
                    and not self.settings.deint_blend)
        self._deint = None
        if deint_on:
            if not float_tail:
                post = None
            elif geo_only_tail:     # rotate the packed fields
                post = lambda out: geo_ops.rotate_flip(out, rotation, flip)
            else:
                post = tail
            self._deint = DeinterlaceSession(
                base_plan, double_rate=self.settings.deint_double,
                top_field_first=self._src.top_field_first,
                pack_surface=in_kernel_pack, post=post, device=self.device)
        if key is not None:
            if len(self._fn_cache) >= 8:
                self._fn_cache.pop(next(iter(self._fn_cache)))
            self._fn_cache[key] = (self._plan, self._fn, self._out_fmt,
                                   self._deint)

    def _recover(self) -> None:
        """Device-lost analogue: count the failed frame and build the
        pipeline anew (the reference's swap-chain re-create on
        DXGI_ERROR_INVALID_CALL, Source/DX11VideoProcessor.cpp:2820-2822;
        failed frames counted, not fatal: m_RenderStats.failed).  The same
        device and the same kernels: nothing falls back."""
        self.metrics.render_stats.failed += 1
        try:
            self._fn_cache.pop(self._trace_key(), None)
        except TypeError:
            pass
        self._rebuild()

    def _sync(self) -> None:
        """Wait for the renderer's stream, so that paint_s covers device
        time."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- subtitles / OSD overlays ----------------------------------------------

    def set_subtitle_provider(self, provider, threaded: bool = True) -> None:
        """Connect a subtitle provider (ISubPicProvider analogue); frames
        processed with a ``time`` argument get subpics composited
        (DrawSubtitles, Source/DX11VideoProcessor.cpp:3247-3295).  The
        queue's worker thread rasterises numpy bitmaps only; the uploads
        happen on the render thread."""
        from .subtitles import SubPicQueue, SubPicQueueNoThread
        if self._subpic_queue is not None:
            self._subpic_queue.stop()
        if provider is None:
            self._subpic_queue = None
        else:
            cls = SubPicQueue if threaded else SubPicQueueNoThread
            self._subpic_queue = cls(provider)

    def set_stereo3d_offset(self, pixels: int) -> None:
        """MediaSideData3DOffset analogue
        (Source/DX11VideoProcessor.cpp:2267-2274): horizontal subtitle/OSD
        shift for stereo content; applied only while the Half-OverUnder ->
        Interlace transform is active, like the reference's Render11 call
        (Source/DX11VideoProcessor.cpp:3289-3290)."""
        self._stereo3d_offset = int(pixels)

    def set_alpha_bitmap(self, rgb, alpha, x: int = 0, y: int = 0) -> None:
        """IMFVideoMixerBitmap::SetAlphaBitmap analogue
        (Source/DX11VideoProcessor.cpp:4553-4623); pass rgb=None to clear."""
        if rgb is None:
            self._alpha_bitmap = None
        else:
            self._alpha_bitmap = (np.asarray(rgb, np.float32),
                                  np.asarray(alpha, np.float32), x, y)

    def _has_overlays(self) -> bool:
        return (self._subpic_queue is not None
                or self._alpha_bitmap is not None or self.settings.show_stats)

    def _prep(self, rgb) -> torch.Tensor:
        """A host bitmap on the renderer's device; SDR-authored overlays on
        a PQ output get pre-compensated to the selected OSD luminance
        (ps_convert_bitmap_to_pq.hlsl)."""
        t = torch.as_tensor(rgb, device=self.device)
        if self._dst is not None and self._dst.hdr:
            return sdr_bitmap_to_pq(t, self.settings.hdr_osd_brightness)
        return t

    def _uploaded(self, owner, rgb, alpha, kept: dict):
        """The device copies of a bitmap that stays the same from frame to
        frame (a subpic while it is shown, the alpha bitmap), uploaded once;
        ``owner`` keeps its id from being reused while it is cached."""
        hit = self._uploads.get(id(owner))
        if hit is None or hit[0] is not owner:
            hit = (owner, self._prep(rgb),
                   torch.as_tensor(alpha, device=self.device))
        kept[id(owner)] = hit
        return hit[1], hit[2]

    def _composite_overlays(self, out, time: float | None):
        """Draw subtitles / alpha bitmap / stats OSD onto the output.  On a
        packed surface this blends directly against the quantized dword
        backbuffer (ops.overlay.blend_in_rect_packed), as the reference
        draws all overlays on the swap-chain backbuffer after the dithered
        final pass (Source/DX11VideoProcessor.cpp:2741-2767).  The blends
        return new tensors: ``out`` is left as it was."""
        if self._out_fmt is not None:
            fmt = self._out_fmt
            blend = lambda base, rgb, a, x, y: blend_in_rect_packed(
                base, rgb, a, x=x, y=y, fmt=fmt)
        else:
            blend = lambda base, rgb, a, x, y: blend_in_rect(
                base, rgb, a, x=x, y=y)

        # stereo 3D: shift subtitles horizontally by the side-data offset
        # while the half-OU -> interlace transform is active
        xoff = (self._stereo3d_offset
                if self._stereo3d_transform == 1 else 0)
        kept: dict = {}
        if self._subpic_queue is not None and time is not None:
            for p in self._subpic_queue.lookup(time):
                rgb, a = self._uploaded(p, p.rgb, p.alpha, kept)
                out = blend(out, rgb, a, p.x + xoff, p.y)
        if self._alpha_bitmap is not None:
            rgb, alpha, x, y = self._alpha_bitmap
            rgb, a = self._uploaded(self._alpha_bitmap, rgb, alpha, kept)
            out = blend(out, rgb, a, x + xoff, y)
        self._uploads = kept
        if self.settings.show_stats:
            from .osd import render_stats_overlay
            rgb, alpha = render_stats_overlay(
                self.metrics.snapshot(),
                graph_values=self.metrics.sync_graph.values())
            h = min(alpha.shape[0], out.shape[-2] - 8)
            w = min(alpha.shape[1], out.shape[-1] - 8)
            out = blend(out, self._prep(rgb[:, :h, :w]),
                        torch.as_tensor(alpha[:h, :w], device=self.device),
                        8, 8)
        return out

    @trace.spanned(trace.CALL)
    def process_frame(self, frame_or_planes, time: float | None = None):
        """ProcessSample analogue. Returns the processed (…,3,H,W) tensor —
        or, when settings-driven VP deinterlacing is active on an interlaced
        source, a **list of 0-2 output frames** (0 while the one-frame
        lookahead window fills, 2 per frame with ``deint_double``), matching
        the reference's Receive path rendering one or two fields per sample
        (Source/DX11VideoProcessor.cpp:2176-2200).  Call :meth:`flush` at
        end-of-stream to drain the final frame.
        ``time`` (stream seconds) drives subtitle lookup."""
        if self._fn is None:
            raise RuntimeError("open() a media type first")
        planes = (frame_or_planes.planes
                  if isinstance(frame_or_planes, PlanarFrame)
                  else tuple(frame_or_planes))
        t0 = precise_tick()
        planes = tuple(torch.as_tensor(p, device=self.device) for p in planes)
        self.metrics.render_stats.copy_s = precise_tick() - t0
        self.metrics.input_stats.add(precise_tick())
        t1 = precise_tick()
        if self._deint is not None:
            outs = self._process_deint(planes, time)
            self.metrics.render_stats.paint_s = precise_tick() - t1
            self._last_input = planes
            self._step_advance()
            return outs
        try:
            out = self._run(planes, time)
        except DEVICE_ERRORS:
            self._recover()
            try:
                out = self._run(planes, time)
            except DEVICE_ERRORS:
                self.metrics.render_stats.failed += 1
                raise
        self.metrics.render_stats.paint_s = precise_tick() - t1
        self.metrics.draw_stats.frame_drawn()
        self._last_input = planes
        self._last_output = out
        self._step_advance()
        return out

    def _process_deint(self, planes, time):
        """Push one interlaced frame through the motion-adaptive window and
        present whatever emits.  Emitted frames belong to the *previous*
        pushed frame (its future reference just arrived); field 1 of a
        double-rate pair presents half a frame duration later
        (rtStart + rtFrameDur/2, Source/DX11VideoProcessor.cpp:2176-2185)."""
        prev_time, self._deint_prev_time = self._deint_prev_time, time
        try:
            raw = self._deint.push(planes)
        except DEVICE_ERRORS:
            self._recover()     # fresh session: the window restarts
            raw = self._deint.push(planes)
        return self._present_fields(raw, prev_time)

    def _present_fields(self, raw, base_time):
        half = self.metrics.input_stats.average_duration() / 2
        outs = []
        for i, out in enumerate(raw):
            t = None if base_time is None else base_time + (half if i else 0.0)
            if self._has_overlays():
                out = self._composite_overlays(out, t)
            self._sync()
            self.metrics.draw_stats.frame_drawn()
            outs.append(out)
        if outs:
            self._last_output = outs[-1]
        return outs

    def flush(self) -> list:
        """End-of-stream drain (the EndOfStream -> final-field render): emits
        the last interlaced frame's field(s) with a clamped future reference.
        Progressive sessions have nothing buffered and return []."""
        if self._deint is None:
            return []
        t, self._deint_prev_time = self._deint_prev_time, None
        return self._present_fields(self._deint.flush(), t)

    def _step_advance(self) -> None:
        if self._stepping > 0:
            self._stepping -= 1
            if self._stepping == 0:
                # EC_STEP_COMPLETE analogue (Source/VideoRenderer.cpp:510-512)
                self._step_complete = True
                if self._on_step_complete is not None:
                    self._on_step_complete()

    # -- frame stepping (IKsPropertySet AM_KSPROPSETID_FrameStep,
    #    Source/VideoRenderer.cpp:777-785) ------------------------------------

    def frame_step(self, frames: int = 1) -> None:
        """Arm a frame-step: after ``frames`` more processed frames the step
        completes (AM_PROPERTY_FRAMESTEP_STEP; the graph would then pause)."""
        if frames < 1:
            raise ValueError("frames must be >= 1")
        self._stepping = int(frames)
        self._step_complete = False

    def can_step(self) -> bool:
        """AM_PROPERTY_FRAMESTEP_CANSTEP(MULTIPLE): always supported."""
        return True

    def cancel_step(self) -> None:
        self._stepping = 0
        self._step_complete = False

    def step_completed(self) -> bool:
        """Poll-and-clear the EC_STEP_COMPLETE notification."""
        done = self._step_complete
        self._step_complete = False
        return done

    def _run(self, planes, time):
        out = self._fn(planes)
        if self._has_overlays():
            out = self._composite_overlays(out, time)
        self._sync()
        return out

    # -- screenshots -----------------------------------------------------------

    def get_displayed_image(self, as_uint: bool = True):
        """displayedImage: the last output frame
        (Source/DX11VideoProcessor.cpp:3622-3696).  8-bit outputs return
        interleaved uint8 RGB; 10-bit outputs return interleaved **BGR48**
        (uint16, codes MSB-aligned <<6) exactly as the reference converts
        its 10-bit backbuffer (ConvertR10G10B10A2toBGR48,
        Source/Helper.cpp:836-857)."""
        if self._last_output is None:
            return None
        out = self._last_output.cpu().numpy()
        if self._out_fmt is not None:           # packed dword surface
            dwords = out.view(np.uint32)
            if not as_uint:
                return (unpack_rgb10(dwords) if self._out_fmt == "rgb10a2"
                        else unpack_rgba8(dwords))
            if self._out_fmt == "rgb10a2":
                return rgb10_dwords_to_bgr48(dwords)
            return pack_rgb8(unpack_rgba8(dwords))
        img = np.moveaxis(out, -3, -1)
        if not as_uint:
            return img
        if self._dst.bits == 10:
            return rgb10_dwords_to_bgr48(pack_rgb10(img))
        return pack_rgb8(img)

    def get_current_image(self):
        """GetCurrentImage: the current frame converted to RGB at *source*
        size, bypassing scaling (Source/DX11VideoProcessor.cpp:3505-3620).
        The conversion is built once per media type, so repeated
        screenshots never rebuild it."""
        if self._last_input is None:
            return None
        try:
            key = (self.settings.trace_relevant(), self._src)
            hash(key)
        except TypeError:
            key = None
        if key is None or self._shot_cache is None \
                or self._shot_cache[0] != key:
            shot_dst = OutputDescriptor(width=self._src.width,
                                        height=self._src.height, bits=8)
            plan = plan_pipeline(self.settings, self._src, shot_dst)
            self._shot_cache = (key, make_frame_fn(plan))
        out = self._shot_cache[1](self._last_input)
        return pack_rgb8(np.moveaxis(out.cpu().numpy(), -3, -1))

    # -- stats -----------------------------------------------------------------

    def get_stats(self) -> dict:
        return self.metrics.snapshot()

    def record_sync_offset(self, offset_s: float) -> None:
        """Feed a presentation sync offset (e.g. ``PresentClock.wait_for``'s
        return) into the IQualProp accounting (avg/dev sync offset,
        Source/renbase2.cpp:185-188) and the OSD sync graph."""
        self.metrics.render_stats.record_sync_offset(offset_s)
        self.metrics.sync_graph.add(offset_s)
