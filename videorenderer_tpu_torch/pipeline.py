"""Pipeline builder: (Settings, source, output) -> a frame function on torch
tensors.

Port of the main path of ``videorenderer_tpu.pipeline``, the analogue of the
reference's media-type negotiation (CDX11VideoProcessor::InitMediaType,
Source/DX11VideoProcessor.cpp:1742-1959), shader codegen
(GetShaderConvertColor, Source/Shaders.cpp:593-930) and render passes
(CDX11VideoProcessor::Process, Source/DX11VideoProcessor.cpp:3297-3436).

Two paths, chosen as the JAX package chooses them (:func:`route_of`):

 * The fused linear-resample path (VP order, separable scalers): chroma
   upsampling and the separable resize compose into one banded matrix per
   plane and axis, so the colour matrix, transfer functions, tone map and
   dither all run at output resolution.  With ``Settings.use_accel_backend``
   (the default) it runs as kernel K1 (the W pass of each plane, int16
   "mid16" intermediates) and kernel K2 (the H pass of all three planes, the
   colour matrix, the corrections, the dither and the surface pack); their
   wrappers take the plain versions for CPU tensors.  With
   ``use_accel_backend=False`` the same math runs as plain PyTorch (dense
   float32 products, then the tail), like the JAX package's XLA path.
 * The staged path (the Jinc2 upscaler, whose 2D one-pass shader is not
   separable, or ``fused=False``): convert at source resolution, resize,
   then the tail.  On a CUDA device YUV planes take the kernels: K6 does
   everything from the raw planes to the dithered surface when the tail is
   a dither only; otherwise K1 and K2 convert, and K5 runs the Jinc2 (with
   the dither inside, or before the torch tail).

Rotation and flip apply to the finished surface, except rotation 90 with
flip, a pure transpose, which K6 does as a transposed store.

Interlaced sources: :func:`make_deint_frame_fn` deinterlaces in torch and
runs :func:`make_frame_fn`; :func:`make_deint_fields_fn` renders both fields
of a frame through K7 (the deinterlace inside the H resize) and K9 (the W
resize and the tail), H first.

Dolby Vision (``SourceDescriptor.dovi``) splits the fused path at the
nonlinear reshape (:func:`_make_dovi_fused_fn`): K1 on the chroma, K8 (the
H maps around the reshape, RPU matrix and LMS step), K9; with
``VRT_TPU_DOVI_MID=0`` the two-stage form, K1 on the chroma and K2's Dolby
Vision route at source resolution, then K1 ×3 and K2.
An HDR passthrough with ``Settings.hdr_local_tone_mapping`` (c7: 4K HDR10
to a 600-nit display, BT.2390) runs the local tone map inside K2's tail,
its five scalars per launch; HDR10+ metadata (``SourceDescriptor.hdr10plus``)
substitutes the scene's statistics and, with a guided curve in its window,
selects the ST 2094-40 curve (selection 7), and Dolby Vision extension
blocks (``dovi_ext``) resolve into the tone map's parameters and the L2
trims (``dovi_trims``), which run in K9's (or K2's) tail: in the PQ domain
before PQ -> SDR, in nits before the local tone map of an HDR output.
:func:`make_serving_fn` takes a scene's curves, colour matrix, HDR10
values and L2 trims per call; :func:`output_signal_info` says what the
output pixels are.
A letterboxed or pillarboxed output (``OutputDescriptor.video_rect``) keeps
its route: K2 (or K9 for Dolby Vision) stores the video into the surface at
the rect's origin, dithered from the video's own origin, and torch writes
the bars.  A GRAY source runs K1 and K3 on its one plane, then the tail in
torch.  The shader order (``Settings.vp_scaling=False``) runs the
corrections at source resolution, inside K2's convert on a card.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import csputils
from .config import Settings, TexFormat, Upscaling
from .csputils import (CSP, ChromaLocation, Colorspace, CSPParams, Levels,
                       Primaries, TRC)
from .formats import ColorFormat, ColorSystem, FormatInfo, get_format_info
from .kernels import deint as dk
from .kernels import jinc2 as jk
from .kernels import resize as rk
from .ops import chroma as chroma_ops
from .ops import deinterlace as deint_ops
from .ops import dither as dither_ops
from .ops import dovi as dovi_ops
from .ops import dovi_ext as dovi_ext_ops
from .ops import geometry as geo_ops
from .ops import hdr10plus as h10p_ops
from .ops import scale as scale_ops
from .ops import tonemap as tonemap_ops
from .ops import transfer as transfer_ops
from .utils import trace


@dataclass(frozen=True)
class HDR10Metadata:
    """HDR10 static metadata carried as media side data
    (MediaSideDataHDR / ...ContentLightLevel, consumed in
    Source/DX11VideoProcessor.cpp:2232-2267)."""

    mastering_min_nits: float = 0.005
    mastering_max_nits: float = 1000.0
    max_cll: float = 1000.0
    max_fall: float = 400.0


@dataclass(frozen=True)
class SourceDescriptor:
    """Media type + DXVA2 extended-format analogue (what InitMediaType
    parses from VIDEOINFOHEADER2, Source/DX11VideoProcessor.cpp:1757-1821).
    The same fields as the JAX package's: ``dovi`` takes an
    :class:`~.ops.dovi.DoviMetadata`, ``dovi_trims`` an
    :class:`~.ops.tonemap.DoviTrims`, ``dovi_ext`` an
    :class:`~.ops.dovi_ext.DoviExtensions` (resolved at plan time into the
    tone map's parameters, the trims and the output's HDR10 metadata, as
    CopySample does) and ``hdr10plus`` an
    :class:`~.ops.hdr10plus.HDR10PlusMetadata`."""

    format: ColorFormat
    width: int
    height: int
    matrix: CSP = CSP.AUTO
    levels: Levels = Levels.AUTO
    primaries: Primaries = Primaries.AUTO
    transfer: TRC = TRC.AUTO
    chroma_location: ChromaLocation = ChromaLocation.UNKNOWN
    interlaced: bool = False
    top_field_first: bool = True
    hdr10: HDR10Metadata | None = None
    dovi: "object | None" = None
    dovi_trims: "object | None" = None
    dovi_ext: "object | None" = None
    hdr10plus: "object | None" = None
    # source crop rectangle (left, top, right, bottom) — the IBasicVideo
    # SetSourcePosition analogue; None = full frame
    src_rect: tuple[int, int, int, int] | None = None
    # ProcAmp (IMFVideoProcessor, Source/VideoProcessor.cpp:334-403)
    brightness: float = 0.0   # -1..1
    contrast: float = 1.0
    hue_deg: float = 0.0
    saturation: float = 1.0

    def specified(self) -> "SourceDescriptor":
        """Apply SpecifyExtendedFormat defaulting (Source/Helper.cpp:1169-1212)
        + set_colorspace mapping (Source/Helper.cpp:949-1004)."""
        info = get_format_info(self.format)
        d = self
        if info.cs_type == ColorSystem.RGB:
            return dataclasses.replace(
                d, matrix=CSP.RGB, levels=Levels.PC,
                primaries=(d.primaries if d.primaries != Primaries.AUTO
                           else Primaries.BT_709),
                transfer=(d.transfer if d.transfer != TRC.AUTO else TRC.SRGB),
                chroma_location=ChromaLocation.UNKNOWN)
        chroma_loc = self.chroma_location
        if info.subsampling != 420:
            chroma_loc = ChromaLocation.UNKNOWN
        elif chroma_loc == ChromaLocation.UNKNOWN:
            chroma_loc = ChromaLocation.MPEG2
        levels = d.levels if d.levels != Levels.AUTO else Levels.TV
        matrix = d.matrix
        if matrix == CSP.AUTO:
            matrix = csputils.default_matrix_for_size(d.width, d.height)
        primaries = d.primaries if d.primaries != Primaries.AUTO else Primaries.BT_709
        transfer = d.transfer if d.transfer != TRC.AUTO else TRC.BT_1886
        return dataclasses.replace(
            d, matrix=matrix, levels=levels, primaries=primaries,
            transfer=transfer, chroma_location=chroma_loc)

    @property
    def is_hdr(self) -> bool:
        return self.transfer in (TRC.PQ, TRC.HLG)


@dataclass(frozen=True)
class OutputDescriptor:
    """Target surface description (swap-chain analogue)."""

    width: int
    height: int
    bits: int = 8            # quantization depth: 8 / 10; 16 = float out
    hdr: bool = False        # True: PQ/BT.2020 output (HDR passthrough)
    # placement of the video inside the surface (letterbox/pillarbox):
    # (left, top, right, bottom), black around it; None = the whole surface
    video_rect: tuple[int, int, int, int] | None = None

    @property
    def video_size(self) -> tuple[int, int]:
        if self.video_rect is None:
            return self.width, self.height
        l, t, r, b = self.video_rect
        return r - l, b - t


@dataclass(frozen=True)
class PipelinePlan:
    """Resolved static plan — everything the frame function needs."""

    settings: Settings
    src: SourceDescriptor
    dst: OutputDescriptor
    info: FormatInfo
    cmat_m: np.ndarray     # (3,3)
    cmat_c: np.ndarray     # (3,)
    apply_matrix: bool
    convert_to_sdr: bool       # PQ or HLG -> SDR (Hable + 2020->709 + gamma)
    hlg_to_pq: bool            # HDR passthrough of HLG source
    fix_bt2020_sdr: bool       # SDR BT.2020 primaries -> 709 display
    sdr_gamma: float           # source power gamma for fix_bt2020_sdr
    dither_bits: int           # +b ordered dither, -b round, 0 float out
    src_rect: tuple[int, int, int, int] | None = None
    tonemap_params: tonemap_ops.HDRParams | None = None
    dovi: dovi_ops.DoviMetadata | None = None
    # the local tone map of the HDR passthrough (ps_hdr10_tonemap.hlsl) and
    # its operator (ToneMapType, possibly upgraded: 5 -> 6 by DoVi L1, 7 by
    # an HDR10+ guided curve)
    local_tonemap: bool = False
    tonemap_type: int = 0
    dovi_trims: tonemap_ops.DoviTrims | None = None
    dovi_ext: dovi_ext_ops.DoviExtensions | None = None
    # the HDR10+ window whose knee and anchors selection 7 runs (plan
    # structure, like the DoVi reshape's curves)
    hdr10plus_window: h10p_ops.HDR10PlusWindow | None = None
    # output-side HDR10 static metadata (swap-chain SetHDRMetaData analogue,
    # Source/DX11VideoProcessor.cpp:2629-2739): what a sink should program
    output_hdr10: HDR10Metadata | None = None


def _build_cmat(src: SourceDescriptor, info: FormatInfo
                ) -> tuple[np.ndarray, np.ndarray, bool]:
    """Color matrix exactly as SetShaderConvertColorParams
    (Source/DX11VideoProcessor.cpp:813-890)."""
    params = CSPParams(
        color=Colorspace(space=src.matrix, levels=src.levels,
                         primaries=src.primaries, gamma=src.transfer),
        brightness=src.brightness,
        contrast=src.contrast,
        hue=src.hue_deg / 180.0 * np.pi,
        saturation=src.saturation,
        gray=info.cs_type == ColorSystem.GRAY,
        input_bits=info.depth,
        texture_bits=info.depth,
    )
    cm = csputils.get_csp_matrix(params)
    enable = (
        info.cs_type == ColorSystem.YUV
        or info.cformat in (ColorFormat.GBRP8, ColorFormat.GBRP10, ColorFormat.GBRP16)
        or params.gray
        or abs(params.brightness) > 1e-4
        or abs(params.contrast - 1.0) > 1e-4
    )
    return cm.m, cm.c, enable


def plan_pipeline(settings: Settings, src: SourceDescriptor,
                  dst: OutputDescriptor) -> PipelinePlan:
    """Static planning — the InitMediaType analogue; the same resolution
    as the JAX package's ``plan_pipeline`` for every plan it accepts."""
    src = src.specified()
    info = get_format_info(src.format)
    dovi = src.dovi
    if dovi is not None:
        # DoVi replaces the standard matrix with the RPU's ycc_to_rgb
        # (Source/DX11VideoProcessor.cpp:817-836); the reference engages the
        # RPU pipeline whenever the metadata is present
        m, c = dovi_ops.build_ycc_to_rgb_cmat(dovi, brightness=src.brightness,
                                              contrast=src.contrast)
        apply_matrix = True
    else:
        m, c, apply_matrix = _build_cmat(src, info)

    is_pq = src.transfer == TRC.PQ
    is_hlg = src.transfer == TRC.HLG and dovi is None
    bt2020 = src.primaries == Primaries.BT_2020

    dovi_trims = src.dovi_trims
    dovi_ext = src.dovi_ext
    if dovi_ext is not None and dovi_trims is None:
        dovi_trims = dovi_ext_ops.select_l2_trims(
            dovi_ext, float(settings.hdr_display_max_nits))

    convert_to_sdr = (not dst.hdr) and settings.convert_to_sdr and (
        is_pq or is_hlg or dovi is not None)
    hlg_to_pq = dst.hdr and settings.hdr_passthrough and is_hlg
    # SDR source with BT.2020 primaries shown on a 709 display
    # (ps_fix_bt2020.hlsl; codegen branch Source/Shaders.cpp:892-915)
    fix_bt2020_sdr = bt2020 and not (is_pq or is_hlg) and not dst.hdr
    sdr_gamma = {
        TRC.LINEAR: 1.0, TRC.GAMMA18: 1.8, TRC.GAMMA20: 2.0,
        TRC.GAMMA26: 2.6, TRC.GAMMA28: 2.8,
    }.get(src.transfer, 2.2)
    local_tonemap = (dst.hdr and settings.hdr_local_tone_mapping
                     and (is_pq or is_hlg or dovi is not None))

    # the tone map's parameter block, resolved once: L1 (+L3) extensions
    # give min/max/MaxCLL=max/MaxFALL=avg and upgrade type 5 to 6, HDR10+
    # the scene's statistics (and selection 7 with a guided curve), else the
    # HDR10 mastering metadata (Source/DX11VideoProcessor.cpp:2728-2736)
    tm_type = int(settings.hdr_local_tone_mapping_type)
    display = float(settings.hdr_display_max_nits)
    output_hdr10 = src.hdr10 if dst.hdr else None
    h10p_window = None
    if dovi_ext is not None:
        tm_params, tm_type = dovi_ext_ops.hdr_params_from_extensions(
            dovi_ext, src.hdr10, display, tm_type)
        if dst.hdr:
            output_hdr10 = dovi_ext_ops.merge_hdr10(src.hdr10, dovi_ext)
    elif src.hdr10plus is not None:
        tm_params, tm_type = h10p_ops.hdr_params_from_hdr10plus(
            src.hdr10plus, src.hdr10, display, tm_type)
        if tm_type == tonemap_ops.HDR10PLUS_GUIDED:
            h10p_window = src.hdr10plus.windows[0]
        if dst.hdr:
            output_hdr10 = h10p_ops.merge_hdr10(src.hdr10, src.hdr10plus)
    else:
        h = src.hdr10 or HDR10Metadata()
        tm_params = tonemap_ops.HDRParams(
            mastering_min_nits=h.mastering_min_nits,
            mastering_max_nits=h.mastering_max_nits,
            max_cll=h.max_cll, max_fall=h.max_fall,
            display_max_nits=display)

    if src.src_rect is not None and info.cs_type == ColorSystem.YUV:
        dw, dh = info.chroma_div
        l, t, r, b = src.src_rect
        if l % dw or r % dw or t % dh or b % dh:
            raise ValueError(
                f"src_rect {src.src_rect} must align to the {info.name} "
                f"chroma grid ({dw}x{dh})")

    # positive: ordered dither to that depth; negative: plain rounding;
    # 0: float output, no quantization (TEXFMT_16FLOAT analogue)
    if dst.bits in (8, 10):
        dither_bits = dst.bits if settings.use_dither else -dst.bits
    else:
        dither_bits = 0

    return PipelinePlan(
        settings=settings, src=src, dst=dst, info=info,
        cmat_m=m, cmat_c=c, apply_matrix=apply_matrix,
        convert_to_sdr=convert_to_sdr, hlg_to_pq=hlg_to_pq,
        fix_bt2020_sdr=fix_bt2020_sdr, sdr_gamma=sdr_gamma,
        dither_bits=dither_bits, src_rect=src.src_rect,
        tonemap_params=tm_params, dovi=dovi, local_tonemap=local_tonemap,
        tonemap_type=tm_type, dovi_trims=dovi_trims, dovi_ext=dovi_ext,
        hdr10plus_window=h10p_window, output_hdr10=output_hdr10)


@dataclass(frozen=True)
class OutputSignalInfo:
    """What the output pixels are: the swap-chain colorspace + HDR10
    metadata the reference programs every present
    (SetColorSpace1/SetHDRMetaData, Source/DX11VideoProcessor.cpp:2629-2739).
    Sinks keep it beside the pixels so a consumer can show them right."""

    width: int
    height: int
    bits: int
    primaries: str        # Primaries name
    transfer: str         # TRC name ("PQ" for HDR out)
    matrix: str = "RGB"
    range: str = "full"
    hdr10: HDR10Metadata | None = None

    def to_dict(self) -> dict:
        d = {"width": self.width, "height": self.height, "bits": self.bits,
             "primaries": self.primaries, "transfer": self.transfer,
             "matrix": self.matrix, "range": self.range}
        if self.hdr10 is not None:
            d["hdr10"] = {
                "mastering_min_nits": self.hdr10.mastering_min_nits,
                "mastering_max_nits": self.hdr10.mastering_max_nits,
                "max_cll": self.hdr10.max_cll,
                "max_fall": self.hdr10.max_fall,
            }
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "OutputSignalInfo":
        h = d.get("hdr10")
        return cls(width=d["width"], height=d["height"], bits=d["bits"],
                   primaries=d["primaries"], transfer=d["transfer"],
                   matrix=d.get("matrix", "RGB"),
                   range=d.get("range", "full"),
                   hdr10=HDR10Metadata(**h) if h else None)


def output_signal_info(plan: PipelinePlan) -> OutputSignalInfo:
    """The output's colorspace, transfer and HDR10 metadata from the plan:

     * HDR out: RGB full, PQ, BT.2020 (the reference's fixed HDR swap-chain
       colorspace) + the (DoVi- or HDR10+-merged) mastering/CLL metadata;
     * tone-mapped or BT.2020-fixed SDR: the sRGB-like gamma in BT.709;
     * plain SDR: the source's transfer and primaries pass through (the
       pipeline only applies the matrix and the resize).
    """
    dst = plan.dst
    if dst.hdr:
        return OutputSignalInfo(
            width=dst.width, height=dst.height, bits=dst.bits,
            primaries=Primaries.BT_2020.name, transfer=TRC.PQ.name,
            hdr10=plan.output_hdr10 or HDR10Metadata())
    if plan.convert_to_sdr or plan.fix_bt2020_sdr:
        return OutputSignalInfo(
            width=dst.width, height=dst.height, bits=dst.bits,
            primaries=Primaries.BT_709.name, transfer=TRC.SRGB.name)
    return OutputSignalInfo(
        width=dst.width, height=dst.height, bits=dst.bits,
        primaries=plan.src.primaries.name, transfer=plan.src.transfer.name)


# ---------------------------------------------------------------------------
# stages on (..., 3, H, W) float32 tensors
# ---------------------------------------------------------------------------


def _crop_planes(plan: PipelinePlan, planes):
    """Source-rect crop (IBasicVideo SetSourcePosition analogue): a
    contiguous copy of each plane's rect (the kernels take contiguous
    planes), the chroma rect divided by the subsampling factors."""
    rect = plan.src_rect
    if rect is None:
        return tuple(planes)
    l, t, r, b = rect
    dw, dh = plan.info.chroma_div
    out = []
    for i, p in enumerate(planes):
        if i == 0 or plan.info.cs_type != ColorSystem.YUV:
            out.append(p[..., t:b, l:r].contiguous())
        else:
            out.append(p[..., t // dh:b // dh, l // dw:r // dw].contiguous())
    return tuple(out)


def _apply_cmat(m: np.ndarray, c: np.ndarray, y, u, v) -> torch.Tensor:
    """The 3x3+c colour matrix (float32 constants) on three planes ->
    (..., 3, H, W); the cm_r/cm_g/cm_b/cm_c cbuffer of
    Source/Shaders.cpp:819-820."""
    return torch.stack(
        [float(m[i, 0]) * y + float(m[i, 1]) * u + float(m[i, 2]) * v
         + float(c[i]) for i in range(3)], dim=-3)


def _convert_color(plan: PipelinePlan, planes,
                   vals: CallValues | None = None,
                   rt_curves=None) -> torch.Tensor:
    """ConvertColorPass analogue: normalise, (blend deinterlace luma),
    chroma upsample, (the DoVi reshape,) 3x3+c matrix (, the DoVi LMS
    step).  ``vals``: the call's values (:class:`CallValues`; the plan's
    by default); ``rt_curves``: a serving call's runtime reshape curves
    (:func:`~.ops.dovi.pack_curves`).  Returns (..., 3, H, W) float32."""
    info, s = plan.info, plan.settings
    vals = vals or CallValues(plan)
    scale = float(np.float32(PlanMaps(plan).norm))
    norm = [p.to(torch.float32) * scale for p in _crop_planes(plan, planes)]
    if info.cs_type == ColorSystem.YUV:
        y, u, v = norm
        if s.deint_blend and plan.src.interlaced and info.subsampling == 420:
            y = chroma_ops.blend_deinterlace_luma(y)
        uv = chroma_ops.upsample_chroma(torch.stack([u, v], dim=-3),
                                        info.subsampling, s.chroma_scaling,
                                        plan.src.chroma_location)
        norm = [y, uv[..., 0, :, :], uv[..., 1, :, :]]
    if plan.dovi is None or len(norm) == 1:
        return vals.matrix(norm)
    return dovi_convert(plan, vals, torch.stack(norm, dim=-3), rt_curves)


def dovi_convert(plan: PipelinePlan, vals: CallValues, ycc: torch.Tensor,
                 curves=None) -> torch.Tensor:
    """The Dolby Vision convert on (..., 3, H, W) ycc: the reshape on the
    raw ycc signal (``curves``, a serving call's
    :func:`~.ops.dovi.pack_curves`, else the plan's), the call's colour
    matrix, then PQ EOTF -> (LMS2RGB @ rgb_to_lms) -> PQ OETF
    (ShaderGetPixels -> ShaderDoviReshape and the convert pass,
    Source/Shaders.cpp:809-859)."""
    if curves is None:
        ycc = dovi_ops.reshape(ycc, plan.dovi, axis=-3)
    else:
        ycc = dovi_ops.reshape_dynamic(
            ycc, curves, axis=-3,
            structure=dovi_ops.curve_structure(plan.dovi))
    return dovi_ops.apply_lms_matrix(
        _apply_cmat(vals.m, vals.c, *ycc.unbind(-3)), plan.dovi, axis=-3)


def _gamut_2020_to_709(x: torch.Tensor, axis: int) -> torch.Tensor:
    gm = csputils.bt2020_to_bt709_matrix()
    r, g, b = (x.narrow(axis, i, 1) for i in range(3))
    return torch.cat(
        [float(gm[i, 0]) * r + float(gm[i, 1]) * g + float(gm[i, 2]) * b
         for i in range(3)], dim=axis)


def _pq_trims(plan: PipelinePlan) -> bool:
    """The L2 trims run on the PQ signal before PQ -> SDR (a Dolby Vision
    plan with enabled trims, Source/Shaders.cpp:873-877)."""
    return (plan.convert_to_sdr and plan.dovi is not None
            and plan.dovi_trims is not None and plan.dovi_trims.l2_enabled)


def _corrections(plan: PipelinePlan, rgb: torch.Tensor,
                 trims: tonemap_ops.DoviTrims | None = None) -> torch.Tensor:
    """Post-scale correction shaders (selection in InitMediaType,
    Source/DX11VideoProcessor.cpp:1896-1930) on (..., 3, H, W).  Whether
    the PQ-domain L2 trims run is the plan's (:func:`_pq_trims`); their
    values are ``trims`` (a serving call's), else the plan's."""
    s = plan.settings
    axis = -3
    if trims is None:
        trims = plan.dovi_trims
    if plan.convert_to_sdr:
        # ps_convert_pq_to_sdr.hlsl / HLG variant: -> linear (SDR-relative)
        # -> Hable -> 2020->709 -> sRGB-ish gamma
        luminance_scale = 10000.0 / s.sdr_display_nits
        x = torch.clamp(rgb, 0.0, 1.0)
        if plan.src.transfer == TRC.HLG and plan.dovi is None:
            # (a DoVi source takes the PQ branch whatever its transfer)
            # the reference runs HLGtoLinear -> LinearToST2084(1000), clips,
            # then ST2084ToLinear(ls) in a second pass; the PQ round trip is
            # algebraically clip(x/1000, 0, 1) * ls
            x = transfer_ops.hlg_to_linear(x, axis=axis)
            x = torch.clamp(x * (1.0 / 1000.0), 0.0, 1.0) * luminance_scale
        else:
            if _pq_trims(plan):
                x = tonemap_ops.dolby_vision_trims(x, trims, axis=axis,
                                                   pq_input=True)
            x = transfer_ops.st2084_to_linear(x, luminance_scale)
        x = tonemap_ops.tonemap_hable_sdr(x)
        x = _gamut_2020_to_709(x, axis)
        return transfer_ops.linear_to_srgb_like(x)
    if plan.hlg_to_pq:
        # ps_convert_hlg_to_pq.hlsl
        x = torch.clamp(rgb, 0.0, 1.0)
        x = transfer_ops.hlg_to_linear(x, axis=axis)
        return transfer_ops.linear_to_st2084(x, 1000.0)
    if plan.fix_bt2020_sdr:
        # SDR BT.2020 -> 709 (codegen branch, Source/Shaders.cpp:892-915)
        x = transfer_ops.srgb_like_to_linear(rgb, plan.sdr_gamma)
        x = _gamut_2020_to_709(x, axis)
        return transfer_ops.linear_to_srgb_like(x)
    return rgb


def _quantize(plan: PipelinePlan, rgb: torch.Tensor) -> torch.Tensor:
    """ps_final_pass.hlsl's quantization: ordered dither (pattern origin at
    the video's row and column 0) or rounding to the output depth."""
    db = plan.dither_bits
    if db < 0:
        return dither_ops.quantize(torch.clamp(rgb, 0.0, 1.0), -db)
    if db > 0:
        return dither_ops.ordered_dither(torch.clamp(rgb, 0.0, 1.0), db)
    return rgb


def _final_pass(plan: PipelinePlan, rgb: torch.Tensor) -> torch.Tensor:
    """ps_final_pass.hlsl: the quantization, then the placement of the video
    rect into a black surface of the output's size (FillBlack), the
    letterbox or pillarbox of ``OutputDescriptor.video_rect``."""
    rgb = _quantize(plan, rgb)
    rect = plan.dst.video_rect
    if rect is None:
        return rgb
    l, t, r, b = rect
    surface = rgb.new_zeros(rgb.shape[:-2] + (plan.dst.height, plan.dst.width))
    surface[..., t:b, l:r] = rgb
    return surface


def surface_pack_format(dst: OutputDescriptor) -> str:
    """The packed-dword surface format for this output depth — the
    swap-chain backbuffer the reference presents into (8-bit flip chains
    use RGBA8, HDR/10-bit chains DXGI_FORMAT_R10G10B10A2_UNORM,
    Source/DX11VideoProcessor.cpp:1490-1530)."""
    if dst.bits == 10:
        return "rgb10a2"
    if dst.bits == 8:
        return "rgba8"
    raise ValueError("packed surface output needs an 8- or 10-bit "
                     f"OutputDescriptor, got bits={dst.bits}")


def _vp_format_allowed(s: Settings, info: FormatInfo) -> bool:
    """VP format allowlist (VPEnableFormats_t, IVideoRenderer.h:97-102):
    which source classes may use the kernel path; the others take the
    plain path (the reference's shader path)."""
    f = info.cformat
    if f == ColorFormat.NV12:
        return s.vp_formats.nv12
    if f in (ColorFormat.P010, ColorFormat.P016):
        return s.vp_formats.p01x
    if f == ColorFormat.YUY2:
        return s.vp_formats.yuy2
    return s.vp_formats.other


def kernels_allowed(plan: PipelinePlan) -> bool:
    """Whether a route of this plan may take the kernels: with
    ``use_accel_backend`` and a source class the allowlist admits
    (:func:`_vp_format_allowed`)."""
    s = plan.settings
    return s.use_accel_backend and _vp_format_allowed(s, plan.info)


def _separable_geometry(plan: PipelinePlan) -> bool:
    """True when every resize pass is a separable axis matrix (Jinc2's 2D
    one-pass shader is the only non-separable case)."""
    s, m = plan.settings, PlanMaps(plan)
    return (s.upscaling != Upscaling.JINC2
            or scale_ops.jinc2_route(m.src_h, m.src_w, m.vid_h, m.vid_w,
                                     s.interpolate_at_50pct) is None)


def route_of(plan: PipelinePlan) -> str:
    """The route of a plan, chosen as the JAX package chooses it: "fused"
    (:func:`_make_fused_fn`) when everything between plane normalisation
    and the first nonlinearity is linear, the VP-order pipeline with a
    separable scaler; "dovi_fused" (:func:`_make_dovi_fused_fn`) for a
    Dolby Vision plan of a planar YUV source under the same conditions
    (the reshape is nonlinear in the ycc signal, so the resample cannot
    cross it); else "staged" (:func:`_make_staged_fn`)."""
    if not (plan.settings.vp_scaling and _separable_geometry(plan)):
        return "staged"
    if plan.dovi is None:
        return "fused"
    return "dovi_fused" if plan.info.cs_type == ColorSystem.YUV else "staged"


def _on_card(planes) -> bool:
    """The staged path's kernel choice, made per call from the tensors (the
    JAX package asks for the TPU backend instead)."""
    return all(p.device.type == "cuda" for p in planes)


def _tonemap_scalars(plan: PipelinePlan, hdr=None) -> np.ndarray | None:
    """The local tone map's five float32 scalars, None without one.  The
    JAX package's two routes: with ``hdr`` None the plan's static metadata
    in float64 on the host (its ``_local_tonemap``), else float32 from the
    plan's metadata merged with a serving call's ``hdr`` values (its
    ``_pack_rt_all``)."""
    if not plan.local_tonemap:
        return None
    with trace.span("vrt.tonemap_scalars"):
        if hdr is None:
            return tonemap_ops.local_tonemap_static_scalars(
                plan.tonemap_type, plan.tonemap_params)
        merged = {k: getattr(plan.tonemap_params, k)
                  for k in tonemap_ops.HDR_KEYS}
        merged.update(tonemap_ops.hdr_values(hdr))
        return tonemap_ops.local_tonemap_rt_scalars(plan.tonemap_type, merged)


# Which serving calls take the tone map's float32 scalars (the plan's
# metadata merged with ``rt["hdr"]``) in place of the static ones, by route
# kind, as the JAX package's routes take them: its fused kernel route packs
# them for any ``rt`` (``_pack_rt_all``), its Dolby Vision kernel tail for
# the tail's own keys, its XLA routes for HDR10 values given
# (``local_tonemap_pq_rt``, else ``_local_tonemap``).
RT_SCALARS = {
    "kernel": bool,
    "dovi_kernel": lambda rt: bool(rt.keys() & {"hdr", "l2_trims"}),
    "torch": lambda rt: rt.get("hdr") is not None,
}


class CallValues:
    """A call's tail values, resolved from the plan and a serving call's
    ``rt`` here for every route: ``m`` (3, 3) and ``c`` (3,), the float32
    colour matrix (``rt["cmat"]``, host arrays, else the plan's);
    ``trims``, the L2 trims (``rt["l2_trims"]``, else the plan's; the
    reference re-uploads the DoVi dynamic cbuffer per sample,
    Source/DX11VideoProcessor.cpp:954-983); ``tm``, the local tone map's
    five scalars (None without one), the serving ones where ``route``'s
    rule (:data:`RT_SCALARS`) takes them, else the static ones
    (``static``'s, a route's values made once without ``rt``).  Serving
    scalars are made on first read, so that a stage reading only the
    matrix (K8's mid stage) makes none and an epilogue build holds their
    making."""

    def __init__(self, plan: PipelinePlan, rt: dict | None = None,
                 route: str = "torch", static: CallValues | None = None):
        rt = rt or {}
        cm = rt.get("cmat")
        if cm is None:
            self.m = np.asarray(plan.cmat_m, np.float32)
            self.c = np.asarray(plan.cmat_c, np.float32)
        else:
            cm = dovi_ops.host_arrays(cm, "cmat")
            self.m, self.c = cm["m"].reshape(3, 3), cm["c"].reshape(3)
        tr = rt.get("l2_trims")
        self.trims = (plan.dovi_trims if tr is None
                      else tonemap_ops.trims_from_values(tr))
        self._plan = plan
        if RT_SCALARS[route](rt):
            self._hdr = rt.get("hdr") or {}
        else:
            self.tm = _tonemap_scalars(plan) if static is None else static.tm

    @functools.cached_property
    def tm(self) -> np.ndarray | None:
        return _tonemap_scalars(self._plan, self._hdr)

    def matrix(self, comps) -> torch.Tensor:
        """The colour matrix on ``comps`` (three planes, stacked as they
        are where the plan has no matrix, or a GRAY source's one plane
        through the matrix's first column) -> (..., 3, H, W)."""
        if len(comps) == 1:
            return torch.stack([comps[0] * float(self.m[i, 0])
                                + float(self.c[i]) for i in range(3)], dim=-3)
        if self._plan.apply_matrix:
            return _apply_cmat(self.m, self.c, *comps)
        return torch.stack(tuple(comps), dim=-3)


def torch_tail(plan: PipelinePlan, vals: CallValues, comps, *,
               corrections: bool | None = None, end=None,
               pack_format: str | None = None) -> torch.Tensor:
    """The tail in torch, for every route that runs it there and for the
    plain version of the tail kernels' epilogue: the call's colour matrix
    on ``comps`` (:meth:`CallValues.matrix`; a (..., 3, H, W) tensor is R,
    G, B already), the corrections (by default in the VP order only: the
    shader order ran them before the resize), the local tone map of the
    HDR passthrough (ps_hdr10_tonemap.hlsl: the call's L2 trims where
    enabled, then the plan's operator, its HDR10+ window for selection 7),
    then ``end`` (:func:`_final_pass` by default) and the pack to
    ``pack_format``."""
    rgb = comps if isinstance(comps, torch.Tensor) else vals.matrix(comps)
    if plan.settings.vp_scaling if corrections is None else corrections:
        rgb = _corrections(plan, rgb, vals.trims)
    if vals.tm is not None:
        rgb = tonemap_ops.local_tonemap_pq_from_scalars(
            rgb, plan.tonemap_type, vals.tm, trims=vals.trims, axis=-3,
            window=plan.hdr10plus_window)
    rgb = _final_pass(plan, rgb) if end is None else end(rgb)
    return rgb if pack_format is None else rk.pack_surface(rgb, pack_format)


def _correction_code(plan: PipelinePlan) -> int:
    """The tail kernels' correction for this plan (the branch of
    :func:`_corrections` it takes)."""
    if plan.convert_to_sdr:
        return (rk.CORR_HLG_TO_SDR
                if plan.src.transfer == TRC.HLG and plan.dovi is None
                else rk.CORR_PQ_TO_SDR)
    if plan.hlg_to_pq:
        return rk.CORR_HLG_TO_PQ
    if plan.fix_bt2020_sdr:
        return rk.CORR_FIX_BT2020
    return rk.CORR_NONE


def _kernel_trims(plan: PipelinePlan, trims: tonemap_ops.DoviTrims | None,
                  tonemap: bool) -> tuple:
    """(the tail kernels' five trim scalars or None, whether they run in
    the PQ domain) for a call's resolved ``trims``: the PQ form before PQ ->
    SDR on a Dolby Vision plan, the linear form before a local tone map."""
    if trims is None or not trims.l2_enabled:
        return None, False
    if _pq_trims(plan):
        return tonemap_ops.trim_values(trims), True
    if tonemap:
        return tonemap_ops.trim_values(trims), False
    return None, False


@trace.spanned("vrt.build.epilogue")
def _make_tail_epilogue(plan: PipelinePlan, with_cmat: bool = True,
                        rt: dict | None = None, route: str = "kernel"
                        ) -> rk.Epilogue:
    """K2's (and K9's, K4's) epilogue for this plan: colour matrix,
    corrections (with the PQ-domain L2 trims), the local tone map (the
    linear-domain trims, the guided curve) and dither, as kernel parameters
    and as the torch function of the plain version (:func:`torch_tail`).
    ``with_cmat=False``: the three planes are R, G, B already.  ``rt``: a
    serving call's values, taken as ``route`` takes them
    (:class:`CallValues`), else the plan's."""
    vals = CallValues(plan, rt, route)
    tm = vals.tm
    k_trims, trims_pq = _kernel_trims(plan, vals.trims, tm is not None)

    def plain(y, u, v):
        rgb = (y, u, v) if with_cmat else torch.stack([y, u, v], dim=-3)
        return torch_tail(plan, vals, rgb, corrections=True,
                          end=functools.partial(_quantize, plan))

    return rk.Epilogue(
        cmat=(np.concatenate([vals.m, vals.c[:, None]], axis=1)
              if with_cmat and plan.apply_matrix else None),
        correction=_correction_code(plan),
        luminance_scale=10000.0 / plan.settings.sdr_display_nits,
        dither_bits=plan.dither_bits,
        gamut=np.asarray(csputils.bt2020_to_bt709_matrix(), np.float32),
        plain=plain,
        tonemap=plan.tonemap_type if tm is not None else 0,
        tonemap_scalars=(tm if tm is not None
                         else np.zeros(5, np.float32)),
        sdr_gamma=plan.sdr_gamma, trims=k_trims, trims_pq=trims_pq,
        window=(plan.hdr10plus_window
                if tm is not None and plan.tonemap_type == 7 else None))


def _epilogues(plan: PipelinePlan, route: str, with_cmat: bool = True):
    """A kernel route's epilogue for each call, ``epilogue(rt)``: the
    plan's, built here once, unless ``route``'s rule (:data:`RT_SCALARS`)
    takes the call's serving values; then one built for them, the one
    place where a cache keyed on their values would go."""
    prebuilt = _make_tail_epilogue(plan, with_cmat)
    return lambda rt: (_make_tail_epilogue(plan, with_cmat, rt, route)
                       if RT_SCALARS[route](rt) else prebuilt)


def cmat_epilogue(cmat: np.ndarray) -> rk.Epilogue:
    """K2's epilogue of the staged convert: the (3, 4) colour matrix only,
    float32 out (no corrections, no dither)."""
    return rk.Epilogue(
        cmat=cmat, correction=rk.CORR_NONE, luminance_scale=1.0,
        dither_bits=0, gamut=np.eye(3, dtype=np.float32),
        plain=lambda y, u, v: _apply_cmat(cmat[:, :3], cmat[:, 3], y, u, v))


def convert_epilogue(plan: PipelinePlan, cmat: np.ndarray) -> rk.Epilogue:
    """K2's epilogue of the staged convert of ``plan``: the colour matrix
    only (:func:`cmat_epilogue`), or in the shader order (``vp_scaling``
    off) the matrix and then the plan's correction at source resolution,
    float32 out, no dither; K2's tail runs each correction in the torch
    order."""
    if plan.settings.vp_scaling:
        return cmat_epilogue(cmat)
    return rk.Epilogue(
        cmat=cmat, correction=_correction_code(plan),
        luminance_scale=10000.0 / plan.settings.sdr_display_nits,
        dither_bits=0,
        gamut=np.asarray(csputils.bt2020_to_bt709_matrix(), np.float32),
        plain=lambda y, u, v: _corrections(
            plan, _apply_cmat(cmat[:, :3], cmat[:, 3], y, u, v)),
        sdr_gamma=plan.sdr_gamma)


def _compose(a: np.ndarray | None, b: np.ndarray | None):
    """Compose two (in,out) axis maps applied a-then-b."""
    if a is None:
        return b
    if b is None:
        return a
    return a @ b


def _dense_apply():
    """The plain per-plane maps (the JAX package's ``_fused_apply2d`` XLA
    branch): ``app(plane, W map, H map, norm)`` normalises (when ``norm``
    is given), then applies each (in, out) map as a dense float32 product.
    The float32 copies are made once per (matrix, device); the matrices
    live as long as the returned closure's callers, so their ids stay
    theirs."""
    on_device: dict = {}

    def dense(mat, device):
        key = (id(mat), device)
        if key not in on_device:
            on_device[key] = torch.from_numpy(
                np.asarray(mat, np.float32)).to(device)
        return on_device[key]

    def app(p, mx, my, norm=None):
        x = p if norm is None else p.to(torch.float32) * float(np.float32(norm))
        if mx is not None:
            x = scale_ops.resize_axis(x, dense(mx, x.device), -1)
        if my is not None:
            x = scale_ops.resize_axis(x, dense(my, x.device), -2)
        return x

    return app


class PlanMaps:
    """The plan's linear maps, derived here for every route, each a dense
    (in, out) array or None where the axis keeps its size, at the crop's
    size (``src_w``, ``src_h``; the video's ``vid_w``, ``vid_h``) and made
    on first read (a route that reads no chroma composition pays no 4K
    product):

     * ``wx``, ``wy``: the resize of the luma's axes;
     * ``by``: the blend map of an interlaced 4:2:0 YUV source with
       ``deint_blend`` (``blend``), else None; ``wy_luma``: ``by``, then
       ``wy``;
     * ``ux``, ``uy``: the chroma upsample of a YUV source, else None;
       ``cwx``, ``cwy``: the chroma's maps, the upsample, then the resize;
     * ``norm``: the normalisation of the raw plane codes."""

    def __init__(self, plan: PipelinePlan):
        s, src, info = plan.settings, plan.src, plan.info
        l, t, r, b = plan.src_rect or (0, 0, src.width, src.height)
        self.src_w, self.src_h = r - l, b - t
        self.vid_w, self.vid_h = plan.dst.video_size

        def choice(n_in, n_out):
            return scale_ops.select_scaler(n_in, n_out, s.upscaling,
                                           s.downscaling,
                                           s.interpolate_at_50pct)

        self._cx = choice(self.src_w, self.vid_w)
        self._cy = choice(self.src_h, self.vid_h)
        self.norm = 1.0 / (2.0 ** info.plane_bits - 1.0)
        self.yuv = info.cs_type == ColorSystem.YUV
        self.blend = (s.deint_blend and src.interlaced
                      and info.subsampling == 420 and self.yuv)
        self._plan = plan

    wx = functools.cached_property(lambda self: scale_ops.build_axis_matrix(
        self._cx, self.src_w, self.vid_w))
    wy = functools.cached_property(lambda self: scale_ops.build_axis_matrix(
        self._cy, self.src_h, self.vid_h))
    by = functools.cached_property(lambda self: (
        chroma_ops.blend_deinterlace_matrix(self.src_h) if self.blend
        else None))
    wy_luma = functools.cached_property(
        lambda self: _compose(self.by, self.wy))

    @functools.cached_property
    def _upsample(self):
        s, info = self._plan.settings, self._plan.info
        if not self.yuv:
            return None, None
        dw, dh = info.chroma_div
        return chroma_ops.chroma_upsample_matrices(
            self.src_w // dw, self.src_h // dh, info.subsampling,
            s.chroma_scaling, self._plan.src.chroma_location)

    ux = property(lambda self: self._upsample[0])
    uy = property(lambda self: self._upsample[1])
    cwx = functools.cached_property(lambda self: _compose(self.ux, self.wx))
    cwy = functools.cached_property(lambda self: _compose(self.uy, self.wy))


def fused_maps(plan: PipelinePlan) -> tuple:
    """The fused path's maps of a plan (:class:`PlanMaps`): (luma W map,
    luma H map with the blend, chroma W map, chroma H map,
    normalisation)."""
    m = PlanMaps(plan)
    return m.wx, m.wy_luma, m.cwx, m.cwy, m.norm


def fused_plane_pass(mx, my, norm: float, mid16: bool) -> tuple:
    """(W matrix, H matrix, direct-read scale) of one plane class of the
    fused kernel route, from its :func:`fused_maps` maps: the UNORM
    normalisation folds into the W matrix; what the H pass must undo
    (``mid16`` codes, or the raw normalisation when there is no W pass)
    folds into the H matrix, or scales a directly read plane."""
    kw = None if mx is None else rk.BandedMatrix(mx, pre_scale=norm)
    h_scale = norm if mx is None else (1.0 / rk.MID16_SCALE if mid16 else None)
    kh = None if my is None else rk.BandedMatrix(my, pre_scale=h_scale)
    return kw, kh, (h_scale if my is None else None)


def mid16_planes(plan: PipelinePlan, maps: PlanMaps) -> tuple[bool, bool]:
    """Whether the luma's and the chroma's W-pass intermediates are int16
    codes round(x * MID16_SCALE), the analogue of the reference's
    TEXFMT_AUTOINT UNORM intermediate textures
    (Source/DX11VideoProcessor.cpp:1145-1151): on the kernel route unless
    FLOAT16 is asked for (float32 then), and only where the codes fit.  A
    W-pass output is bounded by the column L1 norm of its normalized
    matrix, so a plane keeps float32 when that norm times MID16_SCALE
    exceeds 32767."""
    mid16 = (kernels_allowed(plan)
             and plan.settings.tex_format != TexFormat.FLOAT16)

    def fits(mat):
        return (mid16 and mat is not None and float(
            np.abs(mat).sum(axis=0).max()) * rk.MID16_SCALE <= 32767.0)

    return fits(maps.wx), fits(maps.cwx)


def _make_fused_fn(plan: PipelinePlan, pack_format: str | None = None):
    """The fused pipeline: chroma upsample + (blend deinterlace) +
    separable resize collapse into one banded matrix per plane per axis
    (linear maps compose), so everything nonlinear runs at output
    resolution.

    Returns ``fn(planes, rt=None)``; ``rt["cmat"]`` (a serving call's
    ``{"m", "c"}``) replaces the plan's colour matrix, ``rt["hdr"]`` (its
    HDR10 values) the local tone map's metadata and ``rt["l2_trims"]`` the
    plan's L2 trims.  Three routes: K1 ×3 + K2
    (the matrix and the whole tail inside K2; c7 reads its luma directly,
    K1 ×2 + K2), which with a ``video_rect`` stores the video into the
    surface at the rect's origin; for a GRAY source, K1 then K3 on its one
    plane and the tail and the placement in torch (the JAX package's
    ``_fused_apply2d`` route); and, without ``use_accel_backend``, the
    plain products and the torch tail.  Each route takes the tone map's
    serving scalars by its own rule (:data:`RT_SCALARS`: "kernel" for K2,
    "torch" for the others)."""
    info = plan.info
    maps = PlanMaps(plan)
    wx, wy_luma, cwx, cwy, norm = (maps.wx, maps.wy_luma, maps.cwx,
                                   maps.cwy, maps.norm)
    static = CallValues(plan)

    def tail(comps, rt):
        return torch_tail(plan, CallValues(plan, rt, "torch", static), comps,
                          pack_format=pack_format)

    if not kernels_allowed(plan):
        app = _dense_apply()

        def plain_fn(planes, rt=None):
            planes = _crop_planes(plan, planes)
            return tail([app(planes[0], wx, wy_luma, norm)]
                        + [app(p, cwx, cwy, norm) for p in planes[1:]], rt)

        return plain_fn

    if info.cs_type == ColorSystem.GRAY:
        # the one plane as K1 then K3 (float32 between them; the
        # normalisation in the first map's taps), the tail in torch
        kw_g, kh_g = rk.mega_maps(wx, wy_luma, norm)

        def gray_fn(planes, rt=None):
            p = _crop_planes(plan, planes)[0]
            if kw_g is not None:
                p = rk.banded_resize_last_axis(p, kw_g)
            if kh_g is not None:
                p = rk.banded_resize_rows(p, kh_g)
            elif kw_g is None:
                p = p.to(torch.float32) * float(np.float32(norm))
            return tail((p,), rt)

        return gray_fn

    mid16_y, mid16_c = mid16_planes(plan, maps)
    epilogue = _epilogues(plan, "kernel")
    kw_y, kh_y, y_scale = fused_plane_pass(wx, wy_luma, norm, mid16_y)
    kw_c, kh_c, c_scale = fused_plane_pass(cwx, cwy, norm, mid16_c)
    place = _place_of(plan.dst)
    vid_h = maps.vid_h

    def kernel_fn(planes, rt=None):
        planes = _crop_planes(plan, planes)
        epi = epilogue(rt)

        def wpass(p, kw, q):
            return p if kw is None else rk.banded_resize_last_axis(p, kw, mid16=q)

        yw = wpass(planes[0], kw_y, mid16_y)
        uw = wpass(planes[1], kw_c, mid16_c)
        vw = wpass(planes[2], kw_c, mid16_c)
        return rk.rows3_tail(yw, uw, vw, kh_y, kh_c, vid_h, epi,
                             y_scale=y_scale, c_scale=c_scale,
                             pack_format=pack_format, place=place)

    return kernel_fn


def dovi_mid_chain() -> bool:
    """Whether a Dolby Vision plan on the card takes the one-intermediate
    chain (K1 ×2 + K8 + K9; the default) or, with ``VRT_TPU_DOVI_MID=0``
    in the environment, the two-stage form (K1 ×5 + K2 ×2): the JAX
    package's switch, read at every call."""
    return os.environ.get("VRT_TPU_DOVI_MID", "1") != "0"


def _place_of(dst: OutputDescriptor) -> tuple | None:
    """The tail kernels' ``place`` for a placed output: (surface height,
    surface width, the rect's top, its left); None without a rect."""
    if dst.video_rect is None:
        return None
    l, t, _, _ = dst.video_rect
    return dst.height, dst.width, t, l


def dovi_kernel_maps(plan: PipelinePlan) -> tuple:
    """The kernel route's source-side maps of a Dolby Vision plan: (K1's
    chroma W map, the luma's and the chroma's H maps into the source rows,
    which K8 and K2's Dolby Vision route take, the luma's and the chroma's
    scale), maps as :class:`~.kernels.resize.BandedMatrix` or None.  The
    normalisation goes into the first map a plane meets (K1's chroma W
    taps, the luma's blend map), or scales a plane read directly, as the
    JAX package folds ``y_scale`` and ``c_scale`` into its maps."""
    m = PlanMaps(plan)
    ux, uy, by, norm = m.ux, m.uy, m.by, m.norm
    return (None if ux is None else rk.BandedMatrix(ux, pre_scale=norm),
            None if by is None else rk.BandedMatrix(by, pre_scale=norm),
            None if uy is None else rk.BandedMatrix(
                uy, pre_scale=norm if ux is None else None),
            None if by is not None else norm,
            None if uy is not None or ux is not None else norm)


def _make_dovi_fused_fn(plan: PipelinePlan, pack_format: str | None = None):
    """The Dolby Vision split-fused pipeline (the JAX package's
    ``_make_dovi_fused_fn``): the fusion splits at the nonlinear reshape.
    Returns ``fn(planes, rt=None)``; ``rt["dovi_curves"]`` (a scene's
    :func:`~.ops.dovi.pack_curves`, host arrays) and ``rt["cmat"]``
    replace the plan's curves and matrix, ``rt["hdr"]`` the local tone
    map's metadata (an HDR output) and ``rt["l2_trims"]`` the plan's L2
    trims, without rebuilding anything.

    On a CUDA device (with ``use_accel_backend``) the chain is H first
    around the convert: K1 upsamples the chroma along W (the normalisation
    in its taps), K8 upsamples it along H into the source rows, runs the
    reshape, the RPU matrix and the LMS step there and resizes H to the
    output rows, and K9 resizes W and runs the PQ -> SDR tail, the dither
    and the pack (or, for an HDR output, the local tone map), into the
    surface at the rect's origin for a placed output: K1 ×2 + K8 + K9, and
    the source-resolution RGB never reaches device memory.  As in the JAX
    package, the tail takes the tone map's float32 serving scalars when
    ``rt`` holds "hdr" or "l2_trims", and the static ones otherwise.

    ``VRT_TPU_DOVI_MID=0`` in the environment, read at every call as the
    JAX package reads it, selects the two-stage form on the card instead:
    after K1's chroma W upsample, K2's Dolby Vision route
    (:func:`~.kernels.resize.rows3_tail_dovi`) runs the H upsample and the
    convert at source resolution into float32 PQ R, G, B (stage A); then
    K1 resizes each along W and K2 resizes H and runs the tail without the
    colour matrix (stage B), into the rect of a placed output with K2's
    offset store: K1 ×5 + K2 ×2 (K1 ×2 + K8 + K9 with the default "1").
    (The JAX package runs a placed plan's stage B in XLA; the function is
    the same.)  Otherwise (the CPU, or ``use_accel_backend`` off) the
    plain route: the chroma upsample as dense products, the convert at
    source resolution, the resize of R, G and B, the torch tail."""
    use_kernels = kernels_allowed(plan)
    maps = PlanMaps(plan)
    wx, wy, ux, uy, by, norm = (maps.wx, maps.wy, maps.ux, maps.uy, maps.by,
                                maps.norm)
    static_mid = dovi_ops.mid_stage(plan.dovi, plan.cmat_m, plan.cmat_c)
    kw_c, kin_y, kin_c, y_scale, c_scale = dovi_kernel_maps(plan)
    k_out = None if wy is None else rk.BandedMatrix(wy)
    kx = None if wx is None else rk.BandedMatrix(wx)
    epilogue = _epilogues(plan, "dovi_kernel", with_cmat=False)
    static = CallValues(plan)
    place = _place_of(plan.dst)
    app = _dense_apply()

    def kernel_fn(planes, rt):
        y, u, v = planes
        if kw_c is not None:
            u = rk.banded_resize_last_axis(u, kw_c)
            v = rk.banded_resize_last_axis(v, kw_c)
        if not rt:
            mid = static_mid
        else:
            with trace.span("vrt.build.mid_stage"):
                vals = CallValues(plan, rt, "dovi_kernel", static)
                mid = dovi_ops.mid_stage(plan.dovi, vals.m, vals.c,
                                         rt.get("dovi_curves"))
        epi = epilogue(rt)
        if not dovi_mid_chain():
            # the two-stage form: stage A at source resolution, stage B
            rgb = rk.rows3_tail_dovi(y, u, v, kin_y, kin_c, maps.src_h, mid,
                                     y_scale=y_scale, c_scale=c_scale)
            chs = [rgb[..., i, :, :] for i in range(3)]
            if kx is not None:
                chs = [rk.banded_resize_last_axis(ch, kx) for ch in chs]
            return rk.rows3_tail(*chs, k_out, k_out, maps.vid_h, epi,
                                 pack_format=pack_format, place=place)
        r, g, b = dk.rows3_mid(y, u, v, kin_y, kin_c, maps.src_h, mid, k_out,
                               maps.vid_h, y_scale=y_scale, c_scale=c_scale)
        return dk.cols3_tail(r, g, b, kx, kx, maps.vid_w, epi,
                             pack_format=pack_format, place=place)

    def plain_fn(planes, rt):
        vals = CallValues(plan, rt, "torch", static)
        ycc = torch.stack([app(planes[0], None, by, norm),
                           app(planes[1], ux, uy, norm),
                           app(planes[2], ux, uy, norm)], dim=-3)
        rgb = dovi_convert(plan, vals, ycc, rt.get("dovi_curves"))
        if wx is not None or wy is not None:
            rgb = torch.stack([app(rgb[..., i, :, :], wx, wy)
                               for i in range(3)], dim=-3)
        return torch_tail(plan, vals, rgb, pack_format=pack_format)

    def fn(planes, rt=None):
        rt = rt or {}
        planes = _crop_planes(plan, planes)
        if use_kernels and len(planes) == 3 and _on_card(planes):
            return kernel_fn(planes, rt)
        return plain_fn(planes, rt)

    return fn


def _make_staged_fn(plan: PipelinePlan, fmt: str | None, rotation: int,
                    flip: bool):
    """The staged pipeline (the JAX package's non-fused ``make_frame_fn``
    branch): convert at source resolution, resize, corrections, the local
    tone map, final pass, pack to ``fmt``, with the Jinc2 kernels where they
    apply.  In the shader order (``vp_scaling`` off) the corrections run
    after the convert, at source resolution (on a card inside K2's convert
    epilogue, :func:`convert_epilogue`), and after the resize only the
    local tone map and the final pass.  Unrotated, it also takes a serving
    call's ``rt`` (:func:`make_serving_fn`); given runtime values, the
    convert runs in torch with them, ``rt["hdr"]`` gives the tone map's
    metadata and ``rt["l2_trims"]`` the L2 trims."""
    s, dst, info = plan.settings, plan.dst, plan.info
    want_rot = rotation != 0 or flip
    maps = PlanMaps(plan)
    src_w, src_h, vid_w, vid_h = maps.src_w, maps.src_h, maps.vid_w, maps.vid_h
    shader = not s.vp_scaling

    # Jinc2 with a dither-only tail: the quantization runs inside the Jinc2
    # kernel's epilogue, from the global row and column
    j2_tail = (s.upscaling == Upscaling.JINC2 and s.vp_scaling
               and not (plan.convert_to_sdr or plan.hlg_to_pq
                        or plan.fix_bt2020_sdr or plan.local_tonemap)
               and dst.video_rect is None and plan.dither_bits != 0)
    static = CallValues(plan)
    j2_epi = jk.dither_epilogue(plan.dither_bits) if j2_tail else None

    # the convert through the kernels (on a CUDA device): chroma W upsample
    # by K1, chroma H upsample + colour matrix by K2 reading the luma
    # directly; or, for a Jinc2 up/up geometry with the dither-only tail,
    # everything by K6
    use_kconvert = (kernels_allowed(plan) and info.cs_type == ColorSystem.YUV
                    and plan.apply_matrix and plan.dovi is None
                    and not maps.blend)
    # the pure transpose (rotation 90 + flip) rides K6 as a transposed store
    k3_transpose = (want_rot and
                    geo_ops.rf_decompose(rotation, flip) == (True, False, False))
    use_k3 = False
    if use_kconvert:
        knorm = maps.norm
        kcmat = np.concatenate([static.m, static.c[:, None]], axis=1)
        # the chroma normalisation folds into the W upsample's taps (K1,
        # K6); with no W upsample (a 4:4:4 source, which has no H upsample
        # either) K2 and K6 scale the chroma instead
        kw_c = (None if maps.ux is None
                else rk.BandedMatrix(maps.ux, pre_scale=knorm))
        kh_c = None if maps.uy is None else rk.BandedMatrix(maps.uy)
        c_scale = knorm if kw_c is None else None
        cmat_epi = convert_epilogue(plan, kcmat)
        use_k3 = (j2_tail and not (want_rot and not k3_transpose)
                  and scale_ops.jinc2_route(src_h, src_w, vid_h, vid_w,
                                            s.interpolate_at_50pct)
                  == "one_pass")

    def kernels_apply(planes) -> bool:
        return use_kconvert and len(planes) == 3 and _on_card(planes)

    def kconvert(planes):
        y, u, v = planes
        if kw_c is not None:
            u = rk.banded_resize_last_axis(u, kw_c)
            v = rk.banded_resize_last_axis(v, kw_c)
        return rk.rows3_tail(y, u, v, None, kh_c, src_h, cmat_epi,
                             y_scale=knorm, c_scale=c_scale)

    def k3_call(planes):
        y, u, v = _crop_planes(plan, planes)
        return jk.jinc2_convert_fused(y, u, v, kh_c, kw_c, kcmat, vid_h,
                                      vid_w, knorm,
                                      1.0 if c_scale is None else c_scale,
                                      epilogue=j2_epi, pack_format=fmt,
                                      out_transpose=k3_transpose)

    def fn(planes, rt=None):
        vals = CallValues(plan, rt, "torch", static)
        if rt:
            # a serving call's runtime curves or matrix: the torch convert
            rgb = _convert_color(plan, planes, vals, rt.get("dovi_curves"))
        elif kernels_apply(planes):
            if use_k3:
                return k3_call(planes)
            # (in the shader order K2's epilogue ran the corrections)
            rgb = kconvert(_crop_planes(plan, planes))
        else:
            rgb = _convert_color(plan, planes, vals)
        if shader and (rt or not kernels_apply(planes)):
            # the shader order: the corrections at source resolution
            rgb = _corrections(plan, rgb, vals.trims)
        if j2_tail and scale_ops.jinc2_route(
                rgb.shape[-2], rgb.shape[-1], vid_h, vid_w,
                s.interpolate_at_50pct) == "one_pass":
            rgb = scale_ops.jinc2_resize(rgb, vid_h, vid_w, epilogue=j2_epi)
            return rgb if fmt is None else rk.pack_surface(rgb, fmt)
        rgb = scale_ops.resize_plane(
            rgb, vid_h, vid_w, upscaling=s.upscaling,
            downscaling=s.downscaling,
            interpolate_at_50pct=s.interpolate_at_50pct)
        return torch_tail(plan, vals, rgb, pack_format=fmt)

    if not want_rot:
        return fn

    def fn_rot(planes):
        if use_k3 and kernels_apply(planes):
            return k3_call(planes)      # already in the final orientation
        return geo_ops.rotate_flip(fn(planes), rotation, flip)

    return fn_rot


def make_frame_fn(plan: PipelinePlan, pack_surface: bool = False,
                  rotation: int = 0, flip: bool = False,
                  fused: bool | None = None):
    """The per-frame processing function.

    Input: a tuple of plane tensors (uint8/uint16), each (..., Hp, Wp) with
    matching leading batch dims, all on one device.  Output: (..., 3, out_h,
    out_w) float32 in [0,1], quantized per the plan — or, with
    ``pack_surface``, (..., out_h, out_w) int32 R10G10B10A2/RGBA8 dwords
    (decode with formats.unpack_rgb10 / unpack_rgba8).

    ``fused=None`` takes the fused linear-resample path where it applies
    (:func:`route_of`: "fused", or for Dolby Vision "dovi_fused"), else
    the staged path; ``False`` forces the staged path.
    ``rotation``/``flip`` give ``rotate_flip(out, rotation, flip)``;
    rotation 90 with flip (a pure transpose) on K6's route is the kernel's
    transposed store, bit-identical to transposing the unrotated surface."""
    if rotation not in (0, 90, 180, 270):
        raise ValueError(f"rotation must be 0/90/180/270, got {rotation}")
    fmt = surface_pack_format(plan.dst) if pack_surface else None
    if fused is None:
        fused = route_of(plan) != "staged"
    if not fused:
        return _make_staged_fn(plan, fmt, rotation, flip)
    inner = (_make_fused_fn if plan.dovi is None
             else _make_dovi_fused_fn)(plan, pack_format=fmt)
    if rotation == 0 and not flip:
        return lambda planes: inner(planes)
    return lambda planes: geo_ops.rotate_flip(inner(planes), rotation, flip)


def serving_rt_keys(plan: PipelinePlan) -> set:
    """The runtime keys this plan's serving function accepts, one per stage
    the plan has: "cmat" with a colour matrix, "hdr" with a local tone map,
    "l2_trims" with enabled L2 trims, "dovi_curves" with Dolby Vision."""
    out = set()
    if plan.apply_matrix:
        out.add("cmat")
    if plan.local_tonemap:
        out.add("hdr")
    if plan.dovi_trims is not None and plan.dovi_trims.l2_enabled:
        out.add("l2_trims")
    if plan.dovi is not None:
        out.add("dovi_curves")
    return out


def make_serving_fn(plan: PipelinePlan, pack_surface: bool = False):
    """Serving mode: one function that takes a scene's values beside the
    planes, ``fn(planes, rt)``, and rebuilds nothing when they change (the
    reference re-uploads its constant buffers per sample instead of
    regenerating shaders).  Optional ``rt`` keys:

      "dovi_curves" — a scene's reshape curves, ``pack_curves`` host arrays
                      (``fn.pack_curves(meta)`` packs and checks them);
      "cmat"        — ``{"m": (3,3), "c": (3,)}`` colour matrix for runtime
                      ProcAmp;
      "hdr"         — a scene's HDR10 values for the local tone map (any of
                      ``ops.tonemap.HDR_KEYS``, host numbers; the plan's
                      metadata fills the others), e.g. MaxCLL per scene
                      (``ops.hdr10plus.runtime_hdr_from_hdr10plus``,
                      ``ops.dovi_ext.runtime_hdr_from_extensions``);
      "l2_trims"    — a scene's Dolby Vision L2 trims, all five
                      ``ops.tonemap.TRIM_KEYS`` as host numbers
                      (``ops.dovi_ext.runtime_trims_from_extensions``); the
                      plan must have enabled trims.

    The plan decides which stages exist; ``rt`` only gives their values.
    An unknown key, or one whose stage the plan lacks, raises with the
    allowed set.  Routes: a fusable plan takes :func:`_make_fused_fn`
    (K2 takes the matrix, the tone map's scalars and the trims per
    launch), a Dolby Vision plan :func:`_make_dovi_fused_fn` (K8, or in the
    two-stage form K2's Dolby Vision route, takes matrix and curves per
    launch, K9 or K2 the tone map's scalars and trims),
    anything else :func:`_make_staged_fn` (its torch convert takes the
    runtime values); :class:`CallValues` resolves them for every route.

    Attributes: ``fn.allowed_rt_keys``; ``fn.dovi_structure``, the reshape
    structure the function serves (None without DoVi); with DoVi
    ``fn.pack_curves(meta)``, which packs a scene's curves and raises when
    their structure is not the plan's."""
    fmt = surface_pack_format(plan.dst) if pack_surface else None
    allowed = serving_rt_keys(plan)
    structure = (None if plan.dovi is None
                 else dovi_ops.curve_structure(plan.dovi))

    inner = (_make_staged_fn(plan, fmt, 0, False)
             if route_of(plan) == "staged" else
             (_make_fused_fn if plan.dovi is None
              else _make_dovi_fused_fn)(plan, pack_format=fmt))

    @trace.spanned(trace.CALL)
    def checked(planes, rt=None):
        rt = rt or {}
        bad = set(rt) - allowed
        if bad:
            raise ValueError(
                f"unknown serving rt key(s) {sorted(bad)}; this plan accepts "
                f"{sorted(allowed)} (stage presence is static: re-plan to add "
                "stages)")
        return inner(planes, rt)

    checked.allowed_rt_keys = frozenset(allowed)
    checked.dovi_structure = structure
    if structure is not None:
        @trace.spanned("vrt.pack_curves")
        def pack_curves(meta):
            return dovi_ops.pack_curves(meta, like=structure)
        checked.pack_curves = pack_curves
    return checked


def make_deint_frame_fn(plan: PipelinePlan, field: int,
                        top_field_first: bool = True,
                        motion_threshold: float = 8.0 / 255.0,
                        pack_surface: bool = False):
    """Per-field processing function for interlaced content: the
    motion-adaptive deinterlace of every plane over a (prev, cur, next)
    window in torch, then :func:`make_frame_fn` on the float32 planes (raw
    code units; on a card K1 ×3 + K2 ×1) — the explicit replacement of the
    D3D11VP rate-conversion blt with past/future reference frames
    (Source/D3D11VP.cpp:292-331,893-960).

    Signature: fn(prev_planes, cur_planes, next_planes) -> the output frame
    of ``field`` (0 = first temporal field, 1 = second)."""
    base = make_frame_fn(plan, pack_surface=pack_surface)
    thr = motion_threshold * (2.0 ** plan.info.plane_bits - 1.0)

    def fn(prev_planes, cur_planes, next_planes):
        return base(tuple(
            deint_ops.motion_adaptive(
                c.to(torch.float32), p.to(torch.float32),
                n.to(torch.float32), field=field,
                top_field_first=top_field_first, threshold=thr)
            for p, c, n in zip(prev_planes, cur_planes, next_planes)))

    return fn


def _can_kernel_deint(plan: PipelinePlan) -> bool:
    """The kernel deinterlace path (K7 + K9) applies: a fusable VP-order
    plan of a planar YUV source whose chroma width divides the luma's by 1
    or 2, with no crop or placement.  The JAX package also asks for the TPU
    backend; here the wrappers choose kernel or plain version from the
    tensors' device."""
    info = plan.info
    dw, _ = info.chroma_div
    return (kernels_allowed(plan)
            and route_of(plan) == "fused" and info.cs_type == ColorSystem.YUV
            and dw in (1, 2) and plan.src_rect is None
            and plan.dst.video_rect is None)


def make_deint_fields_fn(plan: PipelinePlan, top_field_first: bool = True,
                         motion_threshold: float = 8.0 / 255.0,
                         pack_surface: bool = False,
                         force_kernel: bool = False):
    """Double-rate variant of :func:`make_deint_frame_fn`: one function
    renders both temporal fields of a frame from one motion ramp
    (Source/DX11VideoProcessor.cpp:2176-2197).  Returns fn(prev, cur, next)
    -> (field0, field1).

    Where :func:`_can_kernel_deint` holds (or with ``force_kernel``) the
    chain runs H first: K7 deinterlaces both fields inside the banded H
    resize of the three planes (the rate-converter blt analogue,
    Source/D3D11VP.cpp:893-960), then K9 runs the W resize, colour matrix,
    corrections, dither and pack of both fields in one launch over the
    (B, 2, ...) output read as a batch of 2B (the dither phase depends only
    on the row and column).  Otherwise each field is deinterlaced in torch
    and goes through :func:`make_frame_fn`."""
    thr = motion_threshold * (2.0 ** plan.info.plane_bits - 1.0)

    if force_kernel or _can_kernel_deint(plan):
        fmt = surface_pack_format(plan.dst) if pack_surface else None
        maps = PlanMaps(plan)
        # (the blend map stays out: the fields are deinterlaced already)
        wx, wy, cwx, cwy, norm = (maps.wx, maps.wy, maps.cwx, maps.cwy,
                                  maps.norm)
        src_h, vid_w, vid_h = maps.src_h, maps.vid_w, maps.vid_h
        dh = plan.info.chroma_div[1]
        # K7 needs an H map for every plane: the identity where a plane
        # keeps its height
        my_y = rk.BandedMatrix(wy if wy is not None else np.eye(src_h),
                               pre_scale=norm)
        my_c = rk.BandedMatrix(cwy if cwy is not None
                               else np.eye(src_h // dh), pre_scale=norm)
        mx_y = None if wx is None else rk.BandedMatrix(wx)
        mx_c = None if cwx is None else rk.BandedMatrix(cwx)
        epilogue = _make_tail_epilogue(plan)

        def kernel_fn(prev_planes, cur_planes, next_planes):
            ys, us, vs = dk.deint3_rows_dual(
                tuple(prev_planes), tuple(cur_planes), tuple(next_planes),
                my_y, my_c, vid_h, thr, top_field_first)
            lead = ys.shape[:-3]
            out = dk.cols3_tail(
                *(t.reshape((-1,) + t.shape[-2:]) for t in (ys, us, vs)),
                mx_y, mx_c, vid_w, epilogue, pack_format=fmt)
            out = out.reshape(lead + (2,) + out.shape[1:])
            return out.select(len(lead), 0), out.select(len(lead), 1)

        return kernel_fn

    base = make_frame_fn(plan, pack_surface=pack_surface)

    def fn(prev_planes, cur_planes, next_planes):
        d0, d1 = [], []
        for p, c, n in zip(prev_planes, cur_planes, next_planes):
            cf, pf, nf = (x.to(torch.float32) for x in (c, p, n))
            kw = dict(top_field_first=top_field_first, threshold=thr)
            d0.append(deint_ops.motion_adaptive(cf, pf, nf, field=0, **kw))
            d1.append(deint_ops.motion_adaptive(cf, pf, nf, field=1, **kw))
        return base(tuple(d0)), base(tuple(d1))

    return fn


def check_device(device: torch.device | str) -> torch.device:
    """The device an entry point moves its planes to: a CUDA device (which
    must exist: no CPU fallback) or the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class VideoProcessor:
    """Per-configuration processor: plan + frame function on one device.

    The analogue of CVideoProcessor/CDX11VideoProcessor: construct per media
    type (InitMediaType), then call :meth:`process` per frame or batch
    (ProcessSample -> Process).  ``device`` is required: planes are moved
    there, and a CUDA device runs the kernels (or, with
    ``use_accel_backend=False``, the plain versions there)."""

    def __init__(self, settings: Settings, src: SourceDescriptor,
                 dst: OutputDescriptor, *, device: torch.device | str,
                 pack_surface: bool = False):
        self.device = check_device(device)
        self.plan = plan_pipeline(settings, src, dst)
        self.pack_surface = pack_surface
        self._fn = make_frame_fn(self.plan, pack_surface=pack_surface)

    @trace.spanned(trace.CALL)
    def process(self, planes) -> torch.Tensor:
        """planes: sequence of numpy arrays or tensors in canonical plane
        order (Y, U, V or R, G, B)."""
        return self._fn(tuple(torch.as_tensor(p, device=self.device)
                              for p in planes))

    def process_frame(self, frame) -> torch.Tensor:
        """Process an unpacked frame (an object with ``.planes``)."""
        return self.process(frame.planes)

    @trace.spanned(trace.CALL)
    def process_packed(self, buf) -> torch.Tensor:
        """Ship the PACKED frame bytes to ``self.device`` as one tensor (the
        smallest transfer) and unpack them there
        (:func:`~.kernels.unpack_device.unpack_frame_device`) before the
        frame function — the analogue of the reference sampling packed
        textures on the GPU (Source/Shaders.cpp:82-529) instead of
        repacking on the CPU.  ``buf``: bytes, a numpy array or a tensor
        holding one tightly packed frame (arrays and tensors may have
        leading batch dims, shaped (..., n_words) in the format's word).
        A format with no device unpacker is unpacked on the host
        (:func:`~.formats.unpack_frame`), as in the JAX package."""
        from .formats import unpack_frame
        from .kernels.unpack_device import (DEVICE_BUFFER_DTYPE,
                                            has_device_unpacker,
                                            unpack_frame_device)
        info, src = self.plan.info, self.plan.src
        if not has_device_unpacker(info.name):
            return self.process(
                unpack_frame(info.cformat, buf, src.width, src.height).planes)
        if isinstance(buf, (bytes, bytearray, memoryview)):
            buf = np.frombuffer(buf, DEVICE_BUFFER_DTYPE[info.name])
        return self._fn(unpack_frame_device(
            info.name, torch.as_tensor(buf, device=self.device), src.width,
            src.height))
