"""Pipeline builder: (Settings, source, output) -> a frame function on torch
tensors.

Port of the main path of ``videorenderer_tpu.pipeline``, the analogue of the
reference's media-type negotiation (CDX11VideoProcessor::InitMediaType,
Source/DX11VideoProcessor.cpp:1742-1959), shader codegen
(GetShaderConvertColor, Source/Shaders.cpp:593-930) and render passes
(CDX11VideoProcessor::Process, Source/DX11VideoProcessor.cpp:3297-3436).

The path is the fused linear-resample one (VP order): chroma upsampling and
the separable resize compose into one banded matrix per plane and axis, so
the colour matrix, transfer functions, tone map and dither all run at
output resolution.  With ``Settings.use_accel_backend`` (the default) it
runs as kernel K1 (the W pass of each plane, int16 "mid16" intermediates)
and kernel K2 (the H pass of all three planes, the colour matrix, the
corrections, the dither and the surface pack); their wrappers take the
plain versions for CPU tensors.  With ``use_accel_backend=False`` the same
math runs as plain PyTorch (dense float32 products, then the tail), like the
JAX package's XLA path.

What this port does not carry yet is refused with ``NotImplementedError``
naming the ROADMAP item that brings it, never routed elsewhere.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from . import csputils
from .config import Settings, TexFormat, Upscaling
from .csputils import (CSP, ChromaLocation, Colorspace, CSPParams, Levels,
                       Primaries, TRC)
from .formats import ColorFormat, ColorSystem, FormatInfo, get_format_info
from .kernels import resize as rk
from .ops import chroma as chroma_ops
from .ops import dither as dither_ops
from .ops import scale as scale_ops
from .ops import tonemap as tonemap_ops
from .ops import transfer as transfer_ops


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
    The same fields as the JAX package's; ``dovi``, ``dovi_trims``,
    ``dovi_ext`` and ``hdr10plus`` are refused by :func:`plan_pipeline`."""

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
    # placement of the video inside the surface: refused (ROADMAP item 3)
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


# ROADMAP.md "Modules to port": where each refused feature comes in
_ROADMAP = {
    "staged": "item 3 (staged and fallback path)",
    "serving": "item 4 (serving and local tone mapping)",
    "jinc2": "item 5 (Jinc2 upscale and rotation)",
    "dovi": "item 6 (Dolby Vision)",
}


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to videorenderer_tpu_torch yet: ROADMAP.md, "
        f"modules to port, {_ROADMAP[item]}")


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


def _axis_choices(s: Settings, src: SourceDescriptor, src_rect,
                  dst: OutputDescriptor):
    """(src_w, src_h, x scaler choice, y scaler choice) after the crop."""
    src_w, src_h = src.width, src.height
    if src_rect is not None:
        l, t, r, b = src_rect
        src_w, src_h = r - l, b - t
    vid_w, vid_h = dst.video_size
    cx = scale_ops.select_scaler(src_w, vid_w, s.upscaling, s.downscaling,
                                 s.interpolate_at_50pct)
    cy = scale_ops.select_scaler(src_h, vid_h, s.upscaling, s.downscaling,
                                 s.interpolate_at_50pct)
    return src_w, src_h, cx, cy


def _check_ported(plan: PipelinePlan) -> None:
    """Refuse every plan combination this port does not carry yet."""
    s, src, dst, info = plan.settings, plan.src, plan.dst, plan.info
    if src.dovi is not None or src.dovi_trims is not None:
        _refuse("Dolby Vision", "dovi")
    if src.dovi_ext is not None:
        _refuse("Dolby Vision extension metadata (dovi_ext)", "dovi")
    if src.hdr10plus is not None:
        _refuse("HDR10+ dynamic metadata", "serving")
    if dst.hdr and s.hdr_local_tone_mapping and src.is_hdr:
        _refuse("local tone mapping", "serving")
    if info.cs_type == ColorSystem.GRAY:
        _refuse("GRAY sources", "staged")
    if not s.vp_scaling:
        _refuse("the shader-order pipeline (vp_scaling=False)", "staged")
    if dst.video_rect is not None:
        _refuse("video_rect placement", "staged")
    _, _, cx, cy = _axis_choices(s, src, plan.src_rect, dst)
    if ("up", Upscaling.JINC2) in (cx, cy):
        _refuse("the Jinc2 upscaler", "jinc2")


def plan_pipeline(settings: Settings, src: SourceDescriptor,
                  dst: OutputDescriptor) -> PipelinePlan:
    """Static planning — the InitMediaType analogue; the same resolution
    as the JAX package's ``plan_pipeline`` for every plan it accepts."""
    src = src.specified()
    info = get_format_info(src.format)
    m, c, apply_matrix = _build_cmat(src, info)

    is_pq = src.transfer == TRC.PQ
    is_hlg = src.transfer == TRC.HLG
    bt2020 = src.primaries == Primaries.BT_2020

    convert_to_sdr = (not dst.hdr) and settings.convert_to_sdr and (
        is_pq or is_hlg)
    hlg_to_pq = dst.hdr and settings.hdr_passthrough and is_hlg
    # SDR source with BT.2020 primaries shown on a 709 display
    # (ps_fix_bt2020.hlsl; codegen branch Source/Shaders.cpp:892-915)
    fix_bt2020_sdr = bt2020 and not (is_pq or is_hlg) and not dst.hdr
    sdr_gamma = {
        TRC.LINEAR: 1.0, TRC.GAMMA18: 1.8, TRC.GAMMA20: 2.0,
        TRC.GAMMA26: 2.6, TRC.GAMMA28: 2.8,
    }.get(src.transfer, 2.2)

    h = src.hdr10 or HDR10Metadata()
    tm_params = tonemap_ops.HDRParams(
        mastering_min_nits=h.mastering_min_nits,
        mastering_max_nits=h.mastering_max_nits,
        max_cll=h.max_cll, max_fall=h.max_fall,
        display_max_nits=float(settings.hdr_display_max_nits))

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

    plan = PipelinePlan(
        settings=settings, src=src, dst=dst, info=info,
        cmat_m=m, cmat_c=c, apply_matrix=apply_matrix,
        convert_to_sdr=convert_to_sdr, hlg_to_pq=hlg_to_pq,
        fix_bt2020_sdr=fix_bt2020_sdr, sdr_gamma=sdr_gamma,
        dither_bits=dither_bits, src_rect=src.src_rect,
        tonemap_params=tm_params)
    _check_ported(plan)
    return plan


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


def _gamut_2020_to_709(x: torch.Tensor, axis: int) -> torch.Tensor:
    gm = csputils.bt2020_to_bt709_matrix()
    r, g, b = (x.narrow(axis, i, 1) for i in range(3))
    return torch.cat(
        [float(gm[i, 0]) * r + float(gm[i, 1]) * g + float(gm[i, 2]) * b
         for i in range(3)], dim=axis)


def _corrections(plan: PipelinePlan, rgb: torch.Tensor) -> torch.Tensor:
    """Post-scale correction shaders (selection in InitMediaType,
    Source/DX11VideoProcessor.cpp:1896-1930) on (..., 3, H, W)."""
    s = plan.settings
    axis = -3
    if plan.convert_to_sdr:
        # ps_convert_pq_to_sdr.hlsl / HLG variant: -> linear (SDR-relative)
        # -> Hable -> 2020->709 -> sRGB-ish gamma
        luminance_scale = 10000.0 / s.sdr_display_nits
        x = torch.clamp(rgb, 0.0, 1.0)
        if plan.src.transfer == TRC.HLG:
            # the reference runs HLGtoLinear -> LinearToST2084(1000), clips,
            # then ST2084ToLinear(ls) in a second pass; the PQ round trip is
            # algebraically clip(x/1000, 0, 1) * ls
            x = transfer_ops.hlg_to_linear(x, axis=axis)
            x = torch.clamp(x * (1.0 / 1000.0), 0.0, 1.0) * luminance_scale
        else:
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


def _final_pass(plan: PipelinePlan, rgb: torch.Tensor) -> torch.Tensor:
    """ps_final_pass.hlsl: ordered dither (pattern origin at row and column
    0) or rounding to the output depth."""
    db = plan.dither_bits
    if db < 0:
        return dither_ops.quantize(torch.clamp(rgb, 0.0, 1.0), -db)
    if db > 0:
        return dither_ops.ordered_dither(torch.clamp(rgb, 0.0, 1.0), db)
    return rgb


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


def _tail_common(plan: PipelinePlan, rgb: torch.Tensor) -> torch.Tensor:
    """Corrections, then the final pass: the torch version of K2's epilogue
    after the colour matrix."""
    return _final_pass(plan, _corrections(plan, rgb))


def _make_tail_epilogue(plan: PipelinePlan) -> rk.Epilogue:
    """K2's epilogue for this plan: colour matrix, corrections and dither,
    as kernel parameters and as the torch function of the plain version."""
    if plan.hlg_to_pq or plan.fix_bt2020_sdr:
        _refuse("HLG->PQ and the SDR BT.2020 fix inside kernel K2 (the "
                "plain path, use_accel_backend=False, has them)", "staged")
    correction = rk.CORR_NONE
    if plan.convert_to_sdr:
        correction = (rk.CORR_HLG_TO_SDR if plan.src.transfer == TRC.HLG
                      else rk.CORR_PQ_TO_SDR)
    m = np.asarray(plan.cmat_m, np.float32)
    c = np.asarray(plan.cmat_c, np.float32)

    def plain(y, u, v):
        rgb = (_apply_cmat(m, c, y, u, v) if plan.apply_matrix
               else torch.stack([y, u, v], dim=-3))
        return _tail_common(plan, rgb)

    return rk.Epilogue(
        cmat=np.concatenate([m, c[:, None]], axis=1) if plan.apply_matrix else None,
        correction=correction,
        luminance_scale=10000.0 / plan.settings.sdr_display_nits,
        dither_bits=plan.dither_bits,
        gamut=np.asarray(csputils.bt2020_to_bt709_matrix(), np.float32),
        plain=plain)


def _compose(a: np.ndarray | None, b: np.ndarray | None):
    """Compose two (in,out) axis maps applied a-then-b."""
    if a is None:
        return b
    if b is None:
        return a
    return a @ b


def _make_fused_fn(plan: PipelinePlan, pack_format: str | None = None):
    """The fused pipeline: chroma upsample + (blend deinterlace) + separable
    resize collapse into one banded matrix per plane per axis (linear maps
    compose), so everything nonlinear runs at output resolution."""
    s, src, dst, info = plan.settings, plan.src, plan.dst, plan.info
    use_kernels = s.use_accel_backend and _vp_format_allowed(s, info)

    src_w, src_h, cx, cy = _axis_choices(s, src, plan.src_rect, dst)
    vid_w, vid_h = dst.video_size
    wx = scale_ops.build_axis_matrix(cx, src_w, vid_w)
    wy = scale_ops.build_axis_matrix(cy, src_h, vid_h)

    wy_luma = wy
    if (s.deint_blend and src.interlaced and info.subsampling == 420
            and info.cs_type == ColorSystem.YUV):
        wy_luma = _compose(chroma_ops.blend_deinterlace_matrix(src_h), wy)

    if info.cs_type == ColorSystem.YUV:
        dw, dh = info.chroma_div
        ux, uy = chroma_ops.chroma_upsample_matrices(
            src_w // dw, src_h // dh, info.subsampling, s.chroma_scaling,
            src.chroma_location)
        cwx, cwy = _compose(ux, wx), _compose(uy, wy)
    else:
        cwx, cwy = wx, wy

    norm = 1.0 / (2.0 ** info.plane_bits - 1.0)

    if not use_kernels:
        # (matrix id, device) -> float32 tensor, made once; the matrices
        # live as long as this closure, so their ids stay theirs
        on_device: dict = {}

        def dense(mat, device):
            key = (id(mat), device)
            if key not in on_device:
                on_device[key] = torch.from_numpy(
                    np.asarray(mat, np.float32)).to(device)
            return on_device[key]

        def app(p, mx, my):
            x = p.to(torch.float32) * float(np.float32(norm))
            if mx is not None:
                x = scale_ops.resize_axis(x, dense(mx, x.device), -1)
            if my is not None:
                x = scale_ops.resize_axis(x, dense(my, x.device), -2)
            return x

        m = np.asarray(plan.cmat_m, np.float32)
        c = np.asarray(plan.cmat_c, np.float32)

        def plain_fn(planes):
            planes = _crop_planes(plan, planes)
            comps = (app(planes[0], wx, wy_luma), app(planes[1], cwx, cwy),
                     app(planes[2], cwx, cwy))
            rgb = _tail_common(plan, _apply_cmat(m, c, *comps)
                               if plan.apply_matrix
                               else torch.stack(comps, dim=-3))
            return rgb if pack_format is None else rk.pack_surface(rgb, pack_format)

        return plain_fn

    # Compact W-pass intermediates: int16 codes round(x * MID16_SCALE), the
    # analogue of the reference's TEXFMT_AUTOINT UNORM intermediate textures
    # (Source/DX11VideoProcessor.cpp:1145-1151); an explicit FLOAT16 request
    # keeps float32.  int16 range guard: a W-pass output is bounded by the
    # column L1 norm of its normalized matrix, so a plane keeps float32 when
    # that norm times MID16_SCALE exceeds 32767.
    def fits(mat):
        return (mat is not None and
                float(np.abs(mat).sum(axis=0).max()) * rk.MID16_SCALE <= 32767.0)

    mid16 = s.tex_format != TexFormat.FLOAT16
    epilogue = _make_tail_epilogue(plan)

    def plane_pass(mx, my, q):
        """(W matrix, H matrix, direct-read scale) of one plane class: the
        UNORM normalisation folds into the W matrix; what the H pass must
        undo (mid16 codes, or the raw normalisation when there is no W
        pass) folds into the H matrix, or scales a directly read plane."""
        kw = None if mx is None else rk.BandedMatrix(mx, pre_scale=norm)
        h_scale = norm if mx is None else (1.0 / rk.MID16_SCALE if q else None)
        kh = None if my is None else rk.BandedMatrix(my, pre_scale=h_scale)
        return kw, kh, (h_scale if my is None else None)

    mid16_y, mid16_c = mid16 and fits(wx), mid16 and fits(cwx)
    kw_y, kh_y, y_scale = plane_pass(wx, wy_luma, mid16_y)
    kw_c, kh_c, c_scale = plane_pass(cwx, cwy, mid16_c)

    def kernel_fn(planes):
        planes = _crop_planes(plan, planes)

        def wpass(p, kw, q):
            return p if kw is None else rk.banded_resize_last_axis(p, kw, mid16=q)

        yw = wpass(planes[0], kw_y, mid16_y)
        uw = wpass(planes[1], kw_c, mid16_c)
        vw = wpass(planes[2], kw_c, mid16_c)
        return rk.rows3_tail(yw, uw, vw, kh_y, kh_c, vid_h, epilogue,
                             y_scale=y_scale, c_scale=c_scale,
                             pack_format=pack_format)

    return kernel_fn


def make_frame_fn(plan: PipelinePlan, pack_surface: bool = False,
                  rotation: int = 0, flip: bool = False):
    """The per-frame processing function.

    Input: a tuple of plane tensors (uint8/uint16), each (..., Hp, Wp) with
    matching leading batch dims, all on one device.  Output: (..., 3, out_h,
    out_w) float32 in [0,1], quantized per the plan — or, with
    ``pack_surface``, (..., out_h, out_w) int32 R10G10B10A2/RGBA8 dwords
    (decode with formats.unpack_rgb10 / unpack_rgba8)."""
    if rotation not in (0, 90, 180, 270):
        raise ValueError(f"rotation must be 0/90/180/270, got {rotation}")
    if rotation or flip:
        _refuse("rotation and flip", "jinc2")
    _check_ported(plan)
    fmt = surface_pack_format(plan.dst) if pack_surface else None
    return _make_fused_fn(plan, pack_format=fmt)


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
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is "
                               "not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.plan = plan_pipeline(settings, src, dst)
        self.pack_surface = pack_surface
        self._fn = make_frame_fn(self.plan, pack_surface=pack_surface)

    def process(self, planes) -> torch.Tensor:
        """planes: sequence of numpy arrays or tensors in canonical plane
        order (Y, U, V or R, G, B)."""
        return self._fn(tuple(torch.as_tensor(p, device=self.device)
                              for p in planes))

    def process_frame(self, frame) -> torch.Tensor:
        """Process an unpacked frame (an object with ``.planes``)."""
        return self.process(frame.planes)
