"""Colorspace math — faithful port of the reference's mpv-derived csputils
(Source/csputils.{h,cpp}) plus the zimg-derived gamut math used by the
shaders (Shaders/convert/colorspace_gamut_conversion.hlsl).

All functions here run host-side at pipeline-build time (numpy); the
resulting 3x3 matrices / offset vectors are handed to the device pipeline
as constants — the analogue of the reference writing them into
constant buffers (Source/DX11VideoProcessor.cpp:813-890).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field

import numpy as np


class CSP(enum.IntEnum):
    """mp_csp (Source/csputils.h:11-22)."""

    AUTO = 0
    BT_601 = 1
    BT_709 = 2
    SMPTE_240M = 3
    BT_2020_NC = 4
    BT_2020_C = 5
    RGB = 6
    XYZ = 7
    YCGCO = 8


class Levels(enum.IntEnum):
    """mp_csp_levels (Source/csputils.h:24-29)."""

    AUTO = 0
    TV = 1
    PC = 2


class Primaries(enum.IntEnum):
    """mp_csp_prim (Source/csputils.h:31-51)."""

    AUTO = 0
    BT_601_525 = 1
    BT_601_625 = 2
    BT_709 = 3
    BT_2020 = 4
    BT_470M = 5
    APPLE = 6
    ADOBE = 7
    PRO_PHOTO = 8
    CIE_1931 = 9
    DCI_P3 = 10
    DISPLAY_P3 = 11
    V_GAMUT = 12
    S_GAMUT = 13
    EBU_3213 = 14
    FILM_C = 15
    ACES_AP0 = 16
    ACES_AP1 = 17


class TRC(enum.IntEnum):
    """mp_csp_trc (Source/csputils.h:53-72)."""

    AUTO = 0
    BT_1886 = 1
    SRGB = 2
    LINEAR = 3
    GAMMA18 = 4
    GAMMA20 = 5
    GAMMA22 = 6
    GAMMA24 = 7
    GAMMA26 = 8
    GAMMA28 = 9
    PRO_PHOTO = 10
    PQ = 11
    HLG = 12
    V_LOG = 13
    S_LOG1 = 14
    S_LOG2 = 15
    ST428 = 16


MP_REF_WHITE = 203.0          # Source/csputils.h:106
MP_REF_WHITE_HLG = 3.17955    # Source/csputils.h:107


@dataclass
class Colorspace:
    """mp_colorspace (Source/csputils.h:92-99)."""

    space: CSP = CSP.AUTO
    levels: Levels = Levels.AUTO
    primaries: Primaries = Primaries.AUTO
    gamma: TRC = TRC.AUTO


@dataclass
class CSPParams:
    """mp_csp_params (Source/csputils.h:109-124)."""

    color: Colorspace = field(default_factory=lambda: Colorspace(CSP.BT_709, Levels.TV))
    levels_out: Levels = Levels.PC
    brightness: float = 0.0   # -1..0..1
    contrast: float = 1.0     # 0..1..2
    hue: float = 0.0          # -pi..0..pi
    saturation: float = 1.0   # 0..1..2
    gamma: float = 1.0
    gray: bool = False
    is_float: bool = False
    texture_bits: int = 8
    input_bits: int = 8


@dataclass
class CMat:
    """mp_cmat: RGB = m @ YUV + c  (Source/csputils.h:159-162)."""

    m: np.ndarray  # (3,3) float64
    c: np.ndarray  # (3,)  float64


# -- CIE xy primaries -------------------------------------------------------

_D50 = (0.34577, 0.35850)
_D65 = (0.31271, 0.32902)
_C = (0.31006, 0.31616)
_DCI = (0.31400, 0.35100)
_E = (1.0 / 3.0, 1.0 / 3.0)

# {prim: (red, green, blue, white)} — mp_get_csp_primaries
# (Source/csputils.cpp:57-205)
_PRIMARIES: dict[Primaries, tuple] = {
    Primaries.BT_470M:    ((0.670, 0.330), (0.210, 0.710), (0.140, 0.080), _C),
    Primaries.BT_601_525: ((0.630, 0.340), (0.310, 0.595), (0.155, 0.070), _D65),
    Primaries.BT_601_625: ((0.640, 0.330), (0.290, 0.600), (0.150, 0.060), _D65),
    Primaries.AUTO:       ((0.640, 0.330), (0.300, 0.600), (0.150, 0.060), _D65),
    Primaries.BT_709:     ((0.640, 0.330), (0.300, 0.600), (0.150, 0.060), _D65),
    Primaries.BT_2020:    ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046), _D65),
    Primaries.APPLE:      ((0.625, 0.340), (0.280, 0.595), (0.115, 0.070), _D65),
    Primaries.ADOBE:      ((0.640, 0.330), (0.210, 0.710), (0.150, 0.060), _D65),
    Primaries.PRO_PHOTO:  ((0.7347, 0.2653), (0.1596, 0.8404), (0.0366, 0.0001), _D50),
    Primaries.CIE_1931:   ((0.7347, 0.2653), (0.2738, 0.7174), (0.1666, 0.0089), _E),
    Primaries.DCI_P3:     ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060), _DCI),
    Primaries.DISPLAY_P3: ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060), _D65),
    Primaries.V_GAMUT:    ((0.730, 0.280), (0.165, 0.840), (0.100, -0.03), _D65),
    Primaries.S_GAMUT:    ((0.730, 0.280), (0.140, 0.855), (0.100, -0.05), _D65),
    Primaries.EBU_3213:   ((0.630, 0.340), (0.295, 0.605), (0.155, 0.077), _D65),
    Primaries.FILM_C:     ((0.681, 0.319), (0.243, 0.692), (0.145, 0.049), _C),
    Primaries.ACES_AP0:   ((0.7347, 0.2653), (0.0000, 1.0000), (0.0001, -0.0770),
                           (0.32168, 0.33767)),
    Primaries.ACES_AP1:   ((0.713, 0.293), (0.165, 0.830), (0.128, 0.044),
                           (0.32168, 0.33767)),
}


def get_primaries(prim: Primaries) -> tuple:
    """(red, green, blue, white) xy pairs (Source/csputils.cpp:57-205)."""
    return _PRIMARIES.get(prim, _PRIMARIES[Primaries.BT_709])


def trc_nom_peak(trc: TRC) -> float:
    """mp_trc_nom_peak (Source/csputils.cpp:210-221)."""
    return {
        TRC.PQ: 10000.0 / MP_REF_WHITE,
        TRC.HLG: 12.0 / MP_REF_WHITE_HLG,
        TRC.V_LOG: 46.0855,
        TRC.S_LOG1: 6.52,
        TRC.S_LOG2: 9.212,
    }.get(trc, 1.0)


def trc_is_hdr(trc: TRC) -> bool:
    """mp_trc_is_hdr (Source/csputils.cpp:223-226)."""
    return trc_nom_peak(trc) > 1.0


# -- 3x3 helpers ------------------------------------------------------------

def invert3x3(m: np.ndarray) -> np.ndarray:
    """Adjoint-based inverse matching mp_invert_matrix3x3
    (Source/csputils.cpp:14-40)."""
    return np.linalg.inv(np.asarray(m, dtype=np.float64))


def rgb2xyz_matrix(prim: Primaries | tuple) -> np.ndarray:
    """mp_get_rgb2xyz_matrix (Source/csputils.cpp:230-263) — Lindbloom method."""
    p = get_primaries(prim) if isinstance(prim, Primaries) else prim
    (rx, ry), (gx, gy), (bx, by), (wx, wy) = p
    X = np.array([rx / ry, gx / gy, bx / by, wx / wy])
    Z = np.array([(1 - rx - ry) / ry, (1 - gx - gy) / gy,
                  (1 - bx - by) / by, (1 - wx - wy) / wy])
    m = np.stack([X[:3], np.ones(3), Z[:3]])
    s = invert3x3(m) @ np.array([X[3], 1.0, Z[3]])
    return np.stack([s * X[:3], s, s * Z[:3]])


_BRADFORD = np.array([
    [0.8951, 0.2664, -0.1614],
    [-0.7502, 1.7135, 0.0367],
    [0.0389, -0.0685, 1.0296],
])


def _xy_to_xyz(xy) -> np.ndarray:
    x, y = xy
    return np.array([x / y, 1.0, (1 - x - y) / y])


def chromatic_adaptation(src_xy, dst_xy, m: np.ndarray) -> np.ndarray:
    """M := M * (Bradford XYZd<-XYZs)  — mp_apply_chromatic_adaptation
    (Source/csputils.cpp:266-308)."""
    if abs(src_xy[0] - dst_xy[0]) < 1e-6 and abs(src_xy[1] - dst_xy[1]) < 1e-6:
        return m
    cs = _BRADFORD @ _xy_to_xyz(src_xy)
    cd = _BRADFORD @ _xy_to_xyz(dst_xy)
    tmp = np.diag(cd / cs) @ _BRADFORD
    return m @ invert3x3(_BRADFORD) @ tmp


def xyz2rgb_cmat(params: CSPParams) -> CMat:
    """ST 428-1 XYZ -> DCI-P3 RGB (mp_get_xyz2rgb_coeffs,
    Source/csputils.cpp:312-336), relative-colorimetric intent."""
    prim = get_primaries(Primaries.DCI_P3)
    m = invert3x3(rgb2xyz_matrix(Primaries.DCI_P3))
    m = chromatic_adaptation((1.0 / 3.0, 1.0 / 3.0), prim[3], m)
    brightness = params.brightness * abs(params.brightness)
    return CMat(m=m, c=np.full(3, brightness))


def csp_mul(csp: CSP, input_bits: int, texture_bits: int) -> float:
    """mp_get_csp_mul (Source/csputils.cpp:341-358)."""
    assert texture_bits >= input_bits
    if not input_bits:
        return 1.0
    if csp == CSP.RGB:
        return ((1 << input_bits) - 1.0) / ((1 << texture_bits) - 1.0)
    if csp == CSP.XYZ:
        return 1.0
    return (1 << input_bits) / ((1 << texture_bits) - 1.0) * 255 / 256


def _luma_coeffs(lr: float, lg: float, lb: float) -> np.ndarray:
    """luma_coeffs (Source/csputils.cpp:380-389)."""
    assert abs(lr + lg + lb - 1) < 1e-6
    return np.array([
        [1, 0, 2 * (1 - lr)],
        [1, -2 * (1 - lb) * lb / lg, -2 * (1 - lr) * lr / lg],
        [1, 2 * (1 - lb), 0],
    ], dtype=np.float64)


def get_csp_matrix(params: CSPParams) -> CMat:
    """mp_get_csp_matrix (Source/csputils.cpp:392-509): YUV->RGB matrix with
    brightness/contrast/hue/saturation and level expansion baked in."""
    colorspace = params.color.space
    if colorspace <= CSP.AUTO or colorspace > CSP.YCGCO:
        colorspace = CSP.BT_601
    levels_in: int = params.color.levels
    if levels_in <= Levels.AUTO or levels_in > Levels.PC:
        levels_in = Levels.TV

    c = np.zeros(3)
    if colorspace == CSP.BT_601:
        m = _luma_coeffs(0.299, 0.587, 0.114)
    elif colorspace == CSP.BT_709:
        m = _luma_coeffs(0.2126, 0.7152, 0.0722)
    elif colorspace == CSP.SMPTE_240M:
        m = _luma_coeffs(0.2122, 0.7013, 0.0865)
    elif colorspace == CSP.BT_2020_NC:
        m = _luma_coeffs(0.2627, 0.6780, 0.0593)
    elif colorspace == CSP.BT_2020_C:
        m = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], dtype=np.float64)
    elif colorspace == CSP.RGB:
        m = np.eye(3)
        levels_in = -1
    elif colorspace == CSP.XYZ:
        cm = xyz2rgb_cmat(params)
        m, c = cm.m, cm.c
        levels_in = -1
    elif colorspace == CSP.YCGCO:
        m = np.array([[1, -1, 1], [1, 1, 0], [1, -1, -1]], dtype=np.float64)
    else:
        raise ValueError(colorspace)

    if params.is_float:
        levels_in = -1

    if colorspace in (CSP.BT_601, CSP.BT_709, CSP.SMPTE_240M, CSP.BT_2020_NC):
        huecos = 0.0 if params.gray else params.saturation * math.cos(params.hue)
        huesin = 0.0 if params.gray else params.saturation * math.sin(params.hue)
        u, v = m[:, 1].copy(), m[:, 2].copy()
        m[:, 1] = huecos * u - huesin * v
        m[:, 2] = huesin * u + huecos * v

    s = csp_mul(colorspace, params.input_bits, params.texture_bits) / 255

    # yuv levels (0-255 scale * s)
    if levels_in == Levels.TV:
        ymin, ymax, cmax, cmid = 16 * s, 235 * s, 240 * s, 128 * s
    elif levels_in == Levels.PC:
        ymin, ymax, cmax, cmid = 0 * s, 255 * s, 255 * s, 128 * s
    elif levels_in == -1:
        ymin, ymax, cmax, cmid = 0 * s, 255 * s, 255 * s / 2, 0.0
    else:
        raise ValueError(levels_in)

    levels_out = params.levels_out
    if levels_out <= Levels.AUTO or levels_out > Levels.PC:
        levels_out = Levels.PC
    if levels_out == Levels.TV:
        rmin, rmax = 16 / 255.0, 235 / 255.0
    else:
        rmin, rmax = 0.0, 1.0

    ymul = (rmax - rmin) / (ymax - ymin)
    cmul = (rmax - rmin) / (cmax - cmid) / 2
    ymul *= params.contrast
    cmul *= params.contrast

    out_c = np.zeros(3)
    for i in range(3):
        m[i, 0] *= ymul
        m[i, 1] *= cmul
        m[i, 2] *= cmul
        out_c[i] = (rmin - m[i, 0] * ymin - (m[i, 1] + m[i, 2]) * cmid
                    + params.brightness)
    if colorspace == CSP.XYZ:
        out_c += c
    return CMat(m=m, c=out_c)


def invert_cmat(cm: CMat) -> CMat:
    """mp_invert_cmat (Source/csputils.cpp:511-524)."""
    m = invert3x3(cm.m)
    return CMat(m=m, c=-(m @ cm.c))


def gamut_conversion_matrix(csp_in: Primaries, csp_out: Primaries) -> np.ndarray:
    """GetColorspaceGamutConversionMatrix (Source/csputils.cpp:549-557):
    RGB(in primaries) -> RGB(out primaries), no chromatic adaptation
    (both through XYZ)."""
    m_in = rgb2xyz_matrix(csp_in)
    return invert3x3(rgb2xyz_matrix(csp_out)) @ m_in


def bt2020_to_bt709_matrix() -> np.ndarray:
    """The constant used by the HDR shaders
    (Shaders/convert/colorspace_gamut_conversion.hlsl:90-96)."""
    return gamut_conversion_matrix(Primaries.BT_2020, Primaries.BT_709)


# -- DXVA2-extended-format analogue ------------------------------------------
# Off Windows there is no DXVA2_ExtendedFormat dword; SourceDescriptor in
# pipeline.py carries these enums directly.  These helpers port the defaulting
# rules so behavior matches the reference.

class ChromaLocation(enum.IntEnum):
    """DXVA2_VideoChromaSubsampling values used by the codegen
    (Source/Shaders.cpp:120-142)."""

    UNKNOWN = 0
    MPEG1 = 1      # center siting
    MPEG2 = 5      # left siting (default)
    COSITED = 7    # top-left


def default_matrix_for_size(width: int, height: int) -> CSP:
    """SD->BT.601, HD->BT.709 defaulting (SpecifyExtendedFormat,
    Source/Helper.cpp:1190-1197)."""
    return CSP.BT_601 if (width <= 1024 and height <= 576) else CSP.BT_709
