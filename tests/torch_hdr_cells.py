"""The HDR10+ and Dolby Vision extension cells of the torch port's tests
(c7p, c8x, c8hdr), built alike for the JAX package and its port, and a
field-by-field comparison of the two packages' values.

 * c7p: c7's source (P010 PQ BT.2020, mastering 4000 nits, MaxCLL 3000,
   MaxFALL 800) with HDR10+ metadata whose one window carries a guided
   curve (knee (0.25, 0.3), anchors 0.4, 0.7, 0.9, maxscl 0.4: a 4000-nit
   scene peak) to RGB10 PQ for a 600-nit display: selection 7.
 * c8x: c8's source and RPU metadata with extension blocks L1 (62, 3079,
   1229) and L2 trims for 100-, 600- and 1000-nit targets, to RGB10 SDR;
   the trims are selected for a 100-nit display (the SDR display's peak).
 * c8hdr: the same source to a 600-nit HDR display (RGB10 PQ) with the
   local tone map: BT.2390 upgraded to ST 2094-10 by L1, the trims in nits
   before it.
"""

import dataclasses
import enum

import numpy as np

import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu import config as jcfg, csputils as jcsp
from videorenderer_tpu.formats import ColorFormat as JFmt
from videorenderer_tpu.ops import dovi as jdovi
from videorenderer_tpu.ops import dovi_ext as jext
from videorenderer_tpu.ops import hdr10plus as jh10p

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.ops import dovi as tdovi
from videorenderer_tpu_torch.ops import dovi_ext as text
from videorenderer_tpu_torch.ops import hdr10plus as th10p

JAX = dict(cfg=jcfg, csp=jcsp, pipe=jpipe, fmt=JFmt, dovi=jdovi, ext=jext,
           h10p=jh10p)
TORCH = dict(cfg=tcfg, csp=tcsp, pipe=tpipe, fmt=TFmt, dovi=tdovi,
             ext=text, h10p=th10p)
CELLS = ("c7p", "c8x", "c8hdr")


def guided_meta(h10p, peak=0.4, avg=0.05, anchors=(0.4, 0.7, 0.9), kx=0.25,
                ky=0.3, flag=1):
    """c7p's HDR10+ metadata (tests/test_hdr10plus.py's guided window)."""
    return h10p.HDR10PlusMetadata(windows=(h10p.HDR10PlusWindow(
        maxscl=(peak, peak, peak), average_maxrgb=avg,
        tone_mapping_flag=flag, knee_point_x=kx, knee_point_y=ky,
        bezier_curve_anchors=tuple(anchors)),))


def dovi_meta(dovi):
    """c8's RPU metadata: identity curves, the BT.2020 ycc_to_rgb matrix,
    LMS matrices that are mutual inverses."""
    return dovi.DoviMetadata(
        curves=(dovi.identity_curve(),) * 3,
        ycc_to_rgb_matrix=np.array([[1, 0, 1.4746],
                                    [1, -0.164553, -0.571353],
                                    [1, 1.8814, 0]]),
        ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
        rgb_to_lms_matrix=np.linalg.inv(dovi.DOVI_LMS2RGB))


YCC_TO_RGB = np.array([[1, 0, 1.4746], [1, -0.164553, -0.571353],
                       [1, 1.8814, 0]])


def _kind_curves(dovi, kind: str) -> tuple:
    """The three reshape curves of ``kind``: c8's identity curves; the
    variant's (a 2-piece polynomial on Y, polynomial + MMR order 2 on Cb,
    MMR order 3 on Cr); tests/test_pallas_resize.py's (a 2-piece polynomial
    luma curve, one order-2 MMR piece on each chroma)."""
    if kind == "c8":
        return (dovi.identity_curve(),) * 3
    if kind == "mmr":
        coef = np.random.default_rng(19).normal(0, 0.05, (1, 3, 7))
        mmr = dovi.ReshapeCurve(pivots=(), method=(1,), poly=np.zeros((1, 3)),
                                mmr_order=(2,), mmr_constant=(0.4,),
                                mmr_coef=coef)
        luma = dovi.ReshapeCurve(
            pivots=(0.5,), method=(0, 0),
            poly=np.array([[0.02, 0.9, 0.1], [0.0, 1.0, -0.05]]))
        return luma, mmr, mmr
    rng = np.random.default_rng(21)
    y = dovi.ReshapeCurve(
        pivots=(0.45,), method=(0, 0),
        poly=np.array([[0.01, 0.95, 0.05], [-0.02, 1.05, -0.03]])
        + rng.uniform(-0.005, 0.005, (2, 3)))
    cb_coef = np.zeros((2, 3, 7))
    cb_coef[1, 0] = [0.0, 0.98, 0.0, 0.02, 0.0, -0.01, 0.0]
    cb_coef[1, 1] = [0.0, 0.01, 0.0, 0.0, 0.005, 0.0, 0.01]
    cb = dovi.ReshapeCurve(pivots=(0.5,), method=(0, 1),
                           poly=np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 0.0]]),
                           mmr_order=(0, 2), mmr_constant=(0.0, 0.01),
                           mmr_coef=cb_coef)
    cr_coef = np.zeros((1, 3, 7))
    cr_coef[0, 0] = [0.0, 0.0, 0.97, 0.0, 0.02, 0.01, 0.0]
    cr_coef[0, 1] = [0.0, 0.0, 0.02, 0.01, 0.0, 0.0, 0.0]
    cr_coef[0, 2] = [0.0, 0.0, 0.005, 0.0, 0.0, 0.0, 0.003]
    cr = dovi.ReshapeCurve(pivots=(), method=(1,),
                           poly=np.array([[0.0, 1.0, 0.0]]), mmr_order=(3,),
                           mmr_constant=(-0.005,), mmr_coef=cr_coef)
    return y, cb, cr


def dovi_kind_meta(m: dict, kind: str):
    """The DoviMetadata of ``kind`` ("c8", "variant", "mmr") in package
    ``m`` (:data:`JAX` or :data:`TORCH`): the variant's LMS product has 2%
    crosstalk, so its LMS step does not fold away."""
    dovi = m["dovi"]
    lms = np.linalg.inv(dovi.DOVI_LMS2RGB)
    if kind == "variant":
        lms = lms @ (0.94 * np.eye(3) + 0.02)
    return dovi.DoviMetadata(curves=_kind_curves(dovi, kind),
                             ycc_to_rgb_matrix=YCC_TO_RGB,
                             ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
                             rgb_to_lms_matrix=lms)


def dovi_extensions(ext, max_pq=3079, slope_100=1800):
    """c8x's extension blocks: L1 (62, ``max_pq``, 1229) and L2 trims for
    100-, 600- and 1000-nit targets (tests/test_dovi_ext.py's _l2)."""
    def l2(nits, **kw):
        return ext.L2Extension(
            target_max_pq=int(round(ext.nits_to_pq(nits) * 4095)), **kw)
    return ext.DoviExtensions(
        l1=ext.L1Extension(min_pq=62, max_pq=max_pq, avg_pq=1229),
        l2=(l2(100, trim_slope=slope_100, trim_offset=2100, trim_power=2200,
               trim_chroma_weight=2148, trim_saturation_gain=2348),
            l2(600, trim_slope=2000, trim_power=1900,
               trim_saturation_gain=2148),
            l2(1000, trim_slope=2200)))


def cell_args(m: dict, cell: str, w=64, h=32, ow=32, oh=16,
              tex_format: str = "AUTOINT", bits: int = 10, **src):
    """(Settings, SourceDescriptor, OutputDescriptor) of ``cell`` in the
    package ``m`` (:data:`JAX` or :data:`TORCH`) at w x h -> ow x oh and
    ``bits`` (16: float out); ``src`` overrides SourceDescriptor fields."""
    cfg, csp, pipe, fmt = m["cfg"], m["csp"], m["pipe"], m["fmt"]
    tex = cfg.TexFormat[tex_format]
    hdr_settings = dict(convert_to_sdr=False, hdr_passthrough=True,
                        hdr_local_tone_mapping=True,
                        hdr_local_tone_mapping_type=cfg.ToneMapType.BT2390,
                        hdr_display_max_nits=600, tex_format=tex)
    if cell == "c7p":
        kw = dict(hdr10=pipe.HDR10Metadata(mastering_max_nits=4000.0,
                                           max_cll=3000.0, max_fall=800.0),
                  hdr10plus=guided_meta(m["h10p"]))
        settings = cfg.Settings(**hdr_settings)
        out = pipe.OutputDescriptor(width=ow, height=oh, bits=bits, hdr=True)
    else:
        hdr = cell == "c8hdr"
        kw = dict(levels=csp.Levels.TV, dovi=dovi_meta(m["dovi"]),
                  hdr10=pipe.HDR10Metadata(),
                  dovi_ext=dovi_extensions(m["ext"]))
        settings = (cfg.Settings(upscaling=cfg.Upscaling.CATMULL_ROM,
                                 **hdr_settings) if hdr else
                    cfg.Settings(convert_to_sdr=True,
                                 upscaling=cfg.Upscaling.CATMULL_ROM,
                                 hdr_display_max_nits=100, tex_format=tex))
        out = pipe.OutputDescriptor(width=ow, height=oh, bits=bits, hdr=hdr)
    kw.update(src)
    return (settings,
            pipe.SourceDescriptor(format=fmt.P010, width=w, height=h,
                                  matrix=csp.CSP.BT_2020_NC,
                                  primaries=csp.Primaries.BT_2020,
                                  transfer=csp.TRC.PQ, **kw),
            out)


def plans(cell: str, **kw):
    """(JAX plan, port plan) of ``cell``."""
    return (jpipe.plan_pipeline(*cell_args(JAX, cell, **kw)),
            tpipe.plan_pipeline(*cell_args(TORCH, cell, **kw)))


def p010(seed: int, n: int = 2, w: int = 64, h: int = 32):
    """n raw P010 frames (y, u, v) from a numpy seed, codes 64-940/960."""
    rng = np.random.default_rng(seed)
    return (rng.integers(64, 941, (n, h, w), np.uint16) << 6,
            rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6,
            rng.integers(64, 961, (n, h // 2, w // 2), np.uint16) << 6)


def plain_value(x):
    """A package-independent form of a plan's value: dataclasses by class
    name and fields, enums by class, name and value, arrays by dtype, shape
    and bytes, numpy scalars as Python numbers."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, plain_value(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (tuple, list)):
        return tuple(plain_value(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, plain_value(v)) for k, v in x.items()))
    if isinstance(x, np.generic):
        return x.item()
    return x


def plan_differences(jplan, tplan) -> list:
    """The names of the JAX plan's fields whose port values differ."""
    return [f.name for f in dataclasses.fields(jplan)
            if plain_value(getattr(jplan, f.name))
            != plain_value(getattr(tplan, f.name))]


def codes10(dwords) -> np.ndarray:
    d = np.asarray(dwords).view(np.uint32)
    return np.stack([(d >> s) & 0x3FF for s in (0, 10, 20)],
                    -3).astype(np.int64)


def assert_mid16_band(got, ref):
    """The kernel routes' band of 10-bit codes (ROADMAP's mid16 band):
    within 1 code on >= 99.9% of the channels, none beyond 3."""
    d = np.abs(codes10(got) - codes10(ref))
    assert got.shape == ref.shape
    assert (d <= 1).mean() >= 0.999 and d.max() <= 3, (d.max(),
                                                       (d > 1).mean())
