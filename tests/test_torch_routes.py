"""The routes of the port's kernels on strong downscales, and the offset
store, on the CPU.

 * Route choice: for 3840 x 2160 and 1920 x 1080 sources, every
   ``Downscaling`` and outputs down to 16 x 16, each path's maps built with
   the port's own functions (``pipeline.fused_maps`` and
   ``fused_plane_pass`` for the fused route's K1 and K2, with mid16 and
   with float32 planes as single-rate deinterlacing gives them; the GRAY
   route's K1 and K3; the deinterlacing path's K7 and K9; the Dolby Vision
   path's K1, K8 and K9): every kernel's route choice (``k1_rows``,
   ``k2_route``, ``k3_route``, ``k7_route``, ``k8_route``, ``k9_route``)
   takes each map, staged where its window fits the shared memory and the
   long-window route where it does not, and never refuses one.
 * The same ratio at CPU size (1280 x 720 -> 53 x 30, the 4K thumbnail's
   24:1; and 5:1) through the JAX package (Pallas in interpret mode) and
   the port's kernel route (its plain versions): within 1 code on >= 99.9%
   of the channels, at most 3, or no further from the JAX XLA route than
   the JAX kernel route is (``_code_band``).
 * K4 (``k4_route``) on the same plans' fused maps, the headline source's
   thumbnails (160 x 90 Lanczos, 120 x 68 Hamming: the long-window route,
   over the 200 KB the kernel before the routes refused), its plain version
   against the JAX ``mega3_tail`` in interpret mode at 24:1 and 5:1, and
   its compiled tail routes read from the source.
 * The offset store's index math (route.cuh's ``store_group`` with a
   ``Place``) replayed in numpy: the stores of an aligned and an unaligned
   column offset cover the rect once, the 16-byte stores are aligned, the
   planar index is the surface's, and the bars (``resize.fill_bars``) are
   the rest.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videorenderer_tpu.pipeline as jpipe
from videorenderer_tpu import config as jcfg, csputils as jcsp
from videorenderer_tpu.formats import ColorFormat as JFmt
from videorenderer_tpu.kernels import resize_pallas as jrp

import videorenderer_tpu_torch.pipeline as tpipe
from videorenderer_tpu_torch import config as tcfg, csputils as tcsp
from videorenderer_tpu_torch.formats import ColorFormat as TFmt
from videorenderer_tpu_torch.kernels import deint as tdk
from videorenderer_tpu_torch.kernels import resize as trk
from videorenderer_tpu_torch.ops import chroma as tchroma
from videorenderer_tpu_torch.ops import dovi as tdovi
from videorenderer_tpu_torch.ops import scale as tscale

SOURCES = [(3840, 2160), (1920, 1080)]
OUTPUTS = [(960, 540), (640, 360), (480, 270), (320, 180), (160, 90),
           (64, 36), (16, 16)]


def _plan(sw, sh, ow, oh, down, fmt=TFmt.P010, **src):
    return tpipe.plan_pipeline(
        tcfg.Settings(downscaling=down, convert_to_sdr=True),
        tpipe.SourceDescriptor(format=fmt, width=sw, height=sh,
                               matrix=tcsp.CSP.BT_2020_NC,
                               primaries=tcsp.Primaries.BT_2020,
                               transfer=tcsp.TRC.PQ, **src),
        tpipe.OutputDescriptor(width=ow, height=oh, bits=10))


def _fits(smem):
    return smem <= trk.SMEM_BUDGET


def _identity_dovi():
    return tdovi.DoviMetadata(
        curves=(tdovi.identity_curve(),) * 3,
        ycc_to_rgb_matrix=np.eye(3), ycc_to_rgb_offset=np.array([0, .5, .5]),
        rgb_to_lms_matrix=np.linalg.inv(tdovi.DOVI_LMS2RGB))


@pytest.mark.parametrize("out", OUTPUTS, ids=[f"{w}x{h}" for w, h in OUTPUTS])
@pytest.mark.parametrize("down", list(tcfg.Downscaling),
                         ids=[d.name for d in tcfg.Downscaling])
@pytest.mark.parametrize("src", SOURCES, ids=[f"{w}x{h}" for w, h in SOURCES])
def test_every_route_choice_takes_every_map(src, down, out):
    """No kernel refuses a map of these plans for its shared memory: each
    route choice is the staged route where the window fits, else the
    long-window route (K1 and K3 shrink their blocks first)."""
    (sw, sh), (ow, oh) = src, out
    plan = _plan(sw, sh, ow, oh, down)
    wx, wy, cwx, cwy, norm = tpipe.fused_maps(plan)
    routes = set()

    # the fused route: K1 x3 (uint16 planes; float32 planes at single-rate
    # deinterlacing), K2 on mid16 or float32 W-pass outputs
    for itemsize in (2, 4):
        for mx in (wx, cwx):
            kw = trk.BandedMatrix(mx, pre_scale=norm)
            rows = trk.k1_rows(itemsize, kw.row_windows(trk.K1_SPAN)[1])
            assert rows is not None and _fits(trk.k1_smem_bytes(
                itemsize, kw.row_windows(trk.K1_SPAN)[1], rows))
    for mid16 in (True, False):
        _, kh_y, _ = tpipe.fused_plane_pass(wx, wy, norm, mid16)
        _, kh_c, _ = tpipe.fused_plane_pass(cwx, cwy, norm, mid16)
        size = 2 if mid16 else 4
        route = trk.k2_route(size, size, kh_y, kh_c)
        assert route in ("staged", "long-window")
        assert (route == "staged") == _fits(
            trk.k2_smem_bytes(size, size, kh_y, kh_c))
        routes.add(("K2", route))

    # the GRAY route: K1 on the uint16 plane, K3 on its float32 output
    kw_g, kh_g = trk.mega_maps(wx, wy, norm)
    route, rows = trk.k3_route(4, kh_g)
    assert (route == "staged") == (trk.k3_tile_rows(4, kh_g) is not None)
    if route == "staged":
        assert _fits(trk.k3_smem_bytes(4, kh_g, rows))
    routes.add(("K3", route))

    # the deinterlacing path: K7 on the raw uint16 planes, K9 on its float32
    # fields (make_deint_fields_fn's maps)
    ux, uy = tchroma.chroma_upsample_matrices(
        sw // 2, sh // 2, 420, plan.settings.chroma_scaling,
        plan.src.chroma_location)
    my_y = trk.BandedMatrix(wy, pre_scale=norm)
    my_c = trk.BandedMatrix(uy @ wy, pre_scale=norm)
    route = tdk.k7_route(2, my_y, my_c)
    assert (route == "staged") == _fits(tdk.k7_smem_bytes(2, my_y, my_c))
    routes.add(("K7", route))
    mx_y, mx_c = trk.BandedMatrix(wx), trk.BandedMatrix(ux @ wx)
    route = tdk.k9_route(4, 4, mx_y, mx_c)
    assert (route == "staged") == _fits(tdk.k9_smem_bytes(4, 4, mx_y, mx_c))
    routes.add(("K9", route))

    # the Dolby Vision path: K8 from the source rows to the output rows
    # (uint16 luma read directly, the chroma's H upsample), K9 on R, G, B
    mid = tdovi.mid_stage(_identity_dovi(), np.eye(3), np.zeros(3))
    kin_c = trk.BandedMatrix(uy)
    k_out = trk.BandedMatrix(wy)
    for compiled in tdk.K8_ROUTE_TILE_ROWS:
        route, rows = tdk.k8_route(2, 4, None, kin_c, k_out, sh,
                                   mid.host_values().size, compiled)
        assert route in ("staged", "long-window") and rows >= 1
        if route == "staged":
            assert _fits(tdk.k8_smem_bytes(2, 4, None, kin_c, k_out, sh,
                                           mid.host_values().size, rows))
        routes.add(("K8", route))
    kx = trk.BandedMatrix(wx)
    routes.add(("K9", tdk.k9_route(4, 4, kx, kx)))
    assert {r for _, r in routes} <= {"staged", "long-window"}


def test_formerly_refused_plans_take_the_long_window_routes():
    """The plans the card refused before the long-window routes (Hamming,
    4K 4:2:0): K2 at 160 x 90, K9 at 320 x 180 and K7 at 480 x 270 take
    the long-window route, and the headline's own shapes the staged one."""
    def k2(ow, oh):
        wx, wy, cwx, cwy, norm = tpipe.fused_maps(
            _plan(3840, 2160, ow, oh, tcfg.Downscaling.HAMMING))
        return trk.k2_route(2, 2, tpipe.fused_plane_pass(wx, wy, norm,
                                                         True)[1],
                            tpipe.fused_plane_pass(cwx, cwy, norm, True)[1])

    assert k2(1920, 1080) == "staged" and k2(160, 90) == "long-window"
    wx = tscale.downscale_matrix(tcfg.Downscaling.HAMMING, 3840, 320)
    m = trk.BandedMatrix(wx)
    assert tdk.k9_route(4, 4, m, m) == "long-window"
    wy = trk.BandedMatrix(tscale.downscale_matrix(tcfg.Downscaling.HAMMING,
                                                  2160, 270))
    wc = trk.BandedMatrix(tscale.downscale_matrix(tcfg.Downscaling.HAMMING,
                                                  1080, 270))
    assert tdk.k7_route(2, wy, wc) == "long-window"
    big = trk.BandedMatrix(tscale.upscale_matrix(tcfg.Upscaling.LANCZOS3,
                                                 2160, 1080))
    assert tdk.k7_route(2, big, big) == "staged"


@pytest.mark.parametrize("flag,fn,args", [
    ("K2_LONG_WINDOW", "k2_route", (2, 2, None, None)),
    ("K7_LONG_WINDOW", "k7_route", None),
    ("K9_LONG_WINDOW", "k9_route", (4, 4, None, None)),
    ("K3_LONG_WINDOW", "k3_route", None),
    ("K8_LONG_WINDOW", "k8_route", None)])
def test_flags_force_the_long_window_route(flag, fn, args, monkeypatch):
    """Each module flag forces its kernel's long-window route on a map the
    staged route takes (chip_smoke.py compares the two)."""
    mat = trk.BandedMatrix(tscale.upscale_matrix(tcfg.Upscaling.LANCZOS3,
                                                 216, 108))
    mod = trk if flag in ("K2_LONG_WINDOW", "K3_LONG_WINDOW") else tdk
    if args is None:
        args = {"k7_route": (2, mat, mat), "k3_route": (4, mat),
                "k8_route": (2, 4, None, None, mat, 216, 33)}[fn]
    elif args[2] is None:
        args = args[:2] + (mat, mat)

    def route():
        r = getattr(mod, fn)(*args)
        return r[0] if isinstance(r, tuple) else r

    assert route() == "staged"
    monkeypatch.setattr(mod, flag, True)
    assert route() == "long-window"


# --- the same ratio through the JAX package and the port, at CPU size ----------

@pytest.fixture(autouse=True)
def fresh_band_cache(monkeypatch):
    monkeypatch.setattr(jrp, "_band_cache", {})


def in_interpret(monkeypatch, fn):
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn())


def _both(sw, sh, ow, oh, down, rect=None, **src):
    def one(cfg, csp, pipe, fmt):
        return pipe.plan_pipeline(
            cfg.Settings(downscaling=getattr(cfg.Downscaling, down),
                         convert_to_sdr=True),
            pipe.SourceDescriptor(format=fmt.P010, width=sw, height=sh,
                                  matrix=csp.CSP.BT_2020_NC,
                                  primaries=csp.Primaries.BT_2020,
                                  transfer=csp.TRC.PQ, **src),
            pipe.OutputDescriptor(width=ow if rect is None else rect[2] + 4,
                                  height=oh if rect is None else rect[3] + 2,
                                  bits=10, video_rect=rect))
    return one(jcfg, jcsp, jpipe, JFmt), one(tcfg, tcsp, tpipe, TFmt)


def _p010(sw, sh, seed, n=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(64, 941, (n, sh, sw), np.uint16) << 6,
            rng.integers(64, 961, (n, sh // 2, sw // 2), np.uint16) << 6,
            rng.integers(64, 961, (n, sh // 2, sw // 2), np.uint16) << 6)


def _code_diff(a, b):
    return np.stack([np.abs(((a >> s) & 1023).astype(int)
                            - ((b >> s) & 1023).astype(int))
                     for s in (0, 10, 20)])


def _code_band(got, ref, xla=None):
    """Within 1 code of the JAX kernel route ``ref`` on >= 99.9% of the
    channels, at most 3; or, where a channel is further, the port no
    further from the JAX XLA route ``xla`` than the JAX kernel route is
    (the reference's own spread between its two routes)."""
    assert got.shape == ref.shape
    d = _code_diff(got, ref)
    assert (d <= 1).mean() >= 0.999, (d.max(), (d > 1).mean())
    if d.max() > 3:
        assert xla is not None
        spread = int(_code_diff(ref, xla).max())
        assert _code_diff(got, xla).max() <= max(3, spread), (d.max(),
                                                              spread)


@pytest.mark.parametrize("out", [(53, 30), (256, 144)], ids=["24x", "5x"])
@pytest.mark.parametrize("down", ["HAMMING", "LANCZOS", "BOX"])
def test_strong_downscale_matches_jax_kernel(down, out, monkeypatch):
    """1280 x 720 P010 PQ to a thumbnail: the port's K1 ×3 + K2 (plain
    versions) against the JAX kernel route in interpret mode.  Near black
    the PQ -> SDR tail's clamps and 1/2.2 power turn float32 rounding into
    several codes: at 5:1 the JAX kernel route sits up to 9-10 codes from
    its own XLA route on ~0.03% of the channels (ROADMAP §3), so a channel
    past 3 codes is held to that spread from the XLA route."""
    jplan, tplan = _both(1280, 720, *out, down)
    planes = _p010(1280, 720, 31)
    jplanes = tuple(jnp.asarray(p) for p in planes)
    ref = in_interpret(monkeypatch, lambda: jpipe.make_frame_fn(
        jplan, pack_surface=True)(jplanes))
    xla = np.asarray(jpipe.make_frame_fn(jplan, pack_surface=True)(jplanes))
    got = tpipe.make_frame_fn(tplan, pack_surface=True)(
        tuple(torch.from_numpy(p) for p in planes)).numpy()
    _code_band(got, ref, xla)


def test_strong_downscale_deint_matches_jax_kernel(monkeypatch):
    """Double-rate deinterlacing of 1280 x 720 HLG at 24:1: the port's K7 +
    K9 (plain versions) against the JAX kernels in interpret mode, both
    fields."""
    def one(cfg, csp, pipe, fmt):
        return pipe.plan_pipeline(
            cfg.Settings(convert_to_sdr=True),
            pipe.SourceDescriptor(format=fmt.P010, width=1280, height=720,
                                  matrix=csp.CSP.BT_2020_NC,
                                  primaries=csp.Primaries.BT_2020,
                                  transfer=csp.TRC.HLG, interlaced=True),
            pipe.OutputDescriptor(width=53, height=30, bits=8))
    jplan, tplan = one(jcfg, jcsp, jpipe, JFmt), one(tcfg, tcsp, tpipe, TFmt)
    win = [_p010(1280, 720, 32 + i, n=2) for i in range(3)]
    ref = in_interpret(monkeypatch, lambda: jnp.stack(
        jpipe.make_deint_fields_fn(jplan, pack_surface=True)(
            *[tuple(jnp.asarray(p) for p in f) for f in win])))
    got = torch.stack(tpipe.make_deint_fields_fn(tplan, pack_surface=True)(
        *[tuple(torch.from_numpy(p) for p in f) for f in win])).numpy()
    assert got.shape == ref.shape == (2, 2, 30, 53)
    d = np.stack([np.abs(((got >> s) & 255).astype(int)
                         - ((ref >> s) & 255).astype(int))
                  for s in (0, 8, 16)])
    assert (d <= 1).mean() >= 0.999 and d.max() <= 3


# --- the offset store's index math ---------------------------------------------

KVEC = 4


def _store_replay(b, h, w, place, planar):
    """route.cuh's store_group over every thread of a launch (4 columns a
    thread, rows 0..h-1, frames 0..b-1) into a surface: the flat indices
    each store writes, and whether it was one 16-byte store (place_vec)
    and at which element index."""
    sh, sw, oy, ox = place
    vec_ok = w % KVEC == 0 and sw % KVEC == 0 and ox % KVEC == 0
    plane = sh * sw
    written, vec_at = [], []
    for bb in range(b):
        for row in range(h):
            for col in range(0, w, KVEC):
                px = (bb * sh + oy + row) * sw + ox + col
                bases = ([px + (bb * 2 + i) * plane for i in range(3)]
                         if planar else [px])
                for i, base in enumerate(bases):
                    if planar:
                        assert base == ((bb * 3 + i) * sh + oy + row) * sw \
                            + ox + col
                    if vec_ok and col + KVEC <= w:
                        vec_at.append(base)
                        written.extend(range(base, base + KVEC))
                    else:
                        written.extend(base + k for k in range(KVEC)
                                       if col + k < w)
    return np.asarray(written), np.asarray(vec_at, dtype=np.int64), vec_ok


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("place,w,h", [
    ((12, 24, 2, 4), 16, 9),       # aligned offset
    ((12, 25, 1, 3), 17, 10),      # unaligned offset, odd widths
    ((10, 20, 0, 0), 20, 10),      # the whole surface
    ((9, 23, 1, 2), 19, 7)])       # the (2, 1, 1918, 1079) rect's kind
def test_offset_store_covers_the_rect_once(place, w, h, planar):
    """The stores write each element of the rect exactly once and nothing
    outside it; the 16-byte stores start on 16-byte boundaries; with the
    bars of fill_bars every element of the surface is written once."""
    b = 2
    sh, sw, oy, ox = place
    written, vec_at, vec_ok = _store_replay(b, h, w, place, planar)
    chans = 3 if planar else 1
    surf = np.zeros((b, chans, sh, sw), int)
    np.add.at(surf.reshape(-1), written, 1)
    assert np.all(surf[..., oy:oy + h, ox:ox + w] == 1)
    inside = np.zeros((sh, sw), bool)
    inside[oy:oy + h, ox:ox + w] = True
    assert not surf[..., ~inside].any()
    assert np.all(vec_at * 4 % 16 == 0)
    assert vec_ok == (ox % 4 == 0 and sw % 4 == 0 and w % 4 == 0)
    bars = torch.full((b, chans, sh, sw), 7, dtype=torch.int32)
    trk.fill_bars(bars, place, h, w, "rgb10a2")
    got = bars.numpy()
    assert np.all(got[..., ~inside] == trk.PACKED_ZERO["rgb10a2"])
    assert np.all(got[..., inside] == 7)


def test_place_output_and_check_place():
    """place_output puts an unplaced output into its surface with the
    packed zero (or float zeros) around it; check_place refuses a rect past
    the surface and gives an unplaced output its own surface."""
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    got = trk.place_output(x, (7, 9, 2, 3), None)
    assert got.shape == (2, 3, 7, 9)
    assert torch.equal(got[..., 2:6, 3:8], x)
    assert got.sum() == x.sum()
    d = torch.arange(20, dtype=torch.int32).reshape(4, 5)
    got = trk.place_output(d, (6, 6, 1, 1), "rgba8")
    assert torch.equal(got[1:5, 1:6], d)
    assert int((got == trk.PACKED_ZERO["rgba8"]).sum()) == 36 - 20
    assert trk.check_place(None, 4, 5) == (4, 5, 0, 0)
    with pytest.raises(ValueError, match="does not fit"):
        trk.check_place((4, 5, 1, 0), 4, 5)
    with pytest.raises(ValueError, match="does not fit"):
        trk.check_place((4, 5, 0, -1), 4, 5)
    assert trk.place_output(d, None, "rgba8") is d


def test_epilogue_carries_the_fix_gamma():
    """The SDR BT.2020 fix rides the launch: the epilogue's 27th host float
    (of 59: the trims and the guided curve follow it) is the plan's source
    gamma, for each power-law transfer."""
    for trc, gamma in ((tcsp.TRC.GAMMA18, 1.8), (tcsp.TRC.GAMMA28, 2.8),
                       (tcsp.TRC.BT_1886, 2.2), (tcsp.TRC.LINEAR, 1.0)):
        plan = tpipe.plan_pipeline(
            tcfg.Settings(),
            tpipe.SourceDescriptor(format=TFmt.P010, width=64, height=32,
                                   transfer=trc,
                                   primaries=tcsp.Primaries.BT_2020),
            tpipe.OutputDescriptor(width=32, height=16, bits=10))
        epi = tpipe._make_tail_epilogue(plan)
        mats = epi.host_mats()
        assert epi.correction == trk.CORR_FIX_BT2020
        assert mats.shape == (59,) and mats[26] == np.float32(gamma)
        epi2 = dataclasses.replace(epi, sdr_gamma=2.4)
        assert epi2.host_mats()[26] == np.float32(2.4)


# --- which tail route an epilogue takes (the CPU half of the card's test) -----

CSRC = tpipe.__file__.rsplit("/", 1)[0] + "/csrc/"
_CTYPES = {"uint8_t": 0, "uint16_t": 1, "int16_t": 2, "float": 3}


def _enum_values() -> dict:
    """The route constants of tail.cuh, epilogue.cuh and route.cuh (kCorr*,
    kTm*, kQuant*, kPack*, kRuntime and kRt), from the sources."""
    import re
    out = {}
    for name in ("tail.cuh", "epilogue.cuh", "route.cuh"):
        text = open(CSRC + name).read()
        for body in re.findall(r"enum\s*\{([^}]*)\}", text):
            for k, v in re.findall(r"(k\w+)\s*=\s*(-?\d+)", body):
                out[k] = int(v)
        for k, v in re.findall(r"constexpr int (k\w+) = (-?\d+|k\w+);",
                               text):
            out[k] = out[v] if v in out else int(v)
    return out


def _compiled_routes(source: str) -> dict:
    """{route name: (y dtype, c dtype, matrix, correction, tone map, quant
    mode, pack)} of the compiled Specs of a tail kernel's source, its
    routes' template arguments read from route.cuh."""
    import re
    consts = dict(_enum_values(), true=1, false=0)
    # the first five arguments: the flags; a sixth, the extended tail, is
    # no flag of a compiled route
    routes = {m[0]: [int(a) if a.isdigit() else consts[a]
                     for a in (x.strip() for x in m[1].split(","))][:5]
              for m in re.findall(r"using (\w+) = Route<([^>]*)>;",
                                  open(CSRC + "route.cuh").read())}
    return {name: (_CTYPES[ty], _CTYPES[tc], *routes[r])
            for r, ty, tc, name in re.findall(
                r'Spec<(\w+), (\w+), (\w+)>\{"([^"]+)"\}',
                open(CSRC + source).read())}


def _route_of(source: str, flags: tuple) -> str:
    """route.cuh's with_spec over ``flags`` (kernels/resize.route_flags):
    the first compiled route whose flags they are, with no trims; else the
    runtime route."""
    y, c, mat, corr, tm, trims, dither_bits, pack = flags
    quant = 1 if dither_bits > 0 else 2 if dither_bits < 0 else 0
    for name, spec in _compiled_routes(source).items():
        if not trims and spec == (y, c, mat, corr, tm, quant, pack):
            return name
    return "runtime"


def _hdr_epilogue(cell: str):
    import torch_hdr_cells as cells
    plan = tpipe.plan_pipeline(*cells.cell_args(cells.TORCH, cell))
    return tpipe._make_tail_epilogue(plan, with_cmat=plan.dovi is None)


def _c7_epilogue(**src):
    import torch_hdr_cells as cells
    plan = tpipe.plan_pipeline(*cells.cell_args(cells.TORCH, "c7p",
                                                hdr10plus=None, **src))
    return tpipe._make_tail_epilogue(plan)


ROUTE_CASES = {
    # the compiled routes the paths take stay theirs ...
    "k2_c7": ("rows3_tail.cu", torch.uint16, torch.int16, _c7_epilogue,
              "c7 uint16/int16"),
    "k2_headline": ("rows3_tail.cu", torch.int16, torch.int16,
                    lambda: tpipe._make_tail_epilogue(_plan(
                        128, 64, 64, 32, tcfg.Downscaling.HAMMING)),
                    "headline int16"),
    "k9_c8": ("cols3_tail.cu", torch.float32, torch.float32,
              lambda: tpipe._make_tail_epilogue(_plan(
                  128, 64, 64, 32, tcfg.Downscaling.HAMMING, dovi=_dovi()),
                  with_cmat=False), "c8 float32"),
    # ... and the guided curve and the trims take the runtime route
    "k2_c7p": ("rows3_tail.cu", torch.uint16, torch.int16,
               lambda: _hdr_epilogue("c7p"), "runtime"),
    "k2_c7_trims": ("rows3_tail.cu", torch.uint16, torch.int16,
                    lambda: _c7_epilogue(dovi_trims=_trims()), "runtime"),
    "k9_c8x": ("cols3_tail.cu", torch.float32, torch.float32,
               lambda: _hdr_epilogue("c8x"), "runtime"),
    "k9_c8hdr": ("cols3_tail.cu", torch.float32, torch.float32,
                 lambda: _hdr_epilogue("c8hdr"), "runtime"),
    # K4 stores planar float (no pack): phase 19's three tails on the raw
    # P010 planes take their compiled routes, c7p the runtime route
    "k4_headline": ("mega3_tail.cu", torch.uint16, torch.uint16,
                    lambda: tpipe._make_tail_epilogue(_plan(
                        128, 64, 64, 32, tcfg.Downscaling.HAMMING)),
                    "headline planar uint16", None),
    "k4_c7": ("mega3_tail.cu", torch.uint16, torch.uint16, _c7_epilogue,
              "c7 planar uint16", None),
    "k4_matrix": ("mega3_tail.cu", torch.uint16, torch.uint16,
                  lambda: tpipe.cmat_epilogue(np.asarray(
                      [[1.0, 0.0, 1.4, 0.0], [1.0, -0.2, -0.7, 0.0],
                       [1.0, 1.8, 0.0, 0.0]], np.float32)),
                  "matrix planar uint16", None),
    "k4_c7p": ("mega3_tail.cu", torch.uint16, torch.uint16,
               lambda: _hdr_epilogue("c7p"), "runtime", None),
}


def _dovi():
    import torch_hdr_cells as cells
    return cells.dovi_meta(tdovi)


def _trims():
    from videorenderer_tpu_torch.ops import tonemap as ttm
    return ttm.DoviTrims(trim_slope=1.1, trim_power=0.9, l2_enabled=True)


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_tail_route_choice(case):
    """K2's, K9's and K4's route for the paths' epilogues: c7, the headline
    and c8 keep their compiled routes (K4's planar ones on uint16 planes:
    the headline, c7 and the colour matrix alone); c7p (selection 7), c7
    with L2 trims, c8x (PQ-domain trims) and c8hdr (trims in nits, ST
    2094-10 general)
    match no compiled route (route.cuh's ``matches`` refuses trims and no
    route has selection 7), so they take the runtime route.  The card's
    tests ask the library the same question (rows3_tail_route,
    mega3_tail_route)."""
    source, ytype, ctype, make, want, *pack = ROUTE_CASES[case]
    epi = make()
    flags = trk.route_flags(ytype, ctype, epi,
                            pack[0] if pack else "rgb10a2")
    assert _route_of(source, flags) == want
    assert flags[5] == int(epi.trims is not None)
    if want == "runtime":
        assert epi.trims is not None or epi.tonemap == 7
    else:
        assert epi.trims is None and epi.tonemap != 7


# --- K4's routes: every map, the thumbnails, the JAX kernel at 24:1 -----------

@pytest.mark.parametrize("out", OUTPUTS, ids=[f"{w}x{h}" for w, h in OUTPUTS])
@pytest.mark.parametrize("down", list(tcfg.Downscaling),
                         ids=[d.name for d in tcfg.Downscaling])
@pytest.mark.parametrize("src", SOURCES, ids=[f"{w}x{h}" for w, h in SOURCES])
def test_k4_route_takes_every_map(src, down, out):
    """K4 refuses none of these plans' fused maps (uint16 and float32
    planes): staged where its layout (the whole windows) fits at
    K4_MIN_TILE_ROWS, at the most tile rows that let three blocks share an
    SM where any do, else the long-window route, whose ring fits."""
    (sw, sh), (ow, oh) = src, out
    wx, wy, cwx, cwy, norm = tpipe.fused_maps(_plan(sw, sh, ow, oh, down))
    maps = (*trk.mega_maps(wx, wy, norm), *trk.mega_maps(cwx, cwy, norm))
    maps = (maps[0], maps[2], maps[1], maps[3])    # mx_y, mx_c, my_y, my_c
    for size in (2, 4):
        route, rows, chunk = trk.k4_route(size, size, *maps)
        fits = _fits(trk.k4_smem_bytes(size, size, *maps,
                                       trk.K4_MIN_TILE_ROWS, 1))
        assert (route == "staged") == fits and chunk is not None
        assert _fits(trk.k4_smem_bytes(size, size, *maps, rows, chunk,
                                       route == "long-window"))
        if route == "long-window":
            assert rows == trk.K4_LONG_TILE_ROWS
            continue
        assert trk.K4_MIN_TILE_ROWS <= rows <= trk.K4_TILE_ROWS
        three = trk.SMEM_BUDGET // trk.K4_BLOCKS_PER_SM - 1024

        def fits3(r):
            return trk.k4_smem_bytes(size, size, *maps, r) <= three

        if trk.k4_smem_bytes(size, size, *maps, rows, chunk) <= three:
            # three blocks an SM, at the most tile rows that allow it
            assert chunk == 0 and fits3(rows)
            assert not any(fits3(r) for r in range(
                rows + 8, trk.K4_TILE_ROWS + 1, 8))
        else:
            assert not any(fits3(r) for r in range(
                trk.K4_MIN_TILE_ROWS, trk.K4_TILE_ROWS + 1, 8))


@pytest.mark.parametrize("down,ow,oh,want,refused", [
    ("LANCZOS", 160, 90, "long-window", True),
    ("HAMMING", 120, 68, "long-window", True),
    ("HAMMING", 160, 90, "long-window", False),
    ("LANCZOS", 1920, 1080, "staged", False)])
def test_k4_route_of_the_headline_source(down, ow, oh, want, refused):
    """The headline source (3840 x 2160 P010) to thumbnails takes the
    long-window route, in two blocks an SM: 160 x 90 Lanczos and 120 x 68
    Hamming, which the kernel before the routes refused (its float windows
    of 32-row tiles past 200 KB, 1600 rows: 888 luma rows at 2160 -> 90
    Lanczos), and chip_smoke.py's 160 x 90 Hamming thumbnail, just under
    that limit; the headline's own 2:1 the staged route with each plane's
    whole window at once, at 16 tile rows, three blocks an SM."""
    wx, wy, cwx, cwy, norm = tpipe.fused_maps(
        _plan(3840, 2160, ow, oh, getattr(tcfg.Downscaling, down)))
    (ky, hy), (kc, hc) = trk.mega_maps(wx, wy, norm), trk.mega_maps(
        cwx, cwy, norm)
    route, rows, chunk = trk.k4_route(2, 2, ky, kc, hy, hc)
    assert route == want
    smem = trk.k4_smem_bytes(2, 2, ky, kc, hy, hc, rows, chunk,
                             route == "long-window")
    assert smem <= trk.SMEM_BUDGET // 2 - 1024
    if want == "staged":
        assert (rows, chunk) == (16, 0)
        assert smem <= trk.SMEM_BUDGET // trk.K4_BLOCKS_PER_SM - 1024
    assert (hy.row_windows(32)[1] + 2 * hc.row_windows(32)[1]
            > 1600) == refused


def test_k4_long_window_flag_forces_the_route(monkeypatch):
    """K4_LONG_WINDOW forces the long-window route on a map the staged
    route takes (chip_smoke.py compares the two)."""
    mat = trk.BandedMatrix(tscale.upscale_matrix(tcfg.Upscaling.LANCZOS3,
                                                 216, 108))
    assert trk.k4_route(2, 2, mat, mat, mat, mat)[0] == "staged"
    monkeypatch.setattr(trk, "K4_LONG_WINDOW", True)
    assert trk.k4_route(2, 2, mat, mat, mat, mat)[:2] == (
        "long-window", trk.K4_LONG_TILE_ROWS)


@pytest.mark.parametrize("out", [(53, 30), (256, 144)], ids=["24x", "5x"])
@pytest.mark.parametrize("down", ["HAMMING", "LANCZOS"])
def test_k4_strong_downscale_plain_matches_jax_kernel(down, out):
    """1280 x 720 P010 PQ to a thumbnail through K4 (the fused maps, the
    headline's PQ -> SDR tail, 10-bit dither): the port's plain version
    against the JAX mega3_tail in interpret mode, 10-bit codes within 1 on
    >= 99.9% of the channels, at most 3."""
    jplan, tplan = _both(1280, 720, *out, down)
    wx, wy, cwx, cwy, norm = tpipe.fused_maps(tplan)
    planes = _p010(1280, 720, 34)
    (ky, hy), (kc, hc) = trk.mega_maps(wx, wy, norm), trk.mega_maps(
        cwx, cwy, norm)
    got = trk.mega3_tail(*(torch.from_numpy(p) for p in planes), ky, kc, hy,
                         hc, out[1], tpipe._make_tail_epilogue(tplan),
                         norm).numpy()
    f32 = [np.asarray(m, np.float32) for m in (wx, cwx, wy, cwy)]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrp.mega3_tail(
            *(jnp.asarray(p) for p in planes), *f32, out[1],
            jpipe._make_tail_epilogue(jplan), norm))
    assert got.shape == ref.shape == (1, 3, out[1], out[0])
    d = np.abs(np.round(got * 1023) - np.round(ref * 1023))
    assert (d <= 1).mean() >= 0.999 and d.max() <= 3, (d.max(),
                                                       (d > 1).mean())
