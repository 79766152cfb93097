"""The plain reference against the port's own float64 oracle
(``videorenderer_tpu_torch/oracle.py``) at a small size, and the control
(the reference in float32 with TF32 products) against the cells' limits.
The tests import the port; the reference does not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vrbench import check, gen, spec
from vrbench.control import control_outputs
from vrbench.entries import common
from vrbench.reference import (colour, dovi_to_sdr, hdr10_to_sdr, oracle,
                               scale)
from vrbench.tests import small

from videorenderer_tpu_torch import oracle as port_oracle
from videorenderer_tpu_torch.config import Upscaling
from videorenderer_tpu_torch.csputils import (CSP, CSPParams, Colorspace,
                                              Levels, bt2020_to_bt709_matrix,
                                              get_csp_matrix)
from videorenderer_tpu_torch.ops import dovi
from videorenderer_tpu_torch.ops.dither import bayer_matrix
from videorenderer_tpu_torch.ops.scale import upscale_matrix

CELLS = small.cells()


def planes(seed: int):
    cell = small.shrink(spec.load_cell(CELLS[0]))
    return [p[0] for p in gen.make_pool(cell.traffic, cell.config, seed,
                                        "cpu")[0]]


@pytest.mark.parametrize("name", ["LANCZOS3", "CATMULL_ROM"])
@pytest.mark.parametrize("n_in, n_out", [(3840, 1920), (2160, 1080),
                                         (72, 36), (37, 20)])
def test_axis_matrices_equal_the_ports(name, n_in, n_out):
    assert np.array_equal(scale.axis_matrix(name, n_in, n_out),
                          upscale_matrix(Upscaling[name], n_in, n_out))


def test_colour_constants_equal_the_ports():
    cm = get_csp_matrix(CSPParams(color=Colorspace(CSP.BT_2020_NC, Levels.TV),
                                  input_bits=16, texture_bits=16))
    m, c = colour.yuv_to_rgb("BT_2020_NC", "TV")
    assert np.allclose(m, cm.m, rtol=0, atol=1e-15)
    assert np.allclose(c, cm.c, rtol=0, atol=1e-15)
    assert np.allclose(colour.gamut("BT_2020", "BT_709"),
                       bt2020_to_bt709_matrix(), rtol=0, atol=1e-14)
    assert np.array_equal(colour.bayer(32), bayer_matrix(32))
    assert np.array_equal(colour.DOVI_LMS2RGB, dovi.DOVI_LMS2RGB)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_hdr10_equals_the_ports_oracle(seed):
    cfg = small.shrink(spec.load_cell(CELLS[0])).config
    y, u, v = planes(seed)
    mine = hdr10_to_sdr.frame(cfg, (y, u, v), None)
    theirs = port_oracle.oracle(y, u, v, small.OW, small.OH)
    assert torch.equal(mine, torch.round(theirs * 1023).to(torch.int64))


def f32_curves(rpu: dict) -> dict:
    def r(x):
        return [r(v) for v in x] if isinstance(x, list) else \
            float(np.float32(x))
    out = dict(rpu)
    out["curves"] = [
        {"pivots": r(c["pivots"]),
         "pieces": [{"poly": r(p["poly"])} if "poly" in p else
                    {"mmr": {"const": r(p["mmr"]["const"]),
                             "coef": r(p["mmr"]["coef"])}}
                    for p in c["pieces"]]} for c in rpu["curves"]]
    return out


@pytest.mark.parametrize("cell", CELLS[1:])
@pytest.mark.parametrize("scene", [0, 5])
def test_dovi_equals_the_ports_oracle(cell, scene):
    c = small.shrink(spec.load_cell(cell))
    y, u, v = planes(scene + 10)
    # the curves as float32, the precision pack_curves gives the port's
    # oracle
    rpu = f32_curves(gen.scene(c.traffic, scene))
    mine = dovi_to_sdr.frame(c.config, (y, u, v), rpu)
    meta = common.dovi_metadata(rpu)
    theirs = port_oracle.oracle_dovi(
        y, u, v, small.OW, small.OH,
        curves={k: np.asarray(a, np.float64)
                for k, a in dovi.pack_curves(meta).items()},
        structure=dovi.curve_structure(meta),
        ycc_to_rgb=meta.ycc_to_rgb_matrix, ycc_offset=meta.ycc_to_rgb_offset,
        lms=dovi.lms_pipeline_matrix(meta))
    assert torch.equal(mine, torch.round(theirs * 1023).to(torch.int64))


def test_scene_scaling_changes_every_coefficient():
    t = spec.load_cell(CELLS[1]).traffic
    s0, s3 = gen.scene(t, 0), gen.scene(t, 3)
    assert s0 == t["scenes"]["data"]
    a = s0["curves"][2]["pieces"][0]["mmr"]
    b = s3["curves"][2]["pieces"][0]["mmr"]
    assert b["const"] == pytest.approx(0.97 * a["const"])
    assert np.allclose(b["coef"], 0.97 * np.asarray(a["coef"]))
    assert s3["curves"][0]["pivots"] == [pytest.approx(0.45 * 0.97)]
    assert s3["rgb_to_lms"] == s0["rgb_to_lms"]


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -12, 3.0e-5], dtype=torch.float32)
    r = oracle.round_tf32(x)
    # ten mantissa bits kept; ties to even
    assert r[:5].tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0]
    assert abs(r[5].item() - 3.0e-5) <= 3.0e-5 * 2 ** -11


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limit(monkeypatch, cell):
    """The control (float32, TF32 products) in the program's place reads
    over the cell's limit at a small size too."""
    small.patch_small(monkeypatch)
    c = spec.load_cell(cell)
    for seed in (3, 4, 5):
        pool = gen.make_pool(c.traffic, c.config, seed, "cpu")
        outs = control_outputs(c, pool, gen.checked_calls(c.traffic, seed))
        verdict = check.compare(outs, pool, c.config, c.traffic, c.limits)
        assert not verdict["correct"], verdict
