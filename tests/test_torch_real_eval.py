"""videorenderer_tpu_torch.models.real_eval: the real-photo content equal
to the JAX package's, and the port's shipped models held to the margins of
tests/test_real_eval.py on the CPU (SuperRes: >= -0.25 dB against the
classical upscaler on every photo, > 0.5 dB on at least 3 of them, > 1 dB
on one; VideoHDR: > base + 1 dB and > 30 dB)."""

import numpy as np
import pytest
import torch

from videorenderer_tpu.models import real_eval as jre

from videorenderer_tpu_torch.models import real_eval as tre
from videorenderer_tpu_torch.models.hdr_train import evaluate_pq_psnr
from videorenderer_tpu_torch.models.sr_train import evaluate_psnr


def test_real_content_equal_to_jax():
    jp, tp = jre.real_photos(), tre.real_photos()
    assert [n for n, _ in tp] == [n for n, _ in jp] and len(tp) >= 3
    for (_, a), (_, b) in zip(jp, tp):
        assert np.array_equal(a, b)
    for kw in (dict(n=4, size=96, seed=3), dict(n=3, size=300, seed=1)):
        assert np.array_equal(tre.real_frames(**kw), jre.real_frames(**kw))
    assert np.array_equal(tre.real_hdr_frames(4, 96, seed=3),
                          jre.real_hdr_frames(4, 96, seed=3))


def test_real_frames_deterministic_and_bounded():
    a = tre.real_frames(4, 96, seed=3)
    assert a.shape == (4, 96, 96, 3) and a.dtype == np.float32
    assert np.array_equal(a, tre.real_frames(4, 96, seed=3))
    assert a.min() >= 0.0 and a.max() <= 1.0
    assert np.abs(a[0] - a[-1]).mean() > 0.01
    hdr = tre.real_hdr_frames(4, 96, seed=3)
    assert hdr.max() <= 1000.0 and (hdr > 203.0).mean() > 0.005


def test_shipped_superres_wins_on_real_content():
    model = tre.load_shipped_superres("cpu")
    margins = {}
    for name, img in tre.real_photos():
        hr = tre.real_frames(6, 96, seed=7, photo=img)
        net_db, classical_db = evaluate_psnr(model, hr)
        margins[name] = net_db - classical_db
    assert min(margins.values()) >= -0.25, margins
    assert sum(1 for v in margins.values() if v > 0.5) >= 3, margins
    assert max(margins.values()) > 1.0, margins


def test_shipped_videohdr_beats_base_on_real_content():
    model = tre.load_shipped_videohdr("cpu")
    hdr = tre.real_hdr_frames(6, 96, seed=7, cfg=model.cfg)
    net_db, base_db = evaluate_pq_psnr(model, hdr)
    assert net_db > base_db + 1.0, (net_db, base_db)
    assert net_db > 30.0


def test_evaluate_real_against_jax():
    """The report of both packages on the same small clip: the classical
    and base numbers equal to float32 rounding, the nets' within 0.05 dB."""
    t = tre.evaluate_real(n=2, size=64, device="cpu")
    j = jre.evaluate_real(n=2, size=64)
    assert t.keys() == j.keys()
    assert t["superres_margins_db"].keys() == j["superres_margins_db"].keys()
    for k in ("superres_classical_db", "videohdr_base_db"):
        assert abs(t[k] - j[k]) < 1e-3, (k, t[k], j[k])
    for k in ("superres_net_db", "videohdr_net_db"):
        assert abs(t[k] - j[k]) < 0.05, (k, t[k], j[k])
    for k, v in t["superres_margins_db"].items():
        assert abs(v - j["superres_margins_db"][k]) < 0.05, k


def test_loaders_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default loads there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tre.load_shipped_superres()
    with pytest.raises(RuntimeError, match="CUDA"):
        tre.load_shipped_videohdr()
    model = tre.load_shipped_videohdr("cpu")
    assert model.c1.weight.device.type == "cpu" and model.cfg.channels == 64
