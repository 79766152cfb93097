"""videorenderer_tpu_torch.display, .proppage and .utils.trace against the
JAX package: the HDR-toggle state machine and the property page's model
driven through the same operation sequences in both packages, with equal
states (Settings compared as dicts) after every step; the device trace's
export on the CPU."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import videorenderer_tpu.config as jconfig
import videorenderer_tpu.display as jdisplay
import videorenderer_tpu.proppage as jpp

import videorenderer_tpu_torch.config as tconfig
import videorenderer_tpu_torch.display as tdisplay
import videorenderer_tpu_torch.proppage as tpp
from videorenderer_tpu_torch.utils import trace


@pytest.mark.parametrize("seed", range(4))
def test_hdr_toggle_state_machine(seed):
    """Random sequences of (policy, source HDR, fullscreen) and restores
    from random starting states: every return value and display state
    equal in both packages."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        start = dict(hdr_enabled=bool(rng.integers(2)),
                     hdr_supported=bool(rng.integers(4)))
        jc = jdisplay.HdrToggleController(jdisplay.DisplayConfig(**start))
        tc = tdisplay.HdrToggleController(tdisplay.DisplayConfig(**start))
        for _ in range(8):
            if rng.integers(6) == 0:
                jc.restore()
                tc.restore()
            else:
                pol = tconfig.HdrToggleDisplay(
                    int(rng.integers(len(tconfig.HdrToggleDisplay))))
                hdr, full = bool(rng.integers(2)), bool(rng.integers(2))
                assert tc.evaluate(pol, hdr, fullscreen=full) == jc.evaluate(
                    jconfig.HdrToggleDisplay[pol.name], hdr, fullscreen=full)
            assert dataclasses.asdict(tc.display) == \
                dataclasses.asdict(jc.display)
            assert (tc.display.hdr_on(), tc.display.hdr_support()) == (
                jc.display.hdr_on(), jc.display.hdr_support())
    d = tdisplay.DisplayConfig(refresh_num=60000, refresh_den=1001)
    assert abs(d.refresh_hz - 59.94) < 0.01


def test_property_page_fields():
    """The same rows, groups, kinds and ranges; every Settings field has a
    row."""
    assert len(tpp.FIELDS) == len(jpp.FIELDS)
    for t, j in zip(tpp.FIELDS, jpp.FIELDS):
        assert (t.name, t.label, t.group, t.kind, t.int_range) == (
            j.name, j.label, j.group, j.kind, j.int_range)
        assert (t.enum_type is None) == (j.enum_type is None)
        if t.enum_type is not None:
            assert [m.name for m in t.enum_type] == \
                [m.name for m in j.enum_type]
    page = {f.name.split(".")[0] for f in tpp.FIELDS}
    assert {f.name for f in dataclasses.fields(tconfig.Settings)} <= page


@pytest.mark.parametrize("seed", range(3))
def test_property_page_model_ops(seed):
    """Random edits (toggle, step, set_value, reset, cancel, apply) from
    random starting settings: enabled(), display(), dirty and the value
    equal in both packages after every operation."""
    rng = np.random.default_rng(seed)
    start = dict(use_accel_backend=bool(rng.integers(2)),
                 hdr_local_tone_mapping=bool(rng.integers(2)),
                 convert_to_sdr=bool(rng.integers(2)))
    japplied, tapplied = [], []
    jm = jpp.PropertyPageModel(jconfig.Settings(**start),
                               on_apply=japplied.append)
    tm = tpp.PropertyPageModel(tconfig.Settings(**start),
                               on_apply=tapplied.append)
    for _ in range(120):
        i = int(rng.integers(len(tpp.FIELDS)))
        ts, js = tpp.FIELDS[i], jpp.FIELDS[i]
        op = int(rng.integers(10))
        if op < 4:
            tm.toggle(ts)
            jm.toggle(js)
        elif op < 8:
            d = int(rng.choice([-1, 1]))
            tm.step(ts, d)
            jm.step(js, d)
        elif op == 8:
            v = (int(rng.integers(0, 3)) if ts.kind == "enum" else
                 int(rng.integers(-50, 20000)) if ts.kind == "int" else
                 bool(rng.integers(2)))
            if ts.kind == "enum":
                v = list(ts.enum_type)[v % len(ts.enum_type)].value
            tm.set_value(ts.name, v)
            jm.set_value(js.name, v)
        else:
            k = int(rng.integers(4))
            for m in (tm, jm):
                (m.reset, m.cancel, m.apply, lambda: None)[k]()
        assert tm.value.to_dict() == jm.value.to_dict()
        assert tm.dirty == jm.dirty
        assert [tm.enabled(f) for f in tpp.FIELDS] == \
            [jm.enabled(f) for f in jpp.FIELDS]
        assert [tm.display(f) for f in tpp.FIELDS] == \
            [jm.display(f) for f in jpp.FIELDS]
    assert [s.to_dict() for s in tapplied] == [s.to_dict() for s in japplied]


def test_info_page_model():
    calls = []

    def provider():
        calls.append(1)
        return "\n".join(f"line {i}" for i in range(10))

    for mod in (tpp, jpp):
        calls.clear()
        info = mod.InfoPageModel(provider)
        assert not calls                       # lazy
        assert info.visible(3) == ["line 0", "line 1", "line 2"]
        info.scroll_by(8)
        assert info.visible(3) == ["line 8", "line 9"]
        info.scroll_by(50)
        assert info.scroll == 9
        info.refresh()
        assert len(calls) == 2

    def broken():
        raise OSError("no device")

    assert tpp.InfoPageModel(broken).lines == \
        ["(info unavailable: no device)"]


def test_device_trace_and_annotate(tmp_path):
    """A Chrome trace of the region with the program's span in it, on its
    own track and around the CPU operation it enclosed (CPU activity here;
    CUDA activity is added on a card), and the logger both packages
    share."""
    with trace.device_trace(str(tmp_path)) as prof:
        with trace.span("vrt.region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    region = [e for e in events if e.get("name") == "vrt.region"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert len(region) == 1 and mm
    r = region[0]
    assert r["ts"] <= mm[0]["ts"] and \
        mm[0]["ts"] + mm[0]["dur"] <= r["ts"] + r["dur"]
    # the span is the program's, not a profiler range
    assert not any(e.key.startswith("vrt.") for e in prof.key_averages())
    assert [s.name for s in trace.spans()] == ["vrt.region"]
    assert trace.log.name == "videorenderer_tpu"
