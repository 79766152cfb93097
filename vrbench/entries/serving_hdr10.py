"""``make_serving_fn(plan, pack_surface=...)`` of an HDR10 plan with a
local tone map: one call a batch with the scene's HDR10 values as runtime
values, ``fn(planes, {"hdr": {...}})``.  The plan is made from the
configuration's static ``hdr10``; the adapter makes each scene's values at
the first call of the scene, inside the window, as a server does when a
sample carries new HDR10 side data (DX11VideoProcessor.cpp:2232-2267), and
passes them on every call of the scene."""

from __future__ import annotations

from videorenderer_tpu_torch import ToneMapType, make_serving_fn, plan_pipeline

from .. import gen
from . import common


def settings(config: dict):
    """The port's settings, the tone map's type named by its member
    (``common``'s enums leave it out)."""
    s = dict(config["settings"])
    s["hdr_local_tone_mapping_type"] = \
        ToneMapType[s["hdr_local_tone_mapping_type"]]
    return common.settings(dict(config, settings=s))


def build(config: dict, traffic: dict, device) -> common.Entry:
    fn = make_serving_fn(
        plan_pipeline(settings(config), common.source(config),
                      common.output(config)),
        pack_surface=bool(config["pack_surface"]))
    state = {"scene": None, "rt": None}

    def call(planes, index, span):
        scene = gen.scene_of(traffic, index)
        if scene != state["scene"]:
            with span("vrbench.scene_hdr"):
                state["rt"] = {"hdr": gen.scene(traffic, scene)}
            state["scene"] = scene
        return fn(planes, state["rt"])

    return common.Entry(call)
