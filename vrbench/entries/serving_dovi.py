"""``make_serving_fn(plan, pack_surface=...)`` of a Dolby Vision plan: one
call a batch with the scene's curves as runtime values, ``fn(planes,
{"dovi_curves": fn.pack_curves(meta)})``.  The plan is made from the mix's
first scene; the port packs each scene's curves (``fn.pack_curves``) at the
first call of the scene, inside the window, as a server does when a new
RPU arrives."""

from __future__ import annotations

from videorenderer_tpu_torch import make_serving_fn, plan_pipeline

from .. import gen
from . import common


def build(config: dict, traffic: dict, device) -> common.Entry:
    metas = [common.dovi_metadata(gen.scene(traffic, i))
             for i in range(int(traffic["scenes"]["count"]))]
    fn = make_serving_fn(
        plan_pipeline(common.settings(config),
                      common.source(config, dovi=metas[0]),
                      common.output(config)),
        pack_surface=bool(config["pack_surface"]))
    state = {"scene": None, "rt": None}

    def call(planes, index, span):
        scene = gen.scene_of(traffic, index)
        if scene != state["scene"]:
            with span("vrbench.pack_curves"):
                state["rt"] = {"dovi_curves": fn.pack_curves(metas[scene])}
            state["scene"] = scene
        return fn(planes, state["rt"])

    return common.Entry(call)
