"""``VideoProcessor(settings, src, dst, device=..., pack_surface=...)
.process(planes)``: the port's per-configuration processor, one call a
batch (on a card the fused chain, K1 x3 + K2 for the HDR10 -> SDR
headline)."""

from __future__ import annotations

from videorenderer_tpu_torch import VideoProcessor

from . import common


def build(config: dict, traffic: dict, device) -> common.Entry:
    vp = VideoProcessor(common.settings(config), common.source(config),
                        common.output(config), device=device,
                        pack_surface=bool(config["pack_surface"]))
    return common.Entry(lambda planes, index, span: vp.process(planes))
