"""What an entry adapter gives the harness, and the port's descriptors
built from a configuration file's names."""

from __future__ import annotations

import contextlib
import dataclasses
import enum

import numpy as np

from videorenderer_tpu_torch import (CSP, ChromaScaling, ColorFormat,
                                     Downscaling, HDR10Metadata, Levels,
                                     OutputDescriptor, Primaries, Settings,
                                     SourceDescriptor, TRC, Upscaling)
from videorenderer_tpu_torch.ops import dovi as dovi_ops

# the enum of each descriptor field a configuration names by its member
_ENUMS = {"upscaling": Upscaling, "downscaling": Downscaling,
          "chroma_scaling": ChromaScaling, "format": ColorFormat,
          "matrix": CSP, "levels": Levels, "primaries": Primaries,
          "transfer": TRC}


class Entry:
    """One configuration's system under test on one device.

    ``call(planes, index)`` submits call ``index`` of the window (or of the
    warm-up) on ``planes`` and returns its output as the program returns
    it, without waiting for the device.  ``span(name)`` marks host work of
    the adapter's own (a no-op unless the harness traces)."""

    def __init__(self, call):
        self._call = call
        self.span = lambda name: contextlib.nullcontext()

    def call(self, planes, index: int):
        return self._call(planes, index, self.span)


def _fields(cls, values: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - names
    if unknown:
        raise KeyError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    return {k: (_ENUMS[k][v] if k in _ENUMS and not isinstance(v, enum.Enum)
                else v) for k, v in values.items()}


def settings(config: dict) -> Settings:
    return Settings(**_fields(Settings, config["settings"]))


def source(config: dict, dovi=None) -> SourceDescriptor:
    values = dict(config["video_source"])
    if "hdr10" in values:
        values["hdr10"] = HDR10Metadata(**values["hdr10"])
    return SourceDescriptor(**_fields(SourceDescriptor, values), dovi=dovi)


def output(config: dict) -> OutputDescriptor:
    return OutputDescriptor(**_fields(OutputDescriptor, config["output"]))


def dovi_metadata(rpu: dict) -> dovi_ops.DoviMetadata:
    """The port's metadata of a scene's RPU (the traffic's plain form)."""
    curves = []
    for c in rpu["curves"]:
        pieces = c["pieces"]
        n = len(pieces)
        poly = np.zeros((n, 3))
        method, order, const = [], [], []
        coef = np.zeros((n, 3, 7))
        for k, p in enumerate(pieces):
            if "poly" in p:
                poly[k] = p["poly"]
                rows, c0 = [], 0.0
            else:
                rows, c0 = p["mmr"]["coef"], p["mmr"]["const"]
                coef[k, :len(rows)] = rows
            method.append(0 if "poly" in p else 1)
            order.append(len(rows))
            const.append(c0)
        mmr = 1 in method
        curves.append(dovi_ops.ReshapeCurve(
            pivots=tuple(c["pivots"]), method=tuple(method), poly=poly,
            mmr_order=tuple(order) if mmr else (),
            mmr_constant=tuple(const) if mmr else (),
            mmr_coef=coef if mmr else None))
    return dovi_ops.DoviMetadata(
        curves=tuple(curves),
        ycc_to_rgb_matrix=np.asarray(rpu["ycc_to_rgb"], np.float64),
        ycc_to_rgb_offset=np.asarray(rpu["ycc_offset"], np.float64),
        rgb_to_lms_matrix=np.asarray(rpu["rgb_to_lms"], np.float64))
