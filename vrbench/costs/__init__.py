"""Bytes and FLOPs of a call's stages, one module a chain of stages:
``stages(shape) -> {stage: (bytes, flops)}`` and ``call(shape)``."""
