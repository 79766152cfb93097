"""Percent of the roofline that the whole call reaches in the Jinc2 upscale
cell: ``call_roofline_pct``'s reader over the Jinc2 chain's call
(``costs/jinc2_k6.py``: the raw planes in, the surface out).  While K6 is
the call it reads what ``k6_roofline_pct`` reads; a call split into more
kernels, or with a pass beside K6, is read here whole."""

from .call_roofline_pct import read  # noqa: F401
