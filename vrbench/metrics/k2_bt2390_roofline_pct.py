"""K2's share of its roofline in the HDR passthrough cell: K2's compiled
BT.2390 route (``csrc/rows3_tail_c7.cu``), the H pass of the chroma, the
colour matrix, the local tone map, the dither and the pack, over the
passthrough chain's K2 (``costs/passthrough_mid16.py``; the reader is
``k2_roofline_pct``'s, ``roofline.stage_share``)."""

from .k2_roofline_pct import read  # noqa: F401
