"""Percent of the roofline that the whole call reaches in the HDR
passthrough cell: ``call_roofline_pct``'s reader over the passthrough
chain's call (``costs/passthrough_mid16.py``: the raw planes in, the
surface out)."""

from .call_roofline_pct import read  # noqa: F401
