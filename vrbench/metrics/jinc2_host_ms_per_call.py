"""Mean host milliseconds of the window's root ``vrt.call`` spans in the
Jinc2 upscale cell: the staged route's host side and K6's wrapper, timed
from inside the entry (``entry_host_ms_per_call``'s reader)."""

from .entry_host_ms_per_call import read  # noqa: F401
