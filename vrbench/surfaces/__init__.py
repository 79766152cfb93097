"""Output surfaces, one module a format, named by a configuration's
``surface``: ``codes(words)`` decodes one frame into (3, H, W) int64 colour
codes, ``bad(words)`` counts the words that break the format, and
``pack(codes)`` encodes codes as the program would (the control's
surfaces)."""
