"""One reader a metric: ``read(ctx) -> float | None``, None where the run
gave it nothing to read."""
