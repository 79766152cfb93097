"""Input frames, one module a source format, named by the lower-case
``video_source.format`` of a configuration: ``batch(config, traffic, n, g,
device)`` draws one batch of ``n`` frames' planes from the generator
``g``, as the program takes them."""
