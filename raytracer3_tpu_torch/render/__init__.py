"""Render layer of the port: camera, film, NEE helpers, the wavefront path
tracer, postprocess and the progressive pipeline."""
