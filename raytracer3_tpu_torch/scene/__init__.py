"""Scene layer of the port: scene tensors and the procedural/analytic scenes."""
