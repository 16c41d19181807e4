"""Measurement tools of the port (run as ``python -m raytracer3_tpu_torch.tools.<name>``)."""
