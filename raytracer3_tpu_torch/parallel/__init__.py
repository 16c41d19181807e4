"""Multi-device rendering on ``torch.distributed`` (counterpart of
``raytracer3_tpu.parallel``)."""
