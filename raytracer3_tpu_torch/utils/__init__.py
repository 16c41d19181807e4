"""Host-side helpers of the port (counterpart of ``raytracer3_tpu.utils``)."""
