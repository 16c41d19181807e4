"""Core tensor ops of the port (counterpart of ``raytracer3_tpu.ops``).

Unlike the reference package, importing this package loads no submodule, so
that importing one op never pulls in the others."""
