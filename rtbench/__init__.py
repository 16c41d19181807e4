"""The benchmark of ``raytracer3_tpu_torch`` (the PyTorch and CUDA port):
progressive frames through the app's ``Viewer`` on one card, measured end
to end and per layer, and checked against a plain PyTorch reference.

``BENCHMARK.json`` at the root of the checkout names the cells; each
configuration, traffic mix, per-layer metric and cell's limits is a file of
its own here, found by its name (``rtbench.spec``). One run of one cell:

    python3 rtbench/run.py --workload sponza1080.walk1 --seed 7 --seconds 30 --trace 0

Nothing here imports ``jax`` or the JAX package ``raytracer3_tpu``."""
