"""raytracer3_tpu_torch — the PyTorch/CUDA port of ``raytracer3_tpu``.

The JAX package beside this one is the reference: every module here mirrors
the module of the same path there, keeps its public function names and array
layouts, and is held against it on identical inputs by ``tests/test_torch_*``.
This package imports ``torch`` and numpy, never ``jax``; from the JAX package
it reuses only numpy-only modules (``raytracer3_tpu.native``,
``raytracer3_tpu.utils.config`` and the generators in
``raytracer3_tpu.scene.procedural``), each behind a module of this package
(``ops/cluster_bvh``, ``utils/config``, ``scene/procedural``).

- ``ops``    — math, counter-based RNG, rgb9e5 packing, brute-force
               intersection, the host cluster-BVH build, the K1/K2 traversal
               kernel (``csrc/traverse.cu``) and its plain PyTorch version,
               BRDFs, AgX tonemapping
- ``scene``  — the scene tensors (``make_scene``, ``hit_surface_info``), the
               atrium and Cornell scenes
- ``render`` — camera, film, NEE helpers, the wavefront path tracer,
               postprocess and the progressive ``wavefront_pipeline``
- ``utils``  — ``RenderSettings``

Every function that makes tensors takes an explicit ``device``; nothing moves between devices
implicitly. On a CUDA device the traversal wrapper launches the hand-written
kernel (or raises); on the CPU it runs the kernel's plain version.
"""

__version__ = "0.1.0"
