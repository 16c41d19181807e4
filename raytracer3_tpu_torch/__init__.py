"""raytracer3_tpu_torch — the PyTorch/CUDA port of ``raytracer3_tpu``.

The JAX package beside this one is the reference: every module here mirrors
the module of the same path there, keeps its public function names and array
layouts, and is held against it on identical inputs by ``tests/test_torch_*``.
This package imports ``torch`` and numpy, never ``jax`` and nothing of the
JAX package: where it needs a numpy-only module of the reference it keeps
its own copy (``native``, ``utils/config``, ``utils/image``, ``scene/pools``,
``scene/gltf``, ``scene/assets`` and the generators of ``scene/procedural``),
and its native library and asset cache build into ``build/`` of the
checkout.

- ``ops``    — math, counter-based RNG, rgb9e5 packing, brute-force
               intersection, the host cluster-BVH and two-level (TLAS/BLAS)
               builds, the traversal kernels K1–K4 (``csrc/traverse.cu``)
               with their plain PyTorch versions, the treelet driver, BRDFs,
               AgX tonemapping
- ``scene``  — the scene tensors (``make_scene``, ``hit_surface_info``), the
               mip-atlas textures, the geometry pool, GLB ingest and writers,
               the asset cache and background pipeline, the atrium, Cornell
               and textured-golden scenes
- ``graph``  — ``FrameGraph``: passes over named resources, temporal state
- ``render`` — camera, film, NEE helpers, the wavefront and reference-mode
               path tracers, probe GI, the denoiser, postprocess and the
               four pipelines on the frame graph
- ``app``    — ``World``: meshes, instances, flattened and instanced
               scenes, asynchronous GLB loading, trace backends; the
               interactive viewer (``python -m
               raytracer3_tpu_torch.app.viewer``), its settings tuner and
               MJPEG preview
- ``utils``  — ``RenderSettings``, image IO, profiling, checkpoints,
               device reporting

Every function that makes tensors takes an explicit ``device``; nothing moves between devices
implicitly. On a CUDA device the traversal wrappers launch the hand-written
kernels (or raise); on the CPU they run the kernels' plain versions.
"""

__version__ = "0.1.0"
