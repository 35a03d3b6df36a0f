"""nn_bvh — a JAX-native differentiable spectral path tracer + neural-BVH trainer.

Built from scratch in JAX/XLA with the capabilities of Wil-Lee/NN_BVH
(pbrt-v4 wavefront spectral path tracing + the fork's neural-spatial-split treeNet
acceleration-structure learner), re-designed for batched accelerators:

- SoA everywhere: rays, hits, BVH nodes, and path state are flat jnp arrays
  (the reference generates SoA layouts with a codegen tool, `cmd/soac.cpp`;
  pytrees of flat arrays give us the same layout for free).
- Polymorphism by integer tag + `lax.switch` / masked lane select (the reference
  uses a 57-bit tagged pointer, `util/taggedptr.h:23`).
- Parallelism by `shard_map` over a `jax.sharding.Mesh` (the reference's whole
  "distributed backend" is a single-node thread pool, `util/parallel.h:313`).
- The hot BVH traversal runs on the GPU as a CUDA kernel (accel/cuda_bvh4.py,
  one thread per ray over 4-wide nodes) called through `jax.ffi`; on the CPU
  it is the XLA while-loop walk (accel/traverse.py).
"""

__version__ = "0.1.0"
