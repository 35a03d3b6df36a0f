"""Multi-host launch + render-state checkpointing.

The reference is single-node (SURVEY.md §2.10: no NCCL/MPI anywhere); its
"recovery" story is --write-partial-images crash salvage and the ML side's
checkpoint-restore with RNG fast-forward (nss_treeNet_model.py:41-46). The
equivalents here:

- `initialize()`: jax.distributed bring-up from env or explicit args. On a
  multi-host cluster each process sees its local devices and `jax.devices()` is global;
  the SAME render/train code (dist/sharding.py, learn/joint.py) then runs
  with a global mesh — collectives ride ICI within a slice, DCN across
  hosts.
- `save_render_state()/load_render_state()`: per-host checkpoint of
  (film shard, sample index, params) so a killed render resumes at the next
  wave boundary. Deterministic samplers (pixel, sample_index) make the
  resumed image bit-identical to an uninterrupted run.

A 2-process CPU harness (tests/test_multihost.py) validates process-spanning
meshes without a real cluster: each process owns half the virtual devices,
film bands stay host-local, and the final image equals the single-process
render exactly.
"""

from __future__ import annotations

import os

import numpy as np
import jax

Array = jax.Array


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed bring-up. No-op when single-process (num_processes<=1
    and no env). Env fallbacks: JAX_COORDINATOR, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID (useful for mpirun-style launchers)."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def local_band(R: int, mesh=None) -> tuple[int, int]:
    """[start, end) of the flat pixel range owned by THIS host's devices
    (contiguous bands under a 1-D mesh). Derived from mesh POSITION, not raw
    device ids (which need not be contiguous or id-ordered, ADVICE r3); pass
    the mesh used for the render — defaults to a 1-D mesh over
    jax.devices() in enumeration order."""
    devs = list(mesh.devices.flat) if mesh is not None else list(jax.devices())
    n = len(devs)
    per = R // n
    pos = [i for i, d in enumerate(devs) if d.process_index == jax.process_index()]
    return min(pos) * per, (max(pos) + 1) * per


def save_render_state(path: str, xyz, weight, next_sample: int,
                      params=None) -> None:
    """Per-host checkpoint: each process writes ONLY its film band (addressable
    shards), so no cross-host traffic. path gets a .proc{i} suffix."""
    idx = jax.process_index()
    shards = {}

    def _band(arr):
        # addressable_shards iteration order is not guaranteed to be shard
        # order — sort by the shard's global start index (ADVICE r3)
        ss = sorted(arr.addressable_shards,
                    key=lambda s: (s.index[0].start or 0))
        return np.concatenate([np.asarray(s.data) for s in ss], 0)

    shards["xyz"] = _band(xyz)
    shards["weight"] = _band(weight)
    shards["next_sample"] = np.int64(next_sample)
    if params is not None:
        flat, _ = jax.tree_util.tree_flatten(params)
        for i, leaf in enumerate(flat):
            shards[f"param_{i}"] = np.asarray(leaf)
    np.savez(f"{path}.proc{idx}", **shards)


def load_render_state(path: str, params_template=None):
    """Load THIS process's shard back. Returns (xyz_np, weight_np,
    next_sample, params or None)."""
    idx = jax.process_index()
    with np.load(f"{path}.proc{idx}.npz") as z:
        xyz = z["xyz"]
        weight = z["weight"]
        next_sample = int(z["next_sample"])
        params = None
        if params_template is not None:
            flat, treedef = jax.tree_util.tree_flatten(params_template)
            leaves = [z[f"param_{i}"] for i in range(len(flat))]
            params = jax.tree_util.tree_unflatten(treedef, leaves)
    return xyz, weight, next_sample, params
