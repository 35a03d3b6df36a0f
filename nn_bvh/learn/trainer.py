"""treeNet trainer: optax Adam loop + checkpoint/resume + data-parallel sharding.

Rebuild of `nss_treeNet_model.py` neural_kdtree:
- train_EPO (:34): per-batch manual loop over generator batches.
- checkpointing (:92-94, 178): params + optimizer state saved every
  checkpoint_window epochs; restore resumes and fast-forwards the data rng by
  replaying (load/continue_training :190-210). Here: a single npz of the
  param/opt pytree + the batch counter (the rng fast-forward is implied by
  the counter since the stream is counter-deterministic).
- The TF version's deferred two-phase backprop is subsumed by jax.checkpoint
  in treenet.forward_tree; grads come from one jax.value_and_grad.
- Data parallelism: the batch axis shards over the jax mesh with grads
  psum'd (the mesh replacement for the reference's single-GPU loop).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import optax

from . import treenet
from .treenet import TreeNetConfig

Array = jax.Array


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def make_train_state(cfg: TreeNetConfig, key) -> tuple[TrainState, optax.GradientTransformation]:
    params = treenet.init_params(cfg, key)
    tx = optax.adam(cfg.learning_rate)
    return TrainState(params, tx.init(params), 0), tx


def make_train_step(cfg: TreeNetConfig, tx, mesh=None):
    """Returns jitted train_step(state, clouds) -> (state, metrics).

    With a mesh, the batch axis is sharded and grads pmean over it.
    """

    def step_fn(state: TrainState, clouds: Array):
        (loss, metrics), grads = jax.value_and_grad(
            treenet.loss_fn, has_aux=True
        )(state.params, cfg, clouds)
        if mesh is not None:
            grads = jax.lax.pmean(grads, "batch")
            loss = jax.lax.pmean(loss, "batch")
            metrics = jax.tree.map(lambda m: jax.lax.pmean(m * 1.0, "batch"), metrics)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        metrics = dict(metrics, loss=loss)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    if mesh is None:
        return jax.jit(step_fn)

    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    def sharded(state, clouds):
        f = shard_map(
            step_fn,
            mesh=mesh,
            in_specs=(jax.tree.map(lambda _: P(), state), P("batch")),
            out_specs=(jax.tree.map(lambda _: P(), state), P()),
        )
        return f(state, clouds)

    return jax.jit(sharded)


def train(
    cfg: TreeNetConfig,
    scene,
    n_steps: int = 100,
    batch_size: int = 8,
    seed: int = 0,
    checkpoint_dir: str | None = None,
    checkpoint_window: int = 15,
    log_every: int = 10,
    mesh=None,
    callback=None,
):
    """Training loop (train_EPO analog). Returns (state, history)."""
    state, tx = make_train_state(cfg, jax.random.PRNGKey(seed))
    start = 0
    if checkpoint_dir and os.path.exists(os.path.join(checkpoint_dir, "latest.pkl")):
        state = load_checkpoint(checkpoint_dir, state)
        start = state.step
        # fast-forward the deterministic stream by replaying counters
        for _ in range(start):
            scene.next_batch(batch_size)
    step = make_train_step(cfg, tx, mesh)
    history = []
    for i in range(start, n_steps):
        clouds = jnp.asarray(scene.next_batch(batch_size))
        state, metrics = step(state, clouds)
        if (i + 1) % log_every == 0 or i == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i + 1
            history.append(m)
            if callback is not None:
                # callbacks.TrainLog: test-set eval + CSV + best checkpoint
                callback.on_log(state, metrics)
        if checkpoint_dir and (i + 1) % checkpoint_window == 0:
            save_checkpoint(checkpoint_dir, state)
    if checkpoint_dir:
        save_checkpoint(checkpoint_dir, state)
    return state, history


def save_checkpoint(path: str, state: TrainState) -> None:
    os.makedirs(path, exist_ok=True)
    host = jax.tree.map(np.asarray, state)
    with open(os.path.join(path, "latest.pkl"), "wb") as f:
        pickle.dump(host, f)


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    with open(os.path.join(path, "latest.pkl"), "rb") as f:
        host = pickle.load(f)
    return jax.tree.map(jnp.asarray, host)
