"""treeNet: the neural spatial-split model.

Rebuild of `nss_neural_spatial_split.py` spatialSplit_Model + the fork's EPO
path, redesigned for JAX:

- The reference's static 6-wide node tree is a *Python dict of per-node
  tf.Variables* looped per node (__make_empty_tree_6wide :82,
  deferred_train_step_EPO :178). Here every level is one array with a K=6^l
  node axis; a whole level's encoders run as a single batched einsum.
- The reference's deferred two-phase backprop (tape.stop_recording + per-node
  re-run with output_gradients, :288-309) exists to bound activation memory.
  `jax.checkpoint` around the encoder gives identical math (recompute in the
  backward pass) in one line.
- Pooling (agglomerative soft-min cost, :243-282) vectorizes per level.

Cost model (pool_treelet_EPO, nss_tree_modules.py:684): per node,
  C = (1-alpha) * C_SAH + alpha * C_EPO,
with C_SAH = SA(node)/SA(root) and C_EPO = w_epo (differentiable overlapped
surface area); treelet cost = soft_min over the 3 axis splits; the root's
pooled cost, normalized by 1/(pc_size * i_isect), is driven to zero by the
MSE loss (nss_loss.unsupervised_tree_loss) plus the out-of-bounds theta huber
penalty with 2^depth slope (nss_loss.penalty_tree_loss).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from . import common, encoder as enc_mod, splitter

Array = jax.Array


class TreeNetConfig(NamedTuple):
    levels: int = 4          # lvls (nss_global_config.py:15)
    capacity: int = 128      # dense units (:20)
    pc_size: int = 2048      # cloud size (:14)
    epo: bool = True         # fork EPO path vs nss SAH path
    alpha: float = 0.71      # EPO_SAH_alpha (:19)
    i_isect: float = 1.0     # C_tri (:23)
    t_isect: float = 1.2     # C_inn (:25)
    t_soft: float = 1.0      # soft-min temperature (:27)
    layer_gamma: float = 4.0
    learning_rate: float = 1e-5
    penalty_slope: float = 1.0

    @property
    def norm_factor(self) -> float:
        return 1.0 / (self.pc_size * self.i_isect)


def init_params(cfg: TreeNetConfig, key) -> tuple:
    """One encoder per interior level (levels-1 encoders)."""
    keys = jax.random.split(key, cfg.levels - 1)
    return tuple(
        enc_mod.init_encoder(k, cfg.capacity, cfg.epo) for k in keys
    )


class LevelState(NamedTuple):
    bounds: Array        # (B, K, 6)
    mask: Array          # (B, K, N)
    parent_offset: Array  # (B, K) split offset of the parent plane (root: dummy)
    lthetas: Array | None  # (B, K, 3) local thetas (None at leaf level)
    offsets: Array | None  # (B, K, 3) per-axis split offsets of THIS node


def _child_axis(k: Array | int):
    return (k % 6) // 2


def _child_is_right(k):
    return (k % 6) % 2 == 1


def forward_tree(params, cfg: TreeNetConfig, clouds: Array) -> list[LevelState]:
    """Build the full 6-wide tree. clouds: (B, N, 3) points or (B, N, 9) prims.

    Returns one LevelState per level (index 0 = root, levels-1 = leaves).
    """
    B, N = clouds.shape[0], clouds.shape[1]
    root_bounds = common.cloud_bounds(clouds)[:, None, :]  # (B,1,6)
    root_mask = jnp.ones((B, 1, N), jnp.float32)
    levels: list[LevelState] = []

    bounds = root_bounds
    mask = root_mask
    parent_offset = jnp.ones((B, 1), jnp.float32)

    ckpt_encoder = jax.checkpoint(enc_mod.apply_encoder, static_argnums=(4,))

    for l in range(cfg.levels - 1):
        K = 6**l
        cloud_b = jax.lax.stop_gradient(clouds)[:, None]  # (B,1,N,F) broadcast over K
        lth, scale, transl = ckpt_encoder(
            params[l], cloud_b, bounds, mask, cfg.layer_gamma
        )
        thetas = lth * scale + transl  # (B,K,3)

        if cfg.epo:
            offsets, off_l, off_r, child_bounds = splitter.gen_nodes_epo(
                clouds[:, None], bounds, thetas, mask
            )
        else:
            offsets, child_bounds = splitter.gen_nodes(bounds, thetas)

        levels.append(LevelState(bounds, mask, parent_offset, lth, offsets))

        # children: (B, K, 6, 6) -> (B, 6K, 6)
        new_bounds = child_bounds.reshape(B, 6 * K, 6)
        child_masks = []
        child_par_off = []
        for c in range(6):
            a = c // 2
            right = c % 2 == 1
            off_a = offsets[..., a]  # (B,K)
            if cfg.epo:
                cm = common.build_mask_epo(clouds[:, None], off_a[..., None], a, mask, right)
            else:
                cm = common.build_mask_points(
                    clouds[:, None], child_bounds[:, :, c]
                )
            child_masks.append(cm)
            child_par_off.append(off_a)
        # interleave: child index 6k+c
        new_mask = jnp.stack(child_masks, axis=2).reshape(B, 6 * K, N)
        new_par_off = jnp.stack(child_par_off, axis=2).reshape(B, 6 * K)

        bounds, mask, parent_offset = new_bounds, new_mask, new_par_off

    levels.append(LevelState(bounds, mask, parent_offset, None, None))
    return levels


def _sa_ratio(bounds: Array, root_bounds: Array) -> Array:
    sa = common.surface_area_bounds(bounds)
    sa_root = jnp.maximum(common.surface_area_bounds(root_bounds), 1e-12)
    # root_bounds is (B, 6); broadcast over the node axis
    return sa / sa_root.reshape(sa_root.shape + (1,) * (sa.ndim - sa_root.ndim))


def _node_cost_epo(cfg, clouds, level: LevelState, parent: LevelState | None,
                   root_bounds: Array) -> Array:
    """Blended (1-a)SAH + a*EPO cost of each node as a child of its parent
    (eval_interior / Cnode of eval_leaves_EPO)."""
    B, K, _ = level.bounds.shape
    c_sah = cfg.i_isect * _sa_ratio(level.bounds, root_bounds)
    if parent is None or K == 1:
        return (1 - cfg.alpha) * c_sah  # root: no external-overlap term
    k_idx = np.arange(K)
    axes = (k_idx % 6) // 2
    is_right = (k_idx % 6) % 2 == 1
    # vectorize w_epo by axis groups (axis/side are static per slot)
    c_epo = jnp.zeros((B, K), jnp.float32)
    parent_mask_rep = jnp.repeat(parent.mask, 6, axis=1)  # (B,K,N)
    for a in range(3):
        for right in (False, True):
            sel = np.nonzero((axes == a) & (is_right == right))[0]
            if len(sel) == 0:
                continue
            nb = level.bounds[:, sel]
            nm = level.mask[:, sel]
            pm = parent_mask_rep[:, sel]
            nmin = nb[..., a]
            nmax = nb[..., 3 + a]
            w = splitter.w_epo(
                clouds[:, None], nb, nm, pm, nmin, nmax, a, not right
            )
            c_epo = c_epo.at[:, sel].set(cfg.i_isect * w)
    return (1 - cfg.alpha) * c_sah + cfg.alpha * c_epo


def _child_costs_epo(cfg, clouds, level: LevelState, child_bounds6: Array,
                     child_masks6: Array, root_bounds: Array) -> Array:
    """(B, K, 6) blended costs of the 6 candidate children of each node
    (CxL..CzR of eval_leaves_EPO)."""
    costs = []
    for c in range(6):
        a = c // 2
        right = c % 2 == 1
        nb = child_bounds6[:, :, c]
        nm = child_masks6[:, :, c]
        c_sah = _sa_ratio(nb, root_bounds)
        w = splitter.w_epo(
            clouds[:, None], nb, nm, level.mask,
            nb[..., a], nb[..., 3 + a], a, not right
        )
        costs.append((1 - cfg.alpha) * c_sah + cfg.alpha * cfg.t_isect * w)
    return jnp.stack(costs, axis=-1)


def _node_cost_sah(cfg, points, level: LevelState, parent: LevelState | None,
                   root_bounds: Array) -> Array:
    """SAH/point variant Cnode = t_isect * SA ratio (pool_treelet.eval_interior)."""
    return cfg.t_isect * _sa_ratio(level.bounds, root_bounds)


def pooled_cost(params, cfg: TreeNetConfig, clouds: Array, levels=None):
    """Soft-pooled tree cost (training forward). Returns (cost (B,), aux dict)."""
    if levels is None:
        levels = forward_tree(params, cfg, clouds)
    root_bounds = levels[0].bounds[:, 0]
    B = clouds.shape[0]
    L = cfg.levels

    # --- leaf-parent level: evaluate candidate children directly ----------
    p = L - 2
    lev = levels[p]
    K = 6**p
    child_bounds6 = levels[p + 1].bounds.reshape(B, K, 6, 6)
    child_masks6 = levels[p + 1].mask.reshape(B, K, 6, -1)

    if cfg.epo:
        cnode = _node_cost_epo(cfg, clouds, lev, levels[p - 1] if p > 0 else None,
                               root_bounds)
        cchild = _child_costs_epo(cfg, clouds, lev, child_bounds6, child_masks6,
                                  root_bounds)
    else:
        cnode = _node_cost_sah(cfg, clouds, lev, None, root_bounds)
        # q * SA ratio per child (eval_leaves, nss_tree_modules.py:458)
        costs = []
        for c in range(6):
            a = c // 2
            right = c % 2 == 1
            nb = child_bounds6[:, :, c]
            off = lev.offsets[..., a]
            axis_pts = clouds[:, None, :, a]
            n_left = splitter.ql_points(
                axis_pts, lev.mask, lev.bounds[..., a], lev.bounds[..., 3 + a], off
            )
            n_tot = jax.lax.stop_gradient(jnp.sum(lev.mask, axis=-1))
            q = (n_tot - n_left) if right else n_left
            costs.append(cfg.i_isect * q * _sa_ratio(nb, root_bounds))
        cchild = jnp.stack(costs, axis=-1)

    cost_axes = cnode[..., None] + cchild[..., 0::2] + cchild[..., 1::2]  # (B,K,3)
    pooled = splitter.soft_min(cost_axes, cfg.t_soft)  # (B,K)
    per_level_cost_axes = {p: cost_axes}

    # --- interior levels bottom-up ---------------------------------------
    for l in range(p - 1, -1, -1):
        lev = levels[l]
        K = 6**l
        if cfg.epo:
            cnode = _node_cost_epo(cfg, clouds, lev, levels[l - 1] if l > 0 else None,
                                   root_bounds)
        else:
            cnode = _node_cost_sah(cfg, clouds, lev, None, root_bounds)
        child_pool = pooled.reshape(B, K, 6)
        cost_axes = cnode[..., None] + child_pool[..., 0::2] + child_pool[..., 1::2]
        pooled = splitter.soft_min(cost_axes, cfg.t_soft)
        per_level_cost_axes[l] = cost_axes

    root_cost = pooled[:, 0] * cfg.norm_factor
    return root_cost, {"cost_axes": per_level_cost_axes, "levels": levels}


def penalty_loss(cfg: TreeNetConfig, levels) -> Array:
    """Out-of-bounds theta huber penalty with 2^depth slope
    (nss_loss.penalty_tree_loss)."""
    max_inter = cfg.levels - 1
    total = jnp.zeros(())

    def huber(d, delta=0.1):
        a = jnp.abs(d)
        return jnp.where(a <= delta, 0.5 * d * d, delta * (a - 0.5 * delta))

    for l in range(max_inter):
        lth = levels[l].lthetas  # (B,K,3)
        pen = (lth < 0) * huber(lth) + (lth > 1) * huber(lth - 1.0)
        n = max_inter - l
        slope = cfg.penalty_slope * (2.0 ** (n + 1) - 1.0)  # sumPowerSeries(2, n)
        total = total + slope * jnp.sum(jnp.mean(jnp.sum(pen, axis=-1), axis=0))
    return total


def loss_fn(params, cfg: TreeNetConfig, clouds: Array):
    """Training loss: MSE(pooled cost, 0) + penalty (deferred_train_step_EPO)."""
    cost, aux = pooled_cost(params, cfg, clouds)
    tree_loss = jnp.mean(cost**2)
    pen = penalty_loss(cfg, aux["levels"])
    out_of_bounds = sum(
        jnp.sum((lev.lthetas < 0) | (lev.lthetas > 1))
        for lev in aux["levels"][: cfg.levels - 1]
    )
    metrics = {
        "tree_loss": tree_loss,
        "pen_loss": pen,
        "mae": jnp.mean(cost),
        "out_of_bounds_splits": out_of_bounds,
    }
    return tree_loss + pen, metrics


def predict_tree(params, cfg: TreeNetConfig, clouds: Array):
    """Hard (argmin) plane extraction -> level-order plane list.

    Returns (cost (B,), planes (B, 2^(levels-1) - 1, 4) as [nx, ny, nz, offset]
    level-order — the artifact format of predict_step_EPO / export
    (nss_model_test.py:37)).
    """
    cost, aux = pooled_cost(params, cfg, clouds)
    levels = aux["levels"]
    cost_axes = aux["cost_axes"]
    B = clouds.shape[0]
    L = cfg.levels

    planes = []
    sel = jnp.zeros((B, 1), jnp.int32)  # selected 6-wide node ids at level l
    for l in range(L - 1):
        ca = cost_axes[l]  # (B, 6^l, 3)
        lev = levels[l]
        ca_sel = jnp.take_along_axis(ca, sel[..., None], axis=1)  # (B,S,3)... gather
        axis = jnp.argmin(ca_sel, axis=-1)  # (B, S)
        off_sel = jnp.take_along_axis(lev.offsets, sel[..., None], axis=1)  # (B,S,3)
        off = jnp.take_along_axis(off_sel, axis[..., None], axis=-1)[..., 0]
        normal = jax.nn.one_hot(axis, 3)
        planes.append(jnp.concatenate([normal, off[..., None]], axis=-1))  # (B,S,4)
        # descend: children 6*k + 2*axis + {0,1}
        left = 6 * sel + 2 * axis
        right = left + 1
        sel = jnp.stack([left, right], axis=-1).reshape(B, -1)
    return cost, jnp.concatenate(planes, axis=1)
