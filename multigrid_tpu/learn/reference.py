"""Plain float32 reference of the clipped-PPO loss, for checking the learner.

:func:`ppo_loss_f32` recomputes the loss of ``make_train_step`` from its
definition, independently of ``learn/ppo.py``: one net application per agent
in a Python loop (no ``vmap`` over stacked parameters), a ``take_along_axis``
log-prob, float32 parameters *and* compute. :func:`compare_with_reference`
evaluates both under ``jax.default_matmul_precision('highest')`` for the
reference, so float32 matmuls are not silently run in TF32 or bf16 passes.

The train step computes in bfloat16 with float32 accumulation, so it matches
the reference only to bf16 rounding: its 8-bit mantissa gives a relative
error of about 4e-3 per rounded operand, and a few roundings compound
through the three layers and the softmax. Hence :data:`LOSS_RTOL` on the
loss, against the sum of its terms' magnitudes (the policy term of
normalized advantages is near zero, so the signed sum can cancel), and
:data:`GRAD_RTOL` on the whole gradient, as the norm of the error
over the norm of the reference gradient (the optimizer clips and steps
along that vector). Single bias leaves can be worse: a bias gradient is a
sum of bf16 cotangents over the whole batch and every spatial position, in
which terms cancel, so it is reported but not gated.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .nets import CentralizedCritic

#: Relative error allowed on the loss (bf16 compute vs float32): each
#: sample's log-prob and value carry the ~1% error of bf16 logits through
#: three layers, which a small batch does not average away.
LOSS_RTOL = 2e-2
#: Relative error allowed on the gradient: ||g - g_ref|| / ||g_ref|| over
#: all leaves together (bf16 compute vs float32).
GRAD_RTOL = 2e-2


def ppo_loss_f32(net, config, params, traj, advantages, targets):
    """Clipped-PPO loss of one (T, E, N) batch, in float32 throughout.

    Returns ``(loss, scale)``: ``scale`` is the sum of the magnitudes of the
    loss's three weighted terms.

    Matches ``make_train_step``'s loss: advantages normalized over the whole
    batch (per agent with ``per_agent_policies``), ``0.5·mean((V - G)²)``
    value loss, mean entropy bonus; with ``centralized_critic`` the value is
    the joint-observation critic's, broadcast to every agent.
    """
    f32 = dataclasses.replace(net, dtype=jnp.float32)
    n = traj.direction.shape[-1]
    actor = params['actor'] if config.centralized_critic else params
    logits, values = [], []
    for a in range(n):
        p = (jax.tree.map(lambda x: x[a], actor)
             if config.per_agent_policies else actor)
        img = (traj.image[..., a, :] if net.packed_obs
               else traj.image[..., a, :, :, :])
        mis = None if traj.mission is None else traj.mission[..., a]
        lg, v = f32.apply(p, img, traj.direction[..., a], mis)
        logits.append(lg)
        values.append(v)
    logits = jnp.stack(logits, axis=-2)          # (T, E, N, A)
    value = jnp.stack(values, axis=-1)           # (T, E, N)
    if config.centralized_critic:
        critic = CentralizedCritic(
            hidden=net.hidden, dtype=jnp.float32,
            num_missions=net.num_missions, packed_obs=net.packed_obs)
        v = critic.apply(params['critic'], traj.image, traj.direction,
                         traj.mission)
        value = jnp.broadcast_to(v[..., None], value.shape)

    logp_all = jax.nn.log_softmax(logits)
    logp = jnp.take_along_axis(
        logp_all, traj.action[..., None].astype(jnp.int32), axis=-1)[..., 0]
    ratio = jnp.exp(logp - traj.log_prob)
    if config.per_agent_policies:
        flat = advantages.reshape(-1, n)
        adv = (advantages - flat.mean(0)) / (flat.std(0) + 1e-8)
    else:
        adv = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
    clipped = jnp.clip(ratio, 1 - config.clip_eps, 1 + config.clip_eps)
    pg_loss = -jnp.mean(jnp.minimum(ratio * adv, clipped * adv))
    vf_loss = 0.5 * jnp.mean((value - targets) ** 2)
    entropy = -jnp.mean(jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1))
    terms = (pg_loss, config.vf_coef * vf_loss, -config.ent_coef * entropy)
    return sum(terms), sum(jnp.abs(t) for t in terms)


def compare_with_reference(train_step, net, config, params, traj,
                           advantages, targets) -> dict:
    """Loss and gradients of ``train_step.loss_fn`` against
    :func:`ppo_loss_f32` on one batch.

    Returns ``loss``, ``loss_ref``, ``loss_rel_err`` (against the sum of the
    loss terms' magnitudes), ``grad_rel_err``
    (whole-gradient relative error), ``worst_leaf`` and ``worst_leaf_err``
    (the leaf with the largest ||g - g_ref|| / ||g_ref||), and ``ok``: the
    loss and whole-gradient errors are inside :data:`LOSS_RTOL` and
    :data:`GRAD_RTOL`.
    """
    (loss, _), grads = jax.jit(jax.value_and_grad(
        train_step.loss_fn, has_aux=True))(
            params, traj, advantages, targets)
    with jax.default_matmul_precision('highest'):
        (loss_ref, scale), grads_ref = jax.jit(jax.value_and_grad(
            lambda p: ppo_loss_f32(
                net, config, p, traj, advantages, targets),
            has_aux=True))(params)
    loss, loss_ref = float(loss), float(loss_ref)
    loss_err = abs(loss - loss_ref) / max(float(scale), 1e-8)
    err_sq = ref_sq = 0.0
    worst, worst_err = None, 0.0
    for (path, g), r in zip(jax.tree_util.tree_leaves_with_path(grads),
                            jax.tree.leaves(grads_ref)):
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        e2, r2 = np.sum((g - r) ** 2), np.sum(r ** 2)
        err_sq, ref_sq = err_sq + e2, ref_sq + r2
        leaf_err = float(np.sqrt(e2 / r2)) if r2 > 0 else float(np.sqrt(e2))
        if leaf_err >= worst_err:
            worst, worst_err = jax.tree_util.keystr(path), leaf_err
    grad_err = float(np.sqrt(err_sq / ref_sq))
    return {
        'loss': loss, 'loss_ref': loss_ref, 'loss_rel_err': loss_err,
        'grad_rel_err': grad_err, 'worst_leaf': worst,
        'worst_leaf_err': worst_err,
        'ok': loss_err <= LOSS_RTOL and grad_err <= GRAD_RTOL,
    }
