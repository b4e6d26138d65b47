"""Data-parallel training, evaluation and bulk inference over a mesh.

Port of `cadx_tpu/parallel/data_parallel.py`. Batch rows split over the
mesh's "data" axis and the parameters are replicated: each position runs
its rows on its own replica (the conv_leaky and pool kernels on the
card), the gradients are summed over the axis (`mesh.Axis.all_sum`), and
every replica then applies the same clip + SGD or Adam step to the same
sums, so the replicas stay bit-identical. A shard's loss is its part of
the whole batch's masked mean (the batch's real count in the
denominator), so the summed gradient is the single-device one; dropout
draws the whole batch's uniforms from the shared generator and each shard
keeps its rows, as JAX draws over the global batch. The update makers
plug into `train.step.fit(update_fn=...)`.

On a local mesh the caller's model is the replica on the mesh's first
device (it must live there) and the others are copies that persist
between steps; they are made again when the model, its parameters (by
their version counters) or the optimizer state change outside the
update. On a distributed mesh each rank's model is its replica.
"""

from __future__ import annotations

import copy

import torch

from cadx_tpu_torch.models import cnn
from cadx_tpu_torch.parallel.mesh import DATA_AXIS, Axis, Mesh, row_slices
from cadx_tpu_torch.precision import full_fp32
from cadx_tpu_torch.train import optim
from cadx_tpu_torch.train.step import masked_loss_fn


def _versions(module: torch.nn.Module) -> tuple:
    return tuple(p._version for p in module.parameters())


def _state_to(state, device):
    if state is None:
        return None
    return optim.AdamState(state.count, [m.to(device, copy=True) for m in state.mu],
                           [v.to(device, copy=True) for v in state.nu])


def _check_home(module: torch.nn.Module, axis: Axis) -> None:
    dev = next(module.parameters()).device
    if dev != axis.devices[0]:
        raise ValueError(f"the model lives on {dev}; a data-parallel update "
                         f"keeps it as the replica on {axis.devices[0]}")


class Replicas:
    """The training replicas of one module on an axis's local devices,
    each with its optimizer state; position 0's are the caller's own."""

    def __init__(self, axis: Axis):
        self.axis = axis
        self.models: list = []
        self.states: list = []
        self._key = None

    @staticmethod
    def _key_of(model, state):
        return (id(model), _versions(model), None if state is None else
                (id(state.mu), state.count))

    def sync(self, model, state):
        if self._key != self._key_of(model, state):
            _check_home(model, self.axis)
            devs = self.axis.devices[1:]
            self.models = [model] + [copy.deepcopy(model).to(d) for d in devs]
            self.states = [state] + [_state_to(state, d) for d in devs]
        return self.models, self.states

    def commit(self, states) -> None:
        self.states = list(states)
        self._key = self._key_of(self.models[0], self.states[0])


# each tensor's slot in a flat buffer starts 512 bytes on, as a fresh
# allocation does: a reduction over a slot (the clip's norm) then takes
# the same vectorised order as over the tensor itself
_SLOT = 128


def _slots(tensors) -> list[int]:
    offsets, at = [], 0
    for t in tensors:
        offsets.append(at)
        at += -(-t.numel() // _SLOT) * _SLOT
    return offsets + [at]


def dp_grads(replicas: Replicas, model, state, shard_loss):
    """The gradients of the batch's loss, summed over the axis: `shard_loss
    (replica, k, device)` is local position k's loss (its share of the
    batch's). Each position's gradients and loss go into one flat buffer,
    summed over the axis in one collective. Returns (replicas, their
    states, each replica's gradients as views of its summed buffer, the
    batch's loss on position 0's device)."""
    models, states = replicas.sync(model, state)
    flats = []
    for k, (m, dev) in enumerate(zip(models, replicas.axis.devices)):
        params = list(m.parameters())
        with torch.enable_grad(), full_fp32():
            loss = shard_loss(m, k, dev)
            grads = torch.autograd.grad(loss, params)
        parts = list(grads) + [loss.detach().reshape(1)]
        offsets = _slots(parts)
        flat = torch.zeros(offsets[-1], dtype=loss.dtype, device=dev)
        for t, at in zip(parts, offsets):
            flat[at:at + t.numel()].copy_(t.reshape(-1))
        flats.append(flat)
    summed = replicas.axis.all_sum(flats)
    params = list(models[0].parameters())
    offsets = _slots(params + [summed[0][:1]])
    grads = [[flat[at:at + p.numel()].view(p.shape) for p, at in zip(params, offsets)]
             for flat in summed]
    return models, states, grads, summed[0][offsets[-2]]


def dp_step(replicas: Replicas, model, state, shard_loss, apply_update):
    """One data-parallel update in place: `dp_grads`, then
    `apply_update(params, grads, state) -> state` on every replica.
    Returns (position 0's state, the batch's loss)."""
    models, states, grads, loss = dp_grads(replicas, model, state, shard_loss)
    new_states = [apply_update(list(m.parameters()), g, s)
                  for m, g, s in zip(models, grads, states)]
    replicas.commit(new_states)
    return new_states[0], loss


def _cnn_shard_loss(config: cnn.CNNConfig, axis: Axis, x, y, mask, generator, compute_dtype):
    """The masked loss's shard_loss for `dp_grads`: position k's rows, the
    batch's real count, its rows of the batch's dropout uniforms."""
    slices = row_slices(x.shape[0], axis)
    count = torch.clamp_min(mask.sum(), 1.0)
    uniforms = None
    if config.dropout_rate > 0.0 and generator is not None:
        uniforms = cnn.dropout_uniforms(config, x.shape[0], generator, x.device)

    def shard_loss(m, k, dev):
        s = slices[k]
        return masked_loss_fn(
            m, x[s].to(dev), y[s].to(dev), mask[s].to(dev), training=True,
            generator=None, compute_dtype=compute_dtype, count=count.to(dev),
            uniforms=None if uniforms is None else [u[s].to(dev) for u in uniforms])

    return shard_loss


def _cnn_update(config: cnn.CNNConfig, mesh: Mesh, compute_dtype, apply_update):
    axis = mesh.axis(DATA_AXIS)
    replicas = Replicas(axis)

    def update_fn(model, opt_state, x, y, mask, lr, generator):
        shard_loss = _cnn_shard_loss(config, axis, x, y, mask, generator, compute_dtype)
        return dp_step(replicas, model, opt_state, shard_loss,
                       lambda params, grads, state: apply_update(params, grads, state, lr))

    update_fn.replicas = replicas
    return update_fn


def make_dp_grads(config: cnn.CNNConfig, mesh: Mesh, compute_dtype=None):
    """`grads_fn(model, x, y, mask, generator) -> (loss, grads)`: the
    masked training loss of the whole batch and its gradients, one per
    tensor of `model.parameters()`, computed shard by shard and summed
    over the data axis, as the dp updates take them."""
    axis = mesh.axis(DATA_AXIS)
    replicas = Replicas(axis)

    def grads_fn(model, x, y, mask, generator):
        shard_loss = _cnn_shard_loss(config, axis, x, y, mask, generator, compute_dtype)
        _, states, grads, loss = dp_grads(replicas, model, None, shard_loss)
        replicas.commit(states)
        return loss, grads[0]

    return grads_fn


def make_dp_sgd_update(config: cnn.CNNConfig, mesh: Mesh, compute_dtype=None):
    """Mesh-sharded basic-pipeline update (per-tensor clip + SGD),
    `fit(update_fn=...)` compatible: `update_fn(model, opt_state, x, y,
    mask, lr, generator) -> (opt_state, loss)`. compute_dtype: the conv
    stack's opt-in bfloat16 (cnn.conv_stack). `update_fn.replicas`
    holds the replicas."""

    def sgd(params, grads, state, lr):
        optim.sgd_reference_update(params, grads, lr)
        return state

    return _cnn_update(config, mesh, compute_dtype, sgd)


def make_dp_adam_update(config: cnn.CNNConfig, mesh: Mesh, lr: float = 1e-3,
                        compute_dtype=None):
    """Mesh-sharded advanced-pipeline (Adam) update and its init_fn; the
    update ignores fit's lr and steps at `lr`."""
    tx = optim.adam(lr)
    update_fn = _cnn_update(config, mesh, compute_dtype,
                            lambda params, grads, state, _lr: tx.step(params, grads, state))
    return update_fn, tx.init


class _ReadOnlyCopies:
    """A module's copies on other devices for inference, made once and
    made again when its parameters change (by their version counters);
    a position on the module's own device uses the module itself."""

    def __init__(self):
        self._cache: dict = {}

    def on(self, module: torch.nn.Module, device) -> torch.nn.Module:
        if next(module.parameters()).device == torch.device(device):
            return module
        key = (id(module), torch.device(device))
        hit = self._cache.get(key)
        if hit is None or hit[0] is not module or hit[1] != _versions(module):
            hit = (module, _versions(module), copy.deepcopy(module).to(device))
            self._cache[key] = hit
        return hit[2]


def gather_rows(axis: Axis, parts: list[torch.Tensor], home, dim: int = 0) -> torch.Tensor:
    """The positions' parts concatenated along `dim`, in position order,
    on `home` (this rank's device on a distributed axis)."""
    return torch.cat(axis.all_gather(parts, home), dim=dim)


def make_dp_pipeline(pipeline_config, mesh: Mesh):
    """Mesh-sharded fused inference pipeline: `run(params, batch_u8)` runs
    `pipeline.fused.run_pipeline` on each position's rows and device and
    returns the whole batch's PipelineOutput on the mesh's home device."""
    from cadx_tpu_torch.pipeline import fused

    axis = mesh.axis(DATA_AXIS)
    copies = _ReadOnlyCopies()

    def run(params, batch_u8: torch.Tensor):
        outs = []
        for s, dev in zip(row_slices(batch_u8.shape[0], axis), axis.devices):
            p = fused.PipelineParams(*(copies.on(m, dev) for m in params))
            outs.append(fused.run_pipeline(p, batch_u8[s].to(dev), pipeline_config))
        return fused.PipelineOutput(*(
            gather_rows(axis, [o[i] for o in outs], mesh.home)
            for i in range(len(fused.PipelineOutput._fields))))

    return run


def make_dp_eval(config: cnn.CNNConfig, mesh: Mesh):
    """Mesh-sharded batched argmax prediction: `predict(model, x)`."""
    from cadx_tpu_torch.train.step import eval_step

    axis = mesh.axis(DATA_AXIS)
    copies = _ReadOnlyCopies()

    def predict(model, x: torch.Tensor) -> torch.Tensor:
        parts = [eval_step(copies.on(model, dev), x[s].to(dev))
                 for s, dev in zip(row_slices(x.shape[0], axis), axis.devices)]
        return gather_rows(axis, parts, mesh.home)

    return predict
