"""The training step (counterpart of `paddle_tpu/distributed/trainer.py`,
one card, no mesh).

`Trainer.step(batch)` runs forward, backward, the gradient clip and the
optimizer update of one step, eagerly on the model's device, and returns
the f32 loss as a device tensor without fetching it; `LossBuffer` holds
such losses and fetches them in one sync. With `grad_accum_steps=N` the
batch is split into N micro-batches along its first axis; their
gradients are summed in f32 and averaged before the one update, and the
loss is the mean of theirs (the JAX gradient merge).

Buffers a forward updates in place (BatchNorm's running statistics) are
carried across steps as the JAX `Trainer` carries its buffer updates:
with one micro-batch, the step's forward updates them once; with N,
every micro-batch's forward starts from the buffers the step began with,
and the step ends with the update of the last micro-batch (the JAX
trainer keeps the last of its scan's updates).

The optimizer's LR scheduler, if it has one, is advanced after each
step's update (also under an explicit `lr=`), as the JAX `Trainer.step`
does. `state()` / `load_state()` use the JAX `Trainer.state()` tree:
`{"params": {name: array}, "opt_state": {"slots": {name: {slot:
array}}, "step": n}, "step": n}` under the model's parameter names, with
numpy leaves (bf16 tensors as float32 arrays, which is exact);
`models.convert.trainer_state_from_numpy` turns a JAX one into it. The
scheduler's state travels in the optimizer's `state_dict()`, as in JAX.
"""
import numpy as np
import torch

from ..device import get_device

__all__ = ["Trainer", "LossBuffer"]


class LossBuffer:
    """Holds unfetched step losses and fetches them all in one host sync
    once `drain_every` steps are pending (or on `drain()`), so the host
    keeps running ahead of the card. `fetches` counts the syncs."""

    def __init__(self, drain_every=16):
        self.drain_every = max(1, int(drain_every))
        self._pending = []
        self.losses = []
        self.fetches = 0

    def append(self, loss):
        self._pending.append(loss.reshape(-1))
        if sum(t.numel() for t in self._pending) >= self.drain_every:
            self.drain()
        return self

    @property
    def last(self):
        return self.losses[-1] if self.losses else None

    def drain(self):
        """Fetch every pending loss in one sync; returns the latest."""
        if self._pending:
            vals = torch.cat(self._pending).float().cpu().tolist()
            self.fetches += 1
            self.losses.extend(vals)
            self._pending = []
        return self.last


class Trainer:
    """trainer = Trainer(model, optimizer, loss_fn)   # loss_fn(model, batch)
    loss = trainer.step(batch)   # batch: dict of arrays or tensors

    The model's parameters are updated in place. `device=None` means the
    card (and raises without one); the model must already live there.
    The positional parameters are the JAX `Trainer`'s: the port has no
    mesh (`mesh` raises), updates in place (`donate` changes nothing),
    ignores `batch_spec` without a mesh, and raises on a
    `grad_transform` or a `dp_overlap` other than "off"."""

    def __init__(self, model, optimizer, loss_fn, mesh=None, donate=True,
                 grad_accum_steps=1, grad_transform=None,
                 batch_spec=("dp", "fsdp"), dp_overlap="off",
                 dp_overlap_buckets=2, *, device=None):
        if mesh is not None:
            raise NotImplementedError("Trainer(mesh=...) is not ported "
                                      "(ROADMAP.md queue 1, item 7)")
        if dp_overlap not in ("off", "bulk", "ring"):
            raise ValueError(f"dp_overlap must be 'off', 'bulk' or "
                             f"'ring', got {dp_overlap!r}")
        if grad_transform is not None or dp_overlap != "off":
            raise NotImplementedError(
                "Trainer's grad_transform and dp_overlap are not ported "
                "(ROADMAP.md queue 1, item 5)")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.device = get_device(device)
        self.grad_accum_steps = int(grad_accum_steps)
        self.params = [p for p in model.parameters() if p.requires_grad]
        for p in self.params:
            if p.device.type != self.device.type:
                raise ValueError(f"model parameters are on {p.device}, the "
                                 f"trainer on {self.device}")
        if optimizer._parameter_list is None:
            optimizer.bind(self.params)
        self._names = [n for n, p in model.named_parameters()
                       if p.requires_grad]
        self._host_step = 0

    def _to_device(self, batch):
        def put(v):
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            return v.to(self.device, non_blocking=True)
        return {k: put(v) for k, v in batch.items()}

    def _loss_and_grads(self, batch):
        loss = self.loss_fn(self.model, batch).float()
        return loss.detach(), torch.autograd.grad(loss, self.params)

    def step(self, batch, lr=None):
        """One training step; returns the f32 loss, unfetched."""
        batch = self._to_device(batch)
        n = self.grad_accum_steps
        if n <= 1:
            loss, grads = self._loss_and_grads(batch)
        else:
            micro = {k: v.chunk(n, dim=0) for k, v in batch.items()}
            if any(len(c) != n or c[0].shape[0] * n != v.shape[0]
                   for c, v in zip(micro.values(), batch.values())):
                raise ValueError(f"batch does not split into {n} equal "
                                 "micro-batches")
            bufs = list(self.model.buffers())
            start = [b.clone() for b in bufs]
            loss, grads = 0.0, None
            for i in range(n):
                if i:
                    with torch.no_grad():
                        for b, b0 in zip(bufs, start):
                            b.copy_(b0)
                lv, g = self._loss_and_grads(
                    {k: c[i] for k, c in micro.items()})
                loss = loss + lv
                grads = ([x.float() for x in g] if grads is None else
                         [a + b for a, b in zip(grads, g)])
            loss = loss / n
            grads = [g / n for g in grads]
        self._update(grads, lr)
        sched = self.optimizer._lr_scheduler
        if sched is not None:
            sched.step()
        self._host_step += 1
        return loss

    def _update(self, grads, lr=None):
        """The clip and the optimizer update of one step, the clip seeing
        the parameters' dotted names."""
        self.optimizer._apply_named(self._names, self.params, grads, lr)

    def sync_to_model(self):
        """The JAX trainer copies its parameters and buffers back into
        the model here; the port trains the model's own tensors in place,
        so the model is always current."""

    def state(self):
        """Host snapshot of the training state in the JAX layout (see
        the module doc): the parameters, the optimizer's slots (created
        if no step has run yet, as JAX creates them with the trainer) and
        step counts."""
        opt = self.optimizer
        return {
            "params": {n: _host(p) for n, p in zip(self._names,
                                                    self.params)},
            "opt_state": {
                "slots": {n: {k: _host(v) for k, v in opt._slots(p).items()}
                          for n, p in zip(self._names, self.params)},
                "step": int(opt._step_count)},
            "step": self._host_step}

    @torch.no_grad()
    def load_state(self, state):
        """Restore a `state()` (numpy arrays or tensors): parameters and
        slots are written in place on the trainer's device, each in its
        live tensor's dtype (a bf16 slot stays bf16)."""
        from ..models.convert import _tensor
        if "gt_state" in state:
            raise NotImplementedError("grad_transform state is not ported")

        def put(dst, v, name):
            v = v if isinstance(v, torch.Tensor) else _tensor(v, copy=False)
            if tuple(v.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(v.shape)}, the "
                                 f"trainer's {tuple(dst.shape)}")
            dst.copy_(v.to(self.device, dst.dtype))

        params, slots = state["params"], state["opt_state"]["slots"]
        if set(params) != set(self._names) or set(slots) != set(self._names):
            raise KeyError("the state's parameter names differ from the "
                           "model's")
        opt = self.optimizer
        for n, p in zip(self._names, self.params):
            put(p, params[n], n)
            live = opt._slots(p)
            if set(slots[n]) != set(live):
                raise KeyError(f"{n}: slots {sorted(slots[n])}, the "
                               f"optimizer's {sorted(live)}")
            for k, v in slots[n].items():
                put(live[k], v, f"{n}.{k}")
        opt._step_count = int(np.asarray(state["opt_state"]["step"]))
        self._host_step = int(state.get("step", 0))


def _host(t):
    """A numpy copy of a tensor on the host; bf16 widens to float32
    there, exactly (numpy has no bfloat16)."""
    t = t.detach()
    h = t.cpu() if t.is_cuda else t.clone()
    return (h.float() if h.dtype == torch.bfloat16 else h).numpy()
