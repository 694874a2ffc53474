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
    card (and raises without one); the model must already live there."""

    def __init__(self, model, optimizer, loss_fn, device=None,
                 grad_accum_steps=1):
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
        self.optimizer.apply_gradients(self.params, grads, lr)
        return loss
