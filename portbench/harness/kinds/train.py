"""Training steps of the advanced classifier: `train.step.make_adam_train_step`
over a device-held feature set, as `fit` feeds it.

Traffic ("kind": "train"): `samples` (the training set, made on the card
from the seed), `batch`, `steps_ahead` (steps enqueued before the host
waits for the oldest of them), `checked_steps` (the steps from set-up
that the reference follows), `profile_units` (steps in the traced
window). Each epoch takes a fresh permutation from a numpy generator
seeded by the seed; the last partial batch repeats sample 0 in its
padded rows and its mask drops them, as `fit` does. Dropout draws from a
device generator seeded by the seed.

The feed never waits on the card: an epoch's row indices go to the card
in one copy from pinned memory, the batches' masks are made there at
set-up, and the host waits only for the step `steps_ahead` back, outside
the `enqueue` span, so that a stall of the host does not leave the card
idle while steps are queued. (`fit` copies each batch's indices and
mask from pageable memory, which waits for the card at every step.)

Set-up builds one model and Adam state and drives them through the
first `checked_steps` steps of the first epoch (rows that all differ),
through the window's own call and feed; the window then continues the
same object. `correct` compares those steps with the plain reference:
each step's loss, the first gradient (from Adam's first moment after one
step) and each leaf's change after the checked steps, by the worst leaf.

End to end: `train_samples_per_s`, the real (unmasked) samples of every
step of the window over the window.
"""

from __future__ import annotations

import collections
import statistics

import numpy as np
import torch

from harness import counting
from harness.cell import Base, clone_params, init_cnn, port_cnn
from harness.reference import model as ref_model

# leaves whose reference gradient is under this share of the median
# leaf's are moved by Adam's round-off alone, and are left out of the
# change's comparison
NOUGHT_GRAD = 1e-3


class Cell(Base):
    def setup(self) -> None:
        from cadx_tpu_torch.train import optim, step

        t, tr = self.traffic, self.cfg["training"]
        self.clf_cfg = self.cfg["classifier"]
        self.b, self.n_samples = t["batch"], t["samples"]
        self.params0 = init_cnn(self.generator(0), self.clf_cfg)
        self.model = port_cnn(self.params0, self.clf_cfg)
        self.tx = optim.Adam(lr=tr["lr"], b1=tr["b1"], b2=tr["b2"], eps=tr["eps"])
        self.opt_state = self.tx.init(list(self.model.parameters()))
        self.step_fn = step.make_adam_train_step(self.tx)
        self.mark("port and weights")
        dgen = self.generator(1)
        h, w, c = self.clf_cfg["input_shape"]
        self.X = torch.randn((self.n_samples, h, w, c), generator=dgen, device=self.device)
        labels = torch.randint(0, self.clf_cfg["num_classes"], (self.n_samples,),
                               generator=dgen, device=self.device)
        self.Y = torch.nn.functional.one_hot(labels, self.clf_cfg["num_classes"]).to(torch.float32)
        self.mark("inputs")
        self.dropout_seed = (self.ctx.seed * 1000003 + 2) % (1 << 63)
        self.dropout = torch.Generator(device=self.device).manual_seed(self.dropout_seed)
        self.host_rng = np.random.default_rng(self.ctx.seed)
        self.batches: list = []
        self.per_epoch = -(-self.n_samples // self.b)
        self.counts = [min(self.b, self.n_samples - i) for i in range(0, self.n_samples, self.b)]
        masks = torch.zeros((self.per_epoch, self.b), dtype=torch.float32)
        for j, nb in enumerate(self.counts):
            masks[j, :nb] = 1.0
        self.masks = masks.to(self.device)
        self.inflight: collections.deque = collections.deque()
        self.samples = 0
        self.steps = 0
        # the checked steps: they also warm up the window's one shape
        self.checked = []
        for i in range(t["checked_steps"]):
            xb, yb, mb, nb = self._batch()
            loss = self._step(xb, yb, mb, nb)
            if i == 0:
                self.mu1 = {n: m.clone() for (n, _), m in
                            zip(self.model.named_parameters(), self.opt_state.mu)}
            self.checked.append((xb, yb, mb, loss))
        self.after = {n: q.detach().clone() for n, q in self.model.named_parameters()}
        self.samples = 0

    def _batch(self):
        if not self.batches:
            idx = np.zeros((self.per_epoch * self.b,), np.int64)
            idx[:self.n_samples] = self.host_rng.permutation(self.n_samples)
            idx_t = torch.from_numpy(idx).view(self.per_epoch, self.b)
            if self.device.type == "cuda":
                idx_t = idx_t.pin_memory()
            self.epoch_idx = idx_t.to(self.device, non_blocking=True)
            self.batches = list(range(self.per_epoch))[::-1]
        j = self.batches.pop()
        idx_t = self.epoch_idx[j]
        return (self.X.index_select(0, idx_t), self.Y.index_select(0, idx_t),
                self.masks[j], self.counts[j])

    def _step(self, xb, yb, mb, nb):
        with self.span("enqueue"):
            self.opt_state, loss = self.step_fn(self.model, self.opt_state, xb, yb, mb,
                                                self.dropout)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            self.inflight.append(done)
        self.samples += nb
        self.steps += 1
        return loss

    def unit(self) -> None:
        while len(self.inflight) >= self.traffic["steps_ahead"]:
            self.inflight.popleft().synchronize()
        xb, yb, mb, nb = self._batch()
        self._step(xb, yb, mb, nb)
        self.attempted += 1

    def finish(self) -> None:
        self.inflight.clear()
        super().finish()

    def end_to_end(self, window_s: float) -> dict:
        return {"train_samples_per_s": self.samples / window_s}

    def work(self, units: int) -> dict:
        return {"conv_leaky": units * counting.conv_leaky_bound_s(self.clf_cfg, self.b)}

    def model_flops_per_unit(self) -> float:
        """Model FLOPs of the real samples of an average step of an epoch."""
        steps_per_epoch = -(-self.n_samples // self.b)
        return counting.train_model_flops(self.clf_cfg) * self.n_samples / steps_per_epoch

    def release(self) -> None:
        self.model = self.opt_state = self.X = self.Y = None
        self.batches = []
        self.inflight.clear()

    def reference(self, p=ref_model.FP32, half_batch: bool = False) -> dict:
        """The checked steps, computed plainly from the same weights, rows
        and dropout draws: losses, the first gradients, the leaves after
        the last step. `half_batch` leaves the second half of each batch
        out (a fault the comparison must reject)."""
        cfg = self.clf_cfg
        tr = self.cfg["training"]
        params = clone_params(self.params0)
        names, leaves = zip(*ref_model.leaves(params).items())
        mu = [torch.zeros_like(q) for q in leaves]
        nu = [torch.zeros_like(q) for q in leaves]
        gen = torch.Generator(device=self.device).manual_seed(self.dropout_seed)
        losses, g1 = [], None
        with p.scope():
            for i, (xb, yb, mb, _) in enumerate(self.checked):
                uniforms = [torch.rand((self.b, u), generator=gen, device=self.device)
                            for u in cfg["hidden_units"]]
                if half_batch:
                    mb = mb.clone()
                    mb[self.b // 2:] = 0.0
                with torch.enable_grad():
                    for q in leaves:
                        q.requires_grad_(True)
                    loss = ref_model.masked_loss(params, cfg, xb, yb, mb, uniforms, p)
                    grads = torch.autograd.grad(loss, leaves)
                for q in leaves:
                    q.requires_grad_(False)
                ref_model.adam_step(leaves, grads, mu, nu, i + 1, tr["lr"], tr["b1"],
                                    tr["b2"], tr["eps"])
                losses.append(float(loss.detach()))
                if i == 0:
                    g1 = dict(zip(names, (g.detach() for g in grads)))
        return {"losses": losses, "grads": g1, "after": dict(zip(names, leaves))}

    def got(self) -> dict:
        b1 = self.cfg["training"]["b1"]
        return {"losses": [float(c[3]) for c in self.checked],
                "grads": {n: m / (1 - b1) for n, m in self.mu1.items()}, "after": self.after}

    def judge(self, got: dict, ref: dict) -> dict:
        before = ref_model.leaves(self.params0)
        names = list(before)
        gr = [float(ref["grads"][n].norm()) for n in names]
        gp = [float(got["grads"][n].norm()) for n in names]
        g_med = statistics.median(gr)
        grad_gap = max(abs(a - b) / max(b, g_med) for a, b in zip(gp, gr))
        moved = [n for n, g in zip(names, gr) if g >= NOUGHT_GRAD * g_med]
        dr = [float((ref["after"][i] - before[i]).norm()) for i in moved]
        dp = [float((got["after"][i] - before[i]).norm()) for i in moved]
        d_med = statistics.median(dr)
        update_gap = max(abs(a - b) / max(b, d_med) for a, b in zip(dp, dr))
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        return {"loss_rel_gap": loss_gap, "grad_norm_gap": grad_gap,
                "update_norm_gap": update_gap}

    def check(self):
        return [self.compared(k, v) for k, v in self.judge(self.got(), self.reference()).items()]

    def control(self, variant: str) -> dict:
        """"tf32": the reference in TF32 in the program's place; "half_batch":
        the reference with half of each batch left out."""
        ref = self.reference()
        if variant == "tf32":
            return self.judge(self.reference(ref_model.TF32), ref)
        return self.judge(self.reference(half_batch=True), ref)
