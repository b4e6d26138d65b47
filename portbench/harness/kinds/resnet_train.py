"""Training steps of a ResNet whole-image classifier:
`classifier.make_resnet_train_step` over a device-held set of mammograms and
labels, as `fit_resnet` feeds it.

Traffic ("kind": "resnet_train"): `samples` (the training set, made on the
card from the seed), `batch`, `source_hw` (the side of the synthetic
mammograms before their area resize to the configuration's `image_hw`),
`lesions` and `lesion_share` (the least and most bright ellipses a label-1
image carries, and the least and most share of it they cover),
`steps_ahead` (steps enqueued before the host waits for the oldest of
them), `checked_steps` (the steps from set-up that the reference follows),
`profile_units` (steps in the traced window). Labels are balanced, half of
each class, in an order drawn from the seed. Each epoch takes a fresh
permutation from a numpy generator seeded by the seed; a tail batch wraps
to the start of the epoch's permutation, as `fit_resnet` does, so every
step has `batch` samples.

The feed never waits on the card: an epoch's row indices go to the card
in one copy from pinned memory, and the host waits only for the step
`steps_ahead` back, outside the `enqueue` span.

Set-up builds one model and Adam state from the seeded weights and
drives them through the first `checked_steps` steps of the first epoch,
through the window's own call and feed, keeping the state (parameters,
Adam's moments, running statistics) before each of them and after the
last; the window then continues the same object. `correct` holds each
checked step to the plain reference (`reference/resnet.py`) taken from the
program's own state before it: the step's loss, its gradient (from Adam's
moments before and after it), each leaf's change and each batch norm's
running statistics after it, by the worst step, leaf and batch norm; and
the program's Adam state after each step against Adam's own arithmetic on
the program's gradient: its second moment (the worst leaf) and its count
(the step's number). Each step starts where the program's did because ResNet-50's float32 backward
amplifies rounding (each of 53 batch-norm backwards subtracts its means):
at 1152x896, B=16 the program's first gradients and the float32
reference's both lie 0.5-1.1% from a float64 run's (the worst leaf's norm
against the median leaf's), Adam's first step makes each element +-lr
whatever its gradient's size, and three chained steps from the same
weights then part by percents in the loss.

End to end: `train_samples_per_s`, the samples of every step of the
window over the window.
"""

from __future__ import annotations

import collections
import math
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from harness import resnet_counting, synthetic
from harness.cell import Base
from harness.reference import model as ref_model
from harness.reference import resnet as ref_resnet

# leaves whose reference gradient is under this share of the median
# leaf's are moved by Adam's round-off alone, and are left out of the
# change's comparison
NOUGHT_GRAD = 1e-3
CHUNK = 16   # images made at once


def init_params(gen: torch.Generator, cfg: dict) -> dict:
    """Seeded weights by the port's names, on the generator's device, as
    the port's `init_resnet` draws them: convs He-normal over their fan-in
    (std sqrt(2 / (k^2 Cin))), batch norms at weight 1 and bias 0, the fc
    uniform in +-1/sqrt(C) with a zero bias."""
    dev = gen.device
    out = {}
    for name, shape in ref_resnet.param_shapes(cfg):
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            out[name] = torch.randn(shape, generator=gen, device=dev) * math.sqrt(2.0 / fan_in)
        elif name == "fc.weight":
            limit = 1.0 / math.sqrt(shape[1])
            out[name] = (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * limit
        elif name.endswith(".weight"):
            out[name] = torch.ones(shape, device=dev)
        else:
            out[name] = torch.zeros(shape, device=dev)
    return out


def port_resnet(params: dict, cfg: dict):
    """The port's `ResNet` over clones of the benchmark's weights, its
    running statistics as BatchNorm2d starts them. Raises where the port
    cannot train it (no `train_logits`) or trains its batch norms at
    another momentum or eps than the configuration's."""
    from cadx_tpu_torch.kernels import batchnorm
    from cadx_tpu_torch.models import resnet

    if not hasattr(resnet, "train_logits"):
        raise RuntimeError("the port's resnet has no train_logits: it cannot train a ResNet")
    bn = cfg["batch_norm"]
    if (bn["momentum"], bn["eps"]) != (batchnorm.MOMENTUM, batchnorm.EPS):
        raise RuntimeError(f"the port trains batch norms at momentum {batchnorm.MOMENTUM}, eps "
                           f"{batchnorm.EPS}, not the configuration's {bn}")
    config = resnet.ResNetConfig(block=cfg["block"], layers=tuple(cfg["layers"]),
                                 widths=tuple(cfg["widths"]), in_channels=cfg["in_channels"],
                                 num_classes=cfg["num_classes"])
    dev = next(iter(params.values())).device
    model = resnet.ResNet(config).to(dev)
    names = [n for n, _ in model.named_parameters()]
    if names != list(params):
        raise RuntimeError(f"the port's ResNet names its parameters {names[:4]}..., not "
                           f"{list(params)[:4]}...")
    with torch.no_grad():
        for (_, p), v in zip(model.named_parameters(), params.values()):
            p.copy_(v)
    return model


def make_data(gen: torch.Generator, n: int, hw, source_hw: int, lesions, share):
    """(X (n, h, w, 1) images in [0, 1], y (n,) int64 labels) on the
    generator's device: synthetic mammograms area-resized to hw; labels
    half 0 and half 1 in a seeded order; each label-1 image brightened
    inside 1-3 ellipses (centres in the breast, axes at a ratio of 1/2 to
    2, any angle) covering `share` of it between them."""
    dev = gen.device
    h, w = hw
    k = lesions[1]
    y = (torch.randperm(n, generator=gen, device=dev) < n // 2).to(torch.int64)
    yy = torch.arange(h, device=dev, dtype=torch.float32).view(1, 1, h, 1)
    xx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, 1, w)
    X = torch.empty((n, h, w, 1), device=dev)
    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        img = synthetic.mammograms(m, source_hw, gen).to(torch.float32)
        img = F.interpolate(img[:, None], size=(h, w), mode="area")[:, 0] / 255.0
        count = torch.randint(lesions[0], k + 1, (m, 1), generator=gen, device=dev)
        total = share[0] + (share[1] - share[0]) * torch.rand((m, 1), generator=gen, device=dev)
        u = torch.rand((m, k, 4), generator=gen, device=dev)
        area = total / count * h * w                        # each ellipse's pixels
        ratio = 2.0 ** (2 * u[..., 0] - 1)
        ra, rb = (area * ratio / math.pi).sqrt(), (area / (ratio * math.pi)).sqrt()
        cy, cx = h * (0.3 + 0.4 * u[..., 1]), w * (0.6 + 0.15 * u[..., 2])
        ang = math.pi * u[..., 3]
        c, s = ang.cos()[..., None, None], ang.sin()[..., None, None]
        dy, dx = yy - cy[..., None, None], xx - cx[..., None, None]
        inside = (((dx * c + dy * s) / ra[..., None, None]) ** 2
                  + ((dy * c - dx * s) / rb[..., None, None]) ** 2) <= 1.0
        used = torch.arange(k, device=dev).view(1, k) < count
        mask = (inside & used[..., None, None]).any(dim=1).to(torch.float32)
        mask = mask * y[i:i + m].view(m, 1, 1).to(torch.float32)
        X[i:i + m, ..., 0] = img + 0.5 * (1.0 - img) * mask
    return X, y


class Cell(Base):
    def setup(self) -> None:
        from cadx_tpu_torch.train import classifier, optim

        t, tr = self.traffic, self.cfg["training"]
        self.b, self.n_samples = t["batch"], t["samples"]
        self.params0 = init_params(self.generator(0), self.cfg)
        self.model = port_resnet(self.params0, self.cfg)
        self.tx = optim.Adam(lr=tr["lr"], b1=tr["b1"], b2=tr["b2"], eps=tr["eps"])
        self.opt_state = self.tx.init(list(self.model.parameters()))
        self.step_fn = classifier.make_resnet_train_step(self.tx)
        self.mark("port and weights")
        self.X, self.y = make_data(self.generator(1), self.n_samples, self.cfg["image_hw"],
                                   t["source_hw"], t["lesions"], t["lesion_share"])
        self.mark("inputs")
        self.host_rng = np.random.default_rng(self.ctx.seed)
        self.per_epoch = -(-self.n_samples // self.b)
        self.batches: list = []
        self.inflight: collections.deque = collections.deque()
        self.samples = 0
        # the checked steps: they also warm up the window's one shape
        self.checked, self.states = [], [self._state()]
        for _ in range(t["checked_steps"]):
            xb, yb = self._batch()
            loss = self._step(xb, yb)
            self.checked.append((xb, yb, loss))
            self.states.append(self._state())
        self.samples = 0

    def _state(self) -> dict:
        """Copies of the program's parameters, Adam's moments and count, and
        running statistics, by the port's names."""
        names = [n for n, _ in self.model.named_parameters()]
        st = self.opt_state
        return {"params": {n: q.detach().clone() for n, q in self.model.named_parameters()},
                "mu": dict(zip(names, (m.clone() for m in st.mu))),
                "nu": dict(zip(names, (v.clone() for v in st.nu))), "count": st.count,
                "stats": {n: t.clone() for n, t in self.model.named_buffers()
                          if not n.endswith("num_batches_tracked")}}

    def _batch(self):
        if not self.batches:
            perm = self.host_rng.permutation(self.n_samples)
            idx = np.concatenate([perm, perm[:self.per_epoch * self.b - self.n_samples]])
            idx_t = torch.from_numpy(idx).view(self.per_epoch, self.b)
            if self.device.type == "cuda":
                idx_t = idx_t.pin_memory()
            self.epoch_idx = idx_t.to(self.device, non_blocking=True)
            self.batches = list(range(self.per_epoch))[::-1]
        idx_t = self.epoch_idx[self.batches.pop()]
        return self.X.index_select(0, idx_t), self.y.index_select(0, idx_t)

    def _step(self, xb, yb):
        with self.span("enqueue"):
            self.opt_state, loss = self.step_fn(self.model, self.opt_state, xb, yb)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            self.inflight.append(done)
        self.samples += self.b
        return loss

    def unit(self) -> None:
        while len(self.inflight) >= self.traffic["steps_ahead"]:
            self.inflight.popleft().synchronize()
        self._step(*self._batch())
        self.attempted += 1

    def finish(self) -> None:
        self.inflight.clear()
        super().finish()

    def end_to_end(self, window_s: float) -> dict:
        return {"train_samples_per_s": self.samples / window_s}

    def model_flops_per_unit(self) -> float:
        return resnet_counting.train_step_flops(self.cfg, self.b)

    def work(self, units: int) -> dict:
        return {"bn_train": units * resnet_counting.bn_train_bound_s(self.cfg, self.b)}

    def release(self) -> None:
        self.model = self.opt_state = self.X = self.y = None
        self.batches = []
        self.inflight.clear()

    def reference(self, p=ref_model.FP32, half_batch: bool = False) -> dict:
        """Each checked step computed plainly from the program's state
        before it, on the same rows: its loss, gradients, and the leaves
        and running statistics after it. `half_batch` leaves the second
        half of each batch out (a fault the comparison must reject)."""
        tr = self.cfg["training"]
        keep = self.b // 2 if half_batch else self.b
        losses, grads_, after, stats_ = [], [], [], []
        with p.scope():
            for (xb, yb, _), state in zip(self.checked, self.states):
                params = {k: v.clone() for k, v in state["params"].items()}
                stats = {k: v.clone() for k, v in state["stats"].items()}
                leaves = list(params.values())
                x = xb[:keep].permute(0, 3, 1, 2).contiguous()
                with torch.enable_grad():
                    for q in leaves:
                        q.requires_grad_(True)
                    loss = ref_resnet.cross_entropy_loss(params, stats, self.cfg, x, yb[:keep],
                                                         p)
                    grads = torch.autograd.grad(loss, leaves)
                for q in leaves:
                    q.requires_grad_(False)
                mu = [v.clone() for v in state["mu"].values()]
                nu = [v.clone() for v in state["nu"].values()]
                ref_model.adam_step(leaves, grads, mu, nu, state["count"] + 1, tr["lr"],
                                    tr["b1"], tr["b2"], tr["eps"])
                losses.append(float(loss.detach()))
                grads_.append(dict(zip(params, (g.detach() for g in grads))))
                after.append(params)
                stats_.append(stats)
                del loss, grads, mu, nu
        return {"losses": losses, "grads": grads_, "after": after, "stats": stats_}

    def got(self) -> dict:
        """The program's checked steps: losses, gradients (from Adam's first
        moment before and after each step), and the states after them."""
        b1 = self.cfg["training"]["b1"]
        grads = [{n: (post["mu"][n] - b1 * pre["mu"][n]) / (1 - b1) for n in pre["mu"]}
                 for pre, post in zip(self.states, self.states[1:])]
        return {"losses": [float(c[2]) for c in self.checked], "grads": grads,
                "after": [st["params"] for st in self.states[1:]],
                "stats": [st["stats"] for st in self.states[1:]]}

    def judge(self, got: dict, ref: dict) -> dict:
        """The worst over the checked steps of: the loss's relative gap; each
        leaf's gradient norm and change's norm against the reference's,
        over the larger of the reference's and the median leaf's (leaves
        whose reference gradient is under NOUGHT_GRAD of the median left out
        of the change's); each batch norm's running mean and variance, the
        distance to the reference's over the reference's move in the step,
        or the median batch norm's move where that is larger."""
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        grad_gap = update_gap = stats_gap = 0.0
        for i, before in enumerate(self.states[:len(ref["losses"])]):
            names = list(before["params"])
            gr = [float(ref["grads"][i][n].norm()) for n in names]
            gp = [float(got["grads"][i][n].norm()) for n in names]
            g_med = statistics.median(gr)
            grad_gap = max(grad_gap, max(abs(a - b) / max(b, g_med) for a, b in zip(gp, gr)))
            moved = [n for n, g in zip(names, gr) if g >= NOUGHT_GRAD * g_med]
            dr = [float((ref["after"][i][n] - before["params"][n]).norm()) for n in moved]
            dp = [float((got["after"][i][n] - before["params"][n]).norm()) for n in moved]
            d_med = statistics.median(dr)
            update_gap = max(update_gap,
                             max(abs(a - b) / max(b, d_med) for a, b in zip(dp, dr)))
            for suffix in (".running_mean", ".running_var"):
                keys = [n + suffix for n in ref_resnet.batch_norms(self.cfg)]
                moves = [float((ref["stats"][i][k] - before["stats"][k]).norm()) for k in keys]
                m_med = statistics.median(moves)
                stats_gap = max(stats_gap, max(
                    float((got["stats"][i][k] - ref["stats"][i][k]).norm()) / max(mv, m_med)
                    for k, mv in zip(keys, moves)))
        return {"loss_rel_gap": loss_gap, "grad_norm_gap": grad_gap,
                "update_norm_gap": update_gap, "running_stats_gap": stats_gap}

    def adam_state_gap(self, got: dict) -> float:
        """The larger of: the worst leaf's second moment after a checked
        step against b2 nu + (1 - b2) g^2 of the moment before it and the
        program's gradient g (`got`'s), over the larger of that norm and the
        median leaf's; and the distance of Adam's count from the number of
        steps taken. So a lost or stale second moment or count fails it,
        though the re-anchored reference takes both from the program."""
        b2 = self.cfg["training"]["b2"]
        gap = max(abs(st["count"] - i) for i, st in enumerate(self.states))
        for pre, post, grads in zip(self.states, self.states[1:], got["grads"]):
            want = {n: b2 * pre["nu"][n] + (1 - b2) * grads[n] * grads[n] for n in pre["nu"]}
            norms = [float(w.norm()) for w in want.values()]
            med = statistics.median(norms)
            gap = max(gap, max(float((post["nu"][n] - w).norm()) / max(m, med)
                               for (n, w), m in zip(want.items(), norms)))
        return float(gap)

    def check(self):
        got = self.got()
        readings = self.judge(got, self.reference())
        readings["adam_state_gap"] = self.adam_state_gap(got)
        return [self.compared(k, v) for k, v in readings.items()]

    def control(self, variant: str) -> dict:
        """"tf32": the reference in TF32 in the program's place; "half_batch":
        the reference with half of each batch left out."""
        ref = self.reference()
        if variant == "tf32":
            return self.judge(self.reference(ref_model.TF32), ref)
        return self.judge(self.reference(half_batch=True), ref)
