"""Training steps of Ronneberger's U-Net: `segmentation.make_seg_train_step`
over a device-held set of images and ROI masks, as `fit_segmentation`
feeds it.

Traffic ("kind": "seg_train"): `samples` (the training set, made on the
card from the seed), `batch`, `source_hw` (the side of the synthetic
mammograms before their area resize to the configuration's `image_hw`),
`lesions` and `lesion_share` (the least and most ellipses an image, and
the least and most share of it they cover), `steps_ahead` (steps
enqueued before the host waits for the oldest of them), `checked_steps`
(the steps from set-up that the reference follows), `profile_units`
(steps in the traced window). Each epoch takes a fresh permutation from
a numpy generator seeded by the seed; a tail batch wraps to the start of
the epoch's permutation, as `fit_segmentation` does, so every step has
`batch` real samples.

The feed never waits on the card: an epoch's row indices go to the card
in one copy from pinned memory, and the host waits only for the step
`steps_ahead` back, outside the `enqueue` span.

Set-up builds one model and Adam state from the seeded weights and
drives them through the first `checked_steps` steps of the first epoch
(rows that all differ), through the window's own call and feed; the
window then continues the same object. `correct` compares those steps
with the plain reference (`reference/unet.py`): each step's loss, the
first gradient (from Adam's first moment after one step) and each leaf's
change after the checked steps, by the worst leaf.

End to end: `train_samples_per_s`, the samples of every step of the
window over the window.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from harness import synthetic, unet_counting
from harness.cell import Base
from harness.reference import model as ref_model
from harness.reference import unet as ref_unet

# leaves whose reference gradient is under this share of the median
# leaf's are moved by Adam's round-off alone, and are left out of the
# change's comparison
NOUGHT_GRAD = 1e-3
CHUNK = 16   # images made at once


def init_params(gen: torch.Generator, cfg: dict) -> dict:
    """Seeded weights by the port's names, on the generator's device: 3x3
    convs He-normal over 9 Cin, up-convolutions He-normal over Cin (one
    tap an output), the 1x1 head Glorot-uniform, zero biases."""
    dev = gen.device
    out = {}
    for name, shape in ref_unet.param_shapes(cfg):
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=dev)
        elif name.startswith("head."):
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * limit
        else:
            fan_in = shape[0] if name.startswith("up.") else shape[1] * 9
            out[name] = torch.randn(shape, generator=gen, device=dev) * math.sqrt(2.0 / fan_in)
    return out


def port_unet(params: dict, cfg: dict):
    """The port's `UNet` over clones of the benchmark's weights. Raises
    where the port has no up-convolution: the nearest decoder is another
    network."""
    from cadx_tpu_torch.models import unet

    if "up" not in {f.name for f in dataclasses.fields(unet.UNetConfig)}:
        raise RuntimeError("the port's UNetConfig has no `up`: it cannot build Ronneberger's "
                           "decoder")
    p = {k: v.clone() for k, v in params.items()}
    config = unet.UNetConfig(in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
                             features=tuple(cfg["features"]),
                             final_activation=cfg["final_activation"], up=cfg["up"])

    def conv(name):
        return unet.Conv(p[name + ".weight"], p[name + ".bias"])

    def double(prefix):
        return unet.DoubleConv(conv(prefix + ".conv1"), conv(prefix + ".conv2"))

    levels = len(cfg["features"]) - 1
    model = unet.UNet(config, [double(f"enc.{i}") for i in range(levels)], double("bottleneck"),
                      [double(f"dec.{i}") for i in range(levels)], conv("head"),
                      [unet.UpConv(p[f"up.{i}.weight"], p[f"up.{i}.bias"])
                       for i in range(levels)])
    names = [n for n, _ in model.named_parameters()]
    if names != list(params):
        raise RuntimeError(f"the port's U-Net names its parameters {names}, not {list(params)}")
    return model


def make_data(gen: torch.Generator, n: int, hw: int, source_hw: int, lesions, share):
    """(X (n, hw, hw, 1) images in [0, 1], Y (n, hw, hw, 1) binary masks) on
    the generator's device: synthetic mammograms area-resized to hw^2, and
    1-3 ellipses an image (centres in the breast, axes at a ratio of 1/2 to
    2, any angle) covering `share` of it between them, the image brightened
    inside."""
    dev = gen.device
    k = lesions[1]
    yy = torch.arange(hw, device=dev, dtype=torch.float32).view(1, 1, hw, 1)
    xx = torch.arange(hw, device=dev, dtype=torch.float32).view(1, 1, 1, hw)
    X = torch.empty((n, hw, hw, 1), device=dev)
    Y = torch.empty((n, hw, hw, 1), device=dev)
    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        img = synthetic.mammograms(m, source_hw, gen).to(torch.float32)
        img = F.interpolate(img[:, None], size=(hw, hw), mode="area")[:, 0] / 255.0
        count = torch.randint(lesions[0], k + 1, (m, 1), generator=gen, device=dev)
        total = share[0] + (share[1] - share[0]) * torch.rand((m, 1), generator=gen, device=dev)
        u = torch.rand((m, k, 4), generator=gen, device=dev)
        area = total / count * hw * hw                      # each ellipse's pixels
        ratio = 2.0 ** (2 * u[..., 0] - 1)
        ra, rb = (area * ratio / math.pi).sqrt(), (area / (ratio * math.pi)).sqrt()
        cy, cx = hw * (0.3 + 0.4 * u[..., 1]), hw * (0.6 + 0.15 * u[..., 2])
        ang = math.pi * u[..., 3]
        c, s = ang.cos()[..., None, None], ang.sin()[..., None, None]
        dy, dx = yy - cy[..., None, None], xx - cx[..., None, None]
        inside = (((dx * c + dy * s) / ra[..., None, None]) ** 2
                  + ((dy * c - dx * s) / rb[..., None, None]) ** 2) <= 1.0
        used = torch.arange(k, device=dev).view(1, k) < count
        mask = (inside & used[..., None, None]).any(dim=1).to(torch.float32)
        X[i:i + m, ..., 0] = img + 0.5 * (1.0 - img) * mask
        Y[i:i + m, ..., 0] = mask
    return X, Y


class Cell(Base):
    def setup(self) -> None:
        from cadx_tpu_torch.train import optim, segmentation

        t, tr = self.traffic, self.cfg["training"]
        self.b, self.n_samples = t["batch"], t["samples"]
        self.params0 = init_params(self.generator(0), self.cfg)
        self.model = port_unet(self.params0, self.cfg)
        self.tx = optim.Adam(lr=tr["lr"], b1=tr["b1"], b2=tr["b2"], eps=tr["eps"])
        self.opt_state = self.tx.init(list(self.model.parameters()))
        self.step_fn = segmentation.make_seg_train_step(self.tx)
        self.mark("port and weights")
        self.X, self.Y = make_data(self.generator(1), self.n_samples, self.cfg["image_hw"],
                                   t["source_hw"], t["lesions"], t["lesion_share"])
        self.mark("inputs")
        self.host_rng = np.random.default_rng(self.ctx.seed)
        self.per_epoch = -(-self.n_samples // self.b)
        self.batches: list = []
        self.inflight: collections.deque = collections.deque()
        self.samples = 0
        # the checked steps: they also warm up the window's one shape
        self.checked = []
        for i in range(t["checked_steps"]):
            xb, yb = self._batch()
            loss = self._step(xb, yb)
            if i == 0:
                self.mu1 = {n: m.clone() for (n, _), m in
                            zip(self.model.named_parameters(), self.opt_state.mu)}
            self.checked.append((xb, yb, loss))
        self.after = {n: q.detach().clone() for n, q in self.model.named_parameters()}
        self.samples = 0

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
        return self.X.index_select(0, idx_t), self.Y.index_select(0, idx_t)

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
        return unet_counting.train_step_flops(self.cfg, self.b)

    def release(self) -> None:
        self.model = self.opt_state = self.X = self.Y = None
        self.batches = []
        self.inflight.clear()

    def reference(self, p=ref_model.FP32, half_batch: bool = False) -> dict:
        """The checked steps, computed plainly from the same weights and
        rows: losses, the first gradients, the leaves after the last step.
        `half_batch` leaves the second half of each batch out (a fault the
        comparison must reject)."""
        tr = self.cfg["training"]
        params = {k: v.clone() for k, v in self.params0.items()}
        names, leaves = list(params), list(params.values())
        mu = [torch.zeros_like(q) for q in leaves]
        nu = [torch.zeros_like(q) for q in leaves]
        losses, g1 = [], None
        keep = self.b // 2 if half_batch else self.b
        with p.scope():
            for i, (xb, yb, _) in enumerate(self.checked):
                x = xb[:keep].permute(0, 3, 1, 2).contiguous()
                y = yb[:keep].permute(0, 3, 1, 2).contiguous()
                with torch.enable_grad():
                    for q in leaves:
                        q.requires_grad_(True)
                    loss = ref_unet.dice_bce_loss(params, self.cfg, x, y, p)
                    grads = torch.autograd.grad(loss, leaves)
                for q in leaves:
                    q.requires_grad_(False)
                ref_model.adam_step(leaves, grads, mu, nu, i + 1, tr["lr"], tr["b1"],
                                    tr["b2"], tr["eps"])
                losses.append(float(loss.detach()))
                if i == 0:
                    g1 = dict(zip(names, (g.detach() for g in grads)))
                del loss, grads
        return {"losses": losses, "grads": g1, "after": params}

    def got(self) -> dict:
        b1 = self.cfg["training"]["b1"]
        return {"losses": [float(c[2]) for c in self.checked],
                "grads": {n: m / (1 - b1) for n, m in self.mu1.items()}, "after": self.after}

    def judge(self, got: dict, ref: dict) -> dict:
        before = self.params0
        names = list(before)
        gr = [float(ref["grads"][n].norm()) for n in names]
        gp = [float(got["grads"][n].norm()) for n in names]
        g_med = statistics.median(gr)
        grad_gap = max(abs(a - b) / max(b, g_med) for a, b in zip(gp, gr))
        moved = [n for n, g in zip(names, gr) if g >= NOUGHT_GRAD * g_med]
        dr = [float((ref["after"][n] - before[n]).norm()) for n in moved]
        dp = [float((got["after"][n] - before[n]).norm()) for n in moved]
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
