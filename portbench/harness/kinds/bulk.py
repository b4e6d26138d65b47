"""Bulk scoring: `pipeline.fused.run_pipeline` over batches of screening
crops, every batch cleaned, classified and explained.

Traffic ("kind": "bulk"): `image_hw`, `batch`, `pool_batches` (a seeded
pool of batches in pinned host memory, staged to the card batch after
batch in turn), `in_flight` (batches enqueued before the oldest one's
probabilities and classes are fetched), `classes_to_explain`,
`feature_dtype`, `check_batches` (batches of the window whose outputs
are kept and judged, drawn from the seed among the first `check_within`),
`profile_units` (batches in the traced window).

End to end: `bulk_img_per_s`, every image of the window completed (its
fetch returned) over the window, the drain of the last batches included.
"""

from __future__ import annotations

import collections

import torch

from harness import counting, synthetic
from harness.cell import (Base, init_cnn, init_conv1, port_cnn, port_cnn_config,
                          rel_err)
from harness.reference import cleaner as ref_cleaner
from harness.reference import model as ref_model
from harness.reference.resize import resize_linear


def median_diff_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The median over (image, class) of the share of an explanation's
    pixels that differ. A random classifier leaves some images' CAMs all
    but zero (the ReLU of sums that cancel to ~1e-10), and min-max
    normalising such a CAM turns float32 round-off into whole heatmaps;
    the median image is well conditioned and reads the same from seed to
    seed."""
    d = (got != ref).reshape(got.shape[0] * got.shape[1], -1).to(torch.float64)
    return float(d.mean(dim=1).median())


class Cell(Base):
    def setup(self) -> None:
        from cadx_tpu_torch.models import unet
        from cadx_tpu_torch.pipeline import fused

        t = self.traffic
        self.fused = fused
        self.clf_cfg = self.cfg["classifier"]
        self.b, self.hw = t["batch"], t["image_hw"]
        self.pcfg = fused.PipelineConfig(
            image_hw=(self.hw, self.hw), feature_hw=tuple(self.clf_cfg["input_shape"][:2]),
            classes_to_explain=tuple(t["classes_to_explain"]),
            feature_dtype=t["feature_dtype"],
            classifier=port_cnn_config(self.clf_cfg))
        wgen = self.generator(0)
        self.conv1_w = init_conv1(wgen)
        self.params = init_cnn(wgen, self.clf_cfg)
        self.port_params = fused.PipelineParams(
            encoder=unet.ResNetStem(self.conv1_w.clone()),
            classifier=port_cnn(self.params, self.clf_cfg))
        self.mark("port and weights")
        imgs = synthetic.mammograms(t["pool_batches"] * self.b, self.hw, self.generator(1))
        self.pool = imgs.view(t["pool_batches"], self.b, self.hw, self.hw).cpu()
        if self.device.type == "cuda":
            self.pool = self.pool.pin_memory()
        self.mark("inputs")
        self.check_at = self.draw_checked(t["check_within"], t["check_batches"])
        self.kept: dict[int, tuple] = {}
        self.inflight: collections.deque = collections.deque()
        self.window_batches = 0
        self.completed = 0
        for j in range(2):                       # warm up the window's one shape
            self._enqueue(j, record=False)
        self.finish()
        self.completed = 0

    def _enqueue(self, j: int, record: bool = True) -> None:
        """Stage pool batch j, enqueue the pipeline and its fetch."""
        x = self.pool[j].to(self.device, non_blocking=True)
        with self.span("enqueue"):
            out = self.fused.run_pipeline(self.port_params, x, self.pcfg)
        fetched = torch.cat([out.probs, out.predicted[:, None].to(out.probs.dtype)], dim=1)
        host = fetched.to("cpu", non_blocking=self.device.type == "cuda")
        done = torch.cuda.Event() if self.device.type == "cuda" else None
        if done is not None:
            done.record()
        if record:
            if self.window_batches in self.check_at:
                self.kept[self.window_batches] = (j, out, host)
            self.window_batches += 1
            self.attempted += self.b
        self.inflight.append((host, done))

    def _harvest(self) -> None:
        host, done = self.inflight.popleft()
        if done is not None:
            done.synchronize()
        self.completed += host.shape[0]

    def unit(self) -> None:
        self._enqueue(self.window_batches % len(self.pool))
        while len(self.inflight) >= self.traffic["in_flight"]:
            self._harvest()

    def finish(self) -> None:
        while self.inflight:
            self._harvest()
        super().finish()

    def end_to_end(self, window_s: float) -> dict:
        return {"bulk_img_per_s": self.completed / window_s}

    def work(self, units: int) -> dict:
        # the pipeline runs the conv stack twice a batch: the forward and
        # Grad-CAM's activations
        return {"conv_leaky": 2 * units * counting.conv_leaky_bound_s(self.clf_cfg, self.b)}

    def model_flops_per_unit(self) -> float:
        return self.b * counting.bulk_model_flops(
            self.clf_cfg, self.hw, len(self.traffic["classes_to_explain"]))

    def release(self) -> None:
        self.port_params = None
        self.inflight.clear()

    def reference(self, raw_u8: torch.Tensor, p=ref_model.FP32):
        """The pipeline's outputs for one batch, computed plainly."""
        cfg = self.clf_cfg
        with p.scope(), torch.no_grad():
            clean01 = ref_cleaner.clean_boundary_gray(raw_u8) / 255.0
            feats = ref_model.conv1(self.conv1_w, clean01, p)
            feats = feats.to(getattr(torch, self.traffic["feature_dtype"])).to(torch.float32)
            feats_small = resize_linear(feats, tuple(cfg["input_shape"][:2]))
            acts = ref_model.conv_stack(self.params, cfg, feats_small, p)
            logits = ref_model.head_logits(self.params, cfg, acts, p)
            probs = ref_model.softmax(logits)
            seeds = []
            for c in self.traffic["classes_to_explain"]:
                s = torch.zeros_like(logits)
                s[:, c] = 1.0
                seeds.append(s)
            overlays, heats = [], []
            for g in ref_model.class_grads(self.params, cfg, acts, seeds, p):
                ov, hm = ref_model.gradcam_tail(acts, g, clean01, (self.hw, self.hw), p)
                overlays.append(ov)
                heats.append(hm)
        return {"clean_u8": (clean01 * 255).to(torch.uint8), "features": feats_small,
                "probs": probs, "overlays": torch.stack(overlays, 1),
                "heatmaps": torch.stack(heats, 1)}

    def judge(self, got: dict, ref: dict) -> dict:
        """The compared numbers of one batch."""
        return {"clean_px_diff": float((got["clean_u8"] != ref["clean_u8"]).sum()),
                "feature_rel_err": rel_err(got["features"], ref["features"]),
                "prob_abs_err": float((got["probs"] - ref["probs"]).abs().max()),
                "class_vs_probs": float((got["predicted"] != got["probs"].argmax(-1)).sum()),
                "heatmap_median_diff_share": median_diff_share(got["heatmaps"], ref["heatmaps"]),
                "overlay_median_diff_share": median_diff_share(got["overlays"], ref["overlays"])}

    def check(self):
        worst: dict[str, float] = {}
        if len(self.kept) < len(self.check_at):
            worst["batches_missing"] = float(len(self.check_at) - len(self.kept))
        for _, (j, out, host) in sorted(self.kept.items()):
            ref = self.reference(self.pool[j].to(self.device))
            got = {"clean_u8": out.clean_u8, "features": out.features,
                   "probs": host[:, :-1].to(self.device),
                   "predicted": host[:, -1].to(self.device).to(torch.int64),
                   "heatmaps": out.heatmaps, "overlays": out.overlays}
            for k, v in self.judge(got, ref).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return [self.compared(k, v) for k, v in worst.items()]

    def control(self, variant: str) -> dict:
        """The compared numbers with the reference in `variant` ("tf32")
        put in the program's place, judged against the float32 reference."""
        worst: dict[str, float] = {}
        for _, (j, _out, _host) in sorted(self.kept.items()):
            x = self.pool[j].to(self.device)
            c = self.reference(x, ref_model.TF32)
            c["predicted"] = c["probs"].argmax(-1)
            for k, v in self.judge(c, self.reference(x)).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst
