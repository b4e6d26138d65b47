"""The training CLI's featurize at native size: `tools.train.featurize`, one
full-field scan at a time (`clean_for_unet` with no cap, conv1, the
bilinear resize to the classifier's input), the features fetched.

Traffic ("kind": "featurize"): `shapes` (native (h, w) uint16 scans, the
pool cycling through them), `pool`, `check_images` (images of the window
judged, drawn from the seed among the first `check_within`),
`profile_units` (images in the traced window).

End to end: `featurize_img_per_s`, every image of the window over the
window. The path returns the features only; the cleaned image is judged
through them (one cleaned pixel off by a level moves the features by
some 1e-4 of their largest value).
"""

from __future__ import annotations

import numpy as np
import torch

from harness import counting, synthetic
from harness.cell import Base, init_conv1, rel_err
from harness.reference import cleaner as ref_cleaner
from harness.reference import model as ref_model
from harness.reference.resize import resize_linear


class Cell(Base):
    def setup(self) -> None:
        from cadx_tpu_torch.models import unet
        from cadx_tpu_torch.tools import train

        t = self.traffic
        self.featurize = train.featurize
        self.feature_hw = tuple(self.cfg["classifier"]["input_shape"][:2])
        self.conv1_w = init_conv1(self.generator(0))
        self.stem = unet.ResNetStem(self.conv1_w.clone())
        self.mark("port and weights")
        igen = self.generator(1)
        shapes = [tuple(s) for s in t["shapes"]]
        self.pool = [synthetic.native_mammogram(*shapes[i % len(shapes)], igen)
                     .cpu().numpy().astype(np.uint16) for i in range(t["pool"])]
        self.mark("inputs")
        self.check_at = self.draw_checked(t["check_within"], t["check_images"])
        self.kept: dict[int, tuple] = {}
        self.n = 0
        self.trace_inputs: list[int] | None = None
        for j in range(len(self.pool)):          # every shape the window uses
            self.featurize(self.stem, self.pool[j], self.feature_hw, self.device)

    def unit(self) -> None:
        k = self.n
        self.n += 1
        j = k % len(self.pool)
        if self.trace_inputs is not None:
            self.trace_inputs.append(j)
        self.attempted += 1
        with self.span("featurize"):
            feats = self.featurize(self.stem, self.pool[j], self.feature_hw, self.device)
        if k in self.check_at:
            self.kept[k] = (j, feats)

    def end_to_end(self, window_s: float) -> dict:
        return {"featurize_img_per_s": self.n / window_s}

    def profiled(self, units: int) -> None:
        self.trace_inputs = []
        super().profiled(units)

    def work(self, units: int) -> dict:
        """The pair-form watershed's counted work on the traced images' own
        inputs: the sweeps each needs, capped at 256."""
        bound = 0.0
        for j in (self.trace_inputs or [])[:units]:
            x = torch.as_tensor(self.pool[j].astype(np.float32), device=self.device)
            sweeps = ref_cleaner.pair_sweeps_needed(x[None])[0]
            bound += counting.watershed_pair_bound_s(x.shape[0], x.shape[1], sweeps)
        return {"watershed_pair": bound} if bound else {}

    def release(self) -> None:
        self.stem = None

    def reference(self, img: np.ndarray, p=ref_model.FP32) -> torch.Tensor:
        with p.scope(), torch.no_grad():
            x = torch.from_numpy(np.asarray(img, np.float32)).to(self.device)[None]
            clean01 = ref_cleaner.clean_for_unet(x)
            return resize_linear(ref_model.conv1(self.conv1_w, clean01, p), self.feature_hw)[0]

    def judge(self, got: torch.Tensor, ref: torch.Tensor) -> dict:
        return {"feature_rel_err": rel_err(got, ref)}

    def check(self):
        worst = {"feature_rel_err": 0.0}
        if len(self.kept) < len(self.check_at):
            worst["images_missing"] = float(len(self.check_at) - len(self.kept))
        for _, (j, feats) in sorted(self.kept.items()):
            v = self.judge(torch.as_tensor(feats, device=self.device), self.reference(self.pool[j]))
            worst["feature_rel_err"] = max(worst["feature_rel_err"], v["feature_rel_err"])
        return [self.compared(k, v) for k, v in worst.items()]

    def control(self, variant: str) -> dict:
        worst = 0.0
        for _, (j, _feats) in sorted(self.kept.items()):
            worst = max(worst, self.judge(self.reference(self.pool[j], ref_model.TF32),
                                          self.reference(self.pool[j]))["feature_rel_err"])
        return {"feature_rel_err": worst}
