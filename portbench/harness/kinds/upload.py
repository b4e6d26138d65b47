"""Full-field uploads through the serving engine, open loop at a fixed rate.

Each request is what /upload-single and /roi ask of the engine:
`process_single_image(upload, cache_token)` (the bucket resize of an
oversized scan, the cleaner, the 512x512 gray, conv1, the features
fetched), then `classify_and_roi(features, pipeline, class_indices,
cache_token)` (the classifier on the cached device features, the CAMs and
ROIs, one fetch). The front serializes every route behind one lock, so a
reading room's uploads reach the engine one at a time: the requests
arrive every 1 / `rate_per_s` seconds whatever the engine does, and each
is served when the one before it is done.

Traffic ("kind": "upload"): `rate_per_s` (the arrival rate, fixed),
`shapes` (native (h, w) uint16 scans, the pool cycling through them), `pool`, `cap` (`native_clean_max_side`),
`segment_hw`, `pipeline`, `class_indices`, `check_requests` (requests
of the window judged, drawn from the seed among the first
`check_within`), `profile_units` (requests in the traced window).

End to end: `upload_p95_ms`, the 95th percentile (nearest rank) of every
request's wait from its arrival (when it was due) to its class and ROI
boxes, the requests that arrived in the window and were served after it
closed included; a failed request counts as an infinite wait.
"""

from __future__ import annotations

import math
import sys
import time
import traceback

import numpy as np
import torch

from harness import counting, synthetic
from harness.cell import (Base, init_cnn, init_conv1, port_cnn, port_cnn_config,
                          rel_err)
from harness.reference import cleaner as ref_cleaner
from harness.reference import model as ref_model
from harness.reference.resize import resize_area


def bucket_clean_hw(h: int, w: int, cap: int) -> tuple[int, int]:
    """The engine's cleaning shape for an oversized upload: long side ==
    cap, short side scaled and rounded up to a multiple of 128."""
    scale = cap / max(h, w)
    short = max(128, -(-round(min(h, w) * scale) // 128) * 128)
    short = min(short, cap)
    return (cap, short) if h >= w else (short, cap)


def nearest_rank(values: list[float], q: float) -> float:
    s = sorted(values)
    return s[max(math.ceil(q * len(s)) - 1, 0)]


class Cell(Base):
    def setup(self) -> None:
        from cadx_tpu_torch.models import cnn, unet
        from cadx_tpu_torch.serve import engine

        t = self.traffic
        self.clf_cfg = self.cfg["classifier"]
        econf = engine.EngineConfig(segment_hw=tuple(t["segment_hw"]),
                                    native_clean_max_side=t["cap"],
                                    bulk_data_parallel=False,
                                    advanced_classifier=port_cnn_config(self.clf_cfg))
        wgen = self.generator(0)
        self.conv1_w = init_conv1(wgen)
        self.params = init_cnn(wgen, self.clf_cfg)
        basic = cnn.init_params(torch.Generator().manual_seed(self.ctx.seed % (1 << 62)),
                                econf.basic_classifier, device=self.device)
        state = engine.EngineState(encoder=unet.ResNetStem(self.conv1_w.clone()),
                                   basic=basic, advanced=port_cnn(self.params, self.clf_cfg))
        self.engine = engine.InferenceEngine(econf, device=self.device, state=state)
        self.mark("port and weights")
        igen = self.generator(1)
        shapes = [tuple(s) for s in t["shapes"]]
        self.pool = [synthetic.native_mammogram(*shapes[i % len(shapes)], igen)
                     .cpu().numpy().astype(np.uint16) for i in range(t["pool"])]
        self.mark("inputs")
        self.check_at = self.draw_checked(t["check_within"], t["check_requests"])
        self.kept: dict[int, tuple] = {}
        self.latencies: list[float] = []
        self.late: list[float] = []           # how late each request started
        self.n = 0
        self.trace_inputs: list[int] | None = None
        for j in range(len(self.pool)):          # every shape the window uses, twice
            for _ in range(2):
                self._request(j, ("warmup", j))

    def _request(self, j: int, token):
        """What the front asks of the engine for one upload."""
        with self.span("segment"):
            feats, clean = self.engine.process_single_image(self.pool[j], cache_token=token)
        with self.span("roi"):
            res, coords = self.engine.classify_and_roi(
                feats, self.traffic["pipeline"], tuple(self.traffic["class_indices"]),
                cache_token=token)
        return feats, clean, res, coords

    def _serve(self, k: int, due: float | None) -> None:
        """Request k, timed from `due` (its arrival) or, unscheduled, from
        its start."""
        j = k % len(self.pool)
        if self.trace_inputs is not None:
            self.trace_inputs.append(j)
        self.attempted += 1
        t0 = time.perf_counter()
        if due is not None:
            self.late.append(max(t0 - due, 0.0))
        try:
            feats, clean, res, coords = self._request(j, ("req", k))
        except Exception:                        # a failed request is a miss, not a stop
            traceback.print_exc(file=sys.stderr)
            self.failed += 1
            self.latencies.append(math.inf)
            return
        self.latencies.append(time.perf_counter() - (t0 if due is None else due))
        if k in self.check_at:
            self.kept[k] = (j, feats, clean, res, coords)

    def unit(self) -> None:
        """Serve the next request that arrives in the window, waiting for its
        arrival where the engine is idle; one that arrives after the window
        closes is not sent."""
        t_start, t_end = self.window
        due = t_start + self.n / self.traffic["rate_per_s"]
        if due >= t_end:
            time.sleep(max(t_end - time.perf_counter(), 0.0))
            return
        time.sleep(max(due - time.perf_counter(), 0.0))
        self.n += 1
        self._serve(self.n - 1, due)

    def finish(self) -> None:
        """The requests that arrived in the window and still wait."""
        t_start, t_end = self.window
        while t_start + self.n / self.traffic["rate_per_s"] < t_end:
            self.n += 1
            self._serve(self.n - 1, t_start + (self.n - 1) / self.traffic["rate_per_s"])
        super().finish()

    def end_to_end(self, window_s: float) -> dict:
        n = len(self.latencies)
        quarters = [self.latencies[i * n // 4:(i + 1) * n // 4] for i in range(4)]
        print("portbench: upload p50/p95 ms by quarter of the window: " + ", ".join(
            f"{nearest_rank(q, 0.5) * 1e3:.1f}/{nearest_rank(q, 0.95) * 1e3:.1f}"
            for q in quarters if q) + f"; {n} requests, the last started "
            f"{(self.late[-1] if self.late else 0.0) * 1e3:.1f} ms late", file=sys.stderr)
        return {"upload_p95_ms": nearest_rank(self.latencies, 0.95) * 1e3}

    def profiled(self, units: int) -> None:
        """`units` requests back to back (the traced window reads where a
        request's own time goes, not the gaps between arrivals)."""
        self.trace_inputs = []
        for _ in range(units):
            self.n += 1
            self._serve(self.n - 1, None)
        super().finish()

    def work(self, units: int) -> dict:
        """The pair-form watershed's counted work on the traced requests'
        own inputs: the sweeps each needs, capped at 256."""
        bound = 0.0
        for j in (self.trace_inputs or [])[:units]:
            x = self._bucketed(self.pool[j])
            sweeps = ref_cleaner.pair_sweeps_needed(x[None])[0]
            bound += counting.watershed_pair_bound_s(x.shape[0], x.shape[1], sweeps)
        return {"watershed_pair": bound} if bound else {}

    def release(self) -> None:
        self.engine = None

    def _bucketed(self, img: np.ndarray) -> torch.Tensor:
        x = torch.as_tensor(img.astype(np.float32), device=self.device)
        cap = self.traffic["cap"]
        if cap and max(x.shape) > cap:
            x = resize_area(x[None], bucket_clean_hw(*x.shape, cap))[0]
        return x

    def reference(self, img: np.ndarray, p=ref_model.FP32) -> dict:
        """The request's answers, computed plainly."""
        cfg = self.clf_cfg
        with p.scope(), torch.no_grad():
            gray = ref_cleaner.clean_boundary_gray(self._bucketed(img)[None])
            resized = resize_area(gray, tuple(self.traffic["segment_hw"]))
            feats = ref_model.conv1(self.conv1_w, resized / 255.0, p)   # (1, h, w, 64)
            clean_u8 = torch.clamp(torch.round(resized[0]), 0, 255).to(torch.uint8)
            acts = ref_model.conv_stack(self.params, cfg, feats, p)
            probs = ref_model.softmax(ref_model.head_logits(self.params, cfg, acts, p))[0]
            classes = [int(probs.argmax())] + list(self.traffic["class_indices"])
            seeds = [torch.nn.functional.one_hot(torch.tensor([c], device=self.device),
                                                 cfg["num_classes"]).to(torch.float32)
                     for c in classes]
            cams = torch.cat([ref_model.cam_from_acts_grads(acts, g) for g in
                              ref_model.class_grads(self.params, cfg, acts, seeds, p)])
            rois = ref_model.roi_from_cam(cams)
        return {"features": feats[0].permute(2, 0, 1), "clean_u8": clean_u8,
                "probs": probs, "rois": rois}

    @staticmethod
    def _roi_row(d: dict) -> list[float]:
        return [d["top"], d["left"], d["height"], d["width"]]

    def judge(self, got: dict, ref: dict) -> dict:
        ref_rois = [[round(float(v), 4) for v in row] for row in ref["rois"].cpu().tolist()]
        got_rois = got["rois"]
        mismatch = sum(g != r for g, r in zip(got_rois, ref_rois))
        return {"clean_px_diff": float((got["clean_u8"] != ref["clean_u8"]).sum()),
                "feature_rel_err": rel_err(got["features"], ref["features"]),
                "prob_abs_err": float((got["probs"] - ref["probs"]).abs().max()),
                "class_vs_probs": float(got["pred"] != int(got["probs"].argmax())),
                "roi_diff": float(mismatch)}

    def got(self, feats, clean, res, coords) -> dict:
        return {"features": torch.as_tensor(feats, device=self.device),
                "clean_u8": torch.as_tensor(clean, device=self.device),
                "probs": torch.as_tensor(res["prediction_probabilities"],
                                         dtype=torch.float32, device=self.device),
                "pred": res["predicted_class_index"],
                "rois": [self._roi_row(res["roiCoords"])] + [self._roi_row(c) for c in coords]}

    def check(self):
        worst: dict[str, float] = {}
        if len(self.kept) < len(self.check_at):
            worst["requests_missing"] = float(len(self.check_at) - len(self.kept))
        for _, (j, feats, clean, res, coords) in sorted(self.kept.items()):
            v = self.judge(self.got(feats, clean, res, coords), self.reference(self.pool[j]))
            for k, x in v.items():
                worst[k] = max(worst.get(k, 0.0), x)
        return [self.compared(k, v) for k, v in worst.items()]

    def control(self, variant: str) -> dict:
        worst: dict[str, float] = {}
        for _, (j, *_rest) in sorted(self.kept.items()):
            c = self.reference(self.pool[j], ref_model.TF32)
            got = {"features": c["features"], "clean_u8": c["clean_u8"], "probs": c["probs"],
                   "pred": int(c["probs"].argmax()),
                   "rois": [[round(float(v), 4) for v in row] for row in c["rois"].cpu().tolist()]}
            for k, x in self.judge(got, self.reference(self.pool[j])).items():
                worst[k] = max(worst.get(k, 0.0), x)
        return worst
