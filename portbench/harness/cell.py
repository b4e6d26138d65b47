"""What every kind of cell shares: its context, host spans, the numbers
that decide `correct`, and the seeded weights.

A kind (`kinds/<kind>.py`, named by the traffic file's "kind") defines
`Cell`, a subclass of `Base`, with:

- `setup()`: load the port, make the weights and inputs from the seed on
  the device, warm up every shape the window uses;
- `unit()`: one unit of the window's work (a batch, a request, a step, an
  image); `finish()`: wait for what is still in flight;
- `end_to_end(window_s)`: {metric name: value} of the window;
- `profiled(units)`: run `units` units for the traced window and
  synchronise; `work(units)`: their counted work, the least seconds each
  kernel group could take on them (`counting`), for the per-layer readers;
  `model_flops_per_unit()`: a unit's model FLOPs, for `mfu`;
- `release()`: drop the program's state; `check()`: the compared numbers,
  each beside its limit, from the plain reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class Context:
    name: str          # the cell
    config: dict       # the configuration file
    traffic: dict      # the traffic file
    limits: dict       # name -> limit of each compared number
    seed: int
    device: torch.device


@dataclasses.dataclass
class Compared:
    """One number that decides `correct`: `value` must not exceed `limit`."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Base:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.cfg = ctx.config
        self.traffic = ctx.traffic
        self.device = ctx.device
        self.spans: dict[str, list[float]] = {}
        self.attempted = 0
        self.failed = 0
        self.marks: list[tuple[str, float]] = []

    def mark(self, name: str) -> None:
        """Note that set-up reached `name` (the run prints the times)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.marks.append((name, time.perf_counter()))

    @contextlib.contextmanager
    def span(self, name: str):
        """Host time of a block, kept under `name`, and a profiler range
        of the same name (which a traced window reads)."""
        with torch.profiler.record_function(SPAN_PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def generator(self, stream: int) -> torch.Generator:
        """A generator on the device for one purpose (`stream`), from the
        seed: the same seed gives the same draws."""
        return torch.Generator(device=self.device).manual_seed(
            (self.ctx.seed * 1000003 + stream) % (1 << 63))

    def compared(self, name: str, value: float) -> Compared:
        return Compared(name, float(value), float(self.ctx.limits[name]))

    def start_window(self, t0: float, seconds: float) -> None:
        self.window = (t0, t0 + seconds)

    def finish(self) -> None:
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" else None

    def profiled(self, units: int) -> None:
        for _ in range(units):
            self.unit()
        self.finish()

    def work(self, units: int) -> dict:
        return {}

    def model_flops_per_unit(self) -> float:
        return 0.0

    def draw_checked(self, within: int, n: int) -> set[int]:
        """The units of the window whose answers are judged: n of the
        first `within`, drawn from the seed."""
        return set(np.random.default_rng(self.ctx.seed).choice(within, n, replace=False).tolist())


def init_cnn(gen: torch.Generator, cfg: dict) -> dict:
    """He-normal convs, Xavier-uniform dense layers and zero biases, as the
    port's `cnn.init_params` draws them, on the generator's device, in
    one call a tensor; plain tensors in the reference's layout."""
    dev = gen.device
    conv, dense = [], []
    c_in = cfg["input_shape"][2]
    for f, k in cfg["conv_layers"]:
        std = math.sqrt(2.0 / (k * k * c_in))
        conv.append((torch.randn((f, c_in, k, k), generator=gen, device=dev) * std,
                     torch.zeros(f, device=dev)))
        c_in = f
    h, w, c = cfg["input_shape"]
    for f, k in cfg["conv_layers"]:
        if cfg["conv_padding"] == "VALID":
            h, w = h - k + 1, w - k + 1
        h, w, c = h // 2, w // 2, f
    prev = h * w * c
    for units in list(cfg["hidden_units"]) + [cfg["num_classes"]]:
        limit = math.sqrt(6.0 / (prev + units))
        dense.append(((torch.rand((prev, units), generator=gen, device=dev) * 2 - 1) * limit,
                      torch.zeros(units, device=dev)))
        prev = units
    return {"conv": conv, "dense": dense[:-1], "out": dense[-1]}


def init_conv1(gen: torch.Generator) -> torch.Tensor:
    """He-normal (64, 1, 7, 7) conv1 of the encoder."""
    return torch.randn((64, 1, 7, 7), generator=gen, device=gen.device) * math.sqrt(2.0 / 49)


def clone_params(params: dict) -> dict:
    return {"conv": [(w.clone(), b.clone()) for w, b in params["conv"]],
            "dense": [(w.clone(), b.clone()) for w, b in params["dense"]],
            "out": tuple(t.clone() for t in params["out"])}


def port_cnn(params: dict, cfg: dict):
    """The port's `cnn.CNN` over clones of the benchmark's weights."""
    from cadx_tpu_torch.models import cnn

    p = clone_params(params)
    return cnn.CNN(port_cnn_config(cfg), p["conv"], p["dense"], p["out"])


def port_cnn_config(cfg: dict):
    from cadx_tpu_torch.models import cnn

    return cnn.CNNConfig(input_shape=tuple(cfg["input_shape"]),
                         num_classes=cfg["num_classes"],
                         conv_layers=tuple(tuple(c) for c in cfg["conv_layers"]),
                         hidden_units=tuple(cfg["hidden_units"]),
                         dropout_rate=cfg["dropout_rate"], leaky_alpha=cfg["leaky_alpha"],
                         conv_padding=cfg["conv_padding"])


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|."""
    got, ref = got.to(torch.float64), ref.to(torch.float64)
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / (scale if scale > 0 else 1.0)

