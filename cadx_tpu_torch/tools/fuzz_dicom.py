"""Mutation fuzzer for the DICOM ingest stack (exception contract).

The port's own copy of `cadx_tpu/tools/fuzz_dicom.py`, over the port's
`data/dicom.py`.

Reproducible harness for the campaigns run each round (DESIGN.md
"Ingest robustness"): seeds one valid file per supported transfer
syntax, applies random bit flips / truncations / splices / insertions /
FF floods, and asserts the single failure contract — every decode
failure surfaces as `DicomError` (what the serving routes catch), never
a raw IndexError/ValueError/struct.error/MemoryError. Leaking inputs
are written next to the report for triage.

Usage:
    python -m cadx_tpu_torch.tools.fuzz_dicom [--seconds 60] [--seed 1234]

The in-suite deterministic regression (test_torch_codecs.py) pins cases
of this harness; this tool is for the long campaigns.
"""

from __future__ import annotations

import argparse
import os
import random
import tempfile
import time

import numpy as np

from cadx_tpu_torch.data import dicom


def build_seeds(tmpdir: str) -> list[bytes]:
    """One valid file per supported transfer syntax (16- and 8-bit)."""
    rng = np.random.default_rng(3)
    img16 = np.zeros((96, 80), np.uint16)
    yy, xx = np.mgrid[0:96, 0:80]
    disk = ((xx - 80) ** 2 + (yy - 48) ** 2) < 48 ** 2
    img16[disk] = rng.integers(0, 4095, (96, 80)).astype(np.uint16)[disk]
    img8 = (img16 >> 4).astype(np.uint8)

    cases = [(dicom.TS_EXPLICIT_LE, img16), (dicom.TS_EXPLICIT_BE, img16),
             (dicom.TS_DEFLATED_LE, img16), (dicom.TS_RLE, img16),
             (dicom.TS_JPEG_LOSSLESS_SV1, img16),
             (dicom.TS_JPEG_LOSSLESS_P14, img16),
             (dicom.TS_JPEG_LS, img16), (dicom.TS_JPEG_LS_NEAR, img16),
             (dicom.TS_J2K_LOSSLESS, img16), (dicom.TS_J2K, img16),
             (dicom.TS_JPEG_BASELINE, img8)]
    seeds = []
    for ts, img in cases:
        p = os.path.join(tmpdir, ts.replace(".", "_") + ".dcm")
        try:
            dicom.dcmwrite_minimal(p, img, transfer_syntax=ts)
        except dicom.DicomError:
            continue  # no encoder for this syntax in the port (J2K, JPEG baseline)
        with open(p, "rb") as f:
            seeds.append(f.read())
    return seeds


def mutate(blob: bytes, rnd: random.Random) -> bytes:
    b = bytearray(blob)
    op = rnd.randrange(5)
    if op == 0:                                   # bit flips
        for _ in range(rnd.randrange(1, 10)):
            i = rnd.randrange(len(b))
            b[i] ^= 1 << rnd.randrange(8)
    elif op == 1:                                 # truncation
        del b[rnd.randrange(1, len(b)):]
    elif op == 2:                                 # 4-byte splice
        i = rnd.randrange(max(len(b) - 4, 1))
        b[i:i + 4] = bytes(rnd.randrange(256) for _ in range(4))
    elif op == 3:                                 # insertion
        i = rnd.randrange(len(b))
        b[i:i] = bytes(rnd.randrange(256)
                       for _ in range(rnd.randrange(1, 16)))
    else:                                         # FF flood
        i = rnd.randrange(len(b))
        b[i:i + 8] = b"\xff" * 8
    return bytes(b)


def run(seconds: float, seed: int, out_dir: str) -> tuple[int, int]:
    rnd = random.Random(seed)
    with tempfile.TemporaryDirectory() as td:
        seeds = build_seeds(td)
        if not seeds:
            raise RuntimeError("no fuzz seeds could be built")
        t0 = time.time()
        n = leaks = 0
        while time.time() - t0 < seconds:
            m = mutate(seeds[rnd.randrange(len(seeds))], rnd)
            try:
                dicom.dcmread(m).pixel_array
            except dicom.DicomError:
                pass
            except Exception as e:  # noqa: BLE001 — the contract breach
                leaks += 1
                path = os.path.join(out_dir, f"fuzz_leak_{leaks}.bin")
                with open(path, "wb") as f:
                    f.write(m)
                print(f"LEAK {type(e).__name__}: {str(e)[:120]} -> {path}")
            n += 1
    return n, leaks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out-dir", default=tempfile.gettempdir(),
                    help="where leaking inputs are written")
    args = ap.parse_args()
    n, leaks = run(args.seconds, args.seed, args.out_dir)
    print(f"iterations: {n}, leaks: {leaks}")
    return 1 if leaks else 0


if __name__ == "__main__":
    raise SystemExit(main())
