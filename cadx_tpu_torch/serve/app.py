"""HTTP serving layer: the reference web app's 12 routes on stdlib http.

Port of `cadx_tpu/serve/app.py`: the same routes, JSON, redirects,
workspace layout and guards, over the port's `InferenceEngine` (the card
unless `--device cpu`), `serve/store.py` and `serve/templates.py`. Uploads
are read by `data/imageio.py` (PNG, GIF, JPEG, DICOM with every
encapsulated syntax) and artifacts written by `xai/png.py`, so nothing
here needs cv2 or PIL; /bulk-classify resizes with `ops/resize.py`'s
`resize_area_cv2` on the engine's device, bit for bit the
`cv2.resize(..., INTER_AREA)` of the JAX front. Serve from the card with
`python -m cadx_tpu_torch.serve.app --workspace DIR --port N`.

Route parity with WebApplicationPrototype/app.py (flask is not in this
image; handlers return JSON + minimal HTML, same paths/verbs/redirects):

  GET  /                       landing (pipeline cards)
  GET  /home?pipeline=...      select pipeline (per-session, NOT a global
                               — fixes the reference's cross-request race
                               on pipeline_global, app.py:39/:351)
  POST /upload-single          ingest + preprocess + segment + case row
  POST /upload-bulk            zip of images into the bulk folder
  GET  /bulk-select-parameters list bulk images
  POST /upload-bulk-image      route one bulk image through upload-single
  GET  /diagnosis              case table from prediction_data.csv
  GET  /view/<patient_id>      raw image details
  GET  /view_segmentation      mask gallery (waits on the tracked mask job
                               instead of racing it, app.py:274 vs :429)
  GET  /classify               run classifier + async Grad-CAM artifacts
  GET  /roi                    per-class overlays + probabilities
  GET  /sample                 static sample page

Pipeline selection travels via the `cadx-pipeline` cookie or a
?pipeline= query param on /classify and /roi.
"""

from __future__ import annotations

import io
import json
import os
import threading
import urllib.parse
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from cadx_tpu_torch.data.imageio import imread_gray
from cadx_tpu_torch.ops.resize import resize_area_cv2
from cadx_tpu_torch.serve.engine import CLASS_MAP, InferenceEngine
from cadx_tpu_torch.serve.store import Workspace
from cadx_tpu_torch.xai.png import write_png

ALLOWED_EXTENSIONS = {"png", "jpg", "jpeg", "gif", "dcm"}  # +DICOM (extension)


def allowed_file(filename: str) -> bool:
    return "." in filename and filename.rsplit(".", 1)[1].lower() in ALLOWED_EXTENSIONS


def secure_filename(name: str) -> str:
    keep = [c if (c.isalnum() or c in "._-") else "_" for c in os.path.basename(name)]
    out = "".join(keep).strip(".")  # "." / ".." would resolve to directories
    return out or "upload"


# the JAX front's names for its reader and writer: any PNG, GIF or JPEG
# upload as cv2.imread(path, IMREAD_GRAYSCALE | IMREAD_ANYDEPTH) reads it,
# or a DICOM (16-bit depth kept), else None; PNG out
_imread_gray = imread_gray
_imwrite = write_png


def _resize_area_like(img: np.ndarray, hw, device) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_AREA) on `device`, in
    the upload's dtype."""
    x = torch.as_tensor(img.astype(np.float32), device=device)
    return resize_area_cv2(x, tuple(hw)).cpu().numpy().astype(img.dtype)


def _on_device(device: torch.device, fn):
    """`fn` with `device` as the current CUDA device of the thread that
    runs it: the artifact jobs run on the workspace's threads, and each
    kernel launches on its thread's current device and stream."""
    if device.type != "cuda":
        return fn

    def run(*args, **kwargs):
        with torch.cuda.device(device):
            return fn(*args, **kwargs)
    return run


def save_masks(image_masks: np.ndarray, filename: str, folder: str) -> None:
    """Per-channel mask PNGs, reference naming (app.py:215-229), written
    by `xai/png.py` instead of a matplotlib figure per channel."""
    base = os.path.splitext(filename)[0]
    for i in range(image_masks.shape[0]):
        ch = image_masks[i]
        lo, hi = float(ch.min()), float(ch.max())
        u8 = ((ch - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)
        _imwrite(os.path.join(folder, f"{base}_mask_{i+1}.png"), u8)


def _locked(fn):
    """Serialize mutating routes: concurrent uploads would clear each
    other's folders mid-processing and cross-wire CSV rows with artifacts
    (the race class the reference had). RLock because upload_bulk_image
    re-enters upload_single."""
    import functools as _ft

    @_ft.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


class CADxApp:
    """Route logic, decoupled from the HTTP plumbing for testability."""

    def __init__(self, workspace_root: str, engine: InferenceEngine | None = None):
        self.ws = Workspace(workspace_root)
        self.engine = engine or InferenceEngine()
        self._lock = threading.RLock()

    # ---------------- upload-single (app.py:230-314) ----------------
    @_locked
    def upload_single(self, image_bytes: bytes, filename: str,
                      breast: str = "", modality: str = "") -> dict:
        import uuid

        filename = secure_filename(filename)
        if not allowed_file(filename):
            return {"error": f"unsupported file type: {filename}",
                    "redirect": "/diagnosis"}
        # a previous patient's async artifact jobs may still be writing
        # into the folders about to be cleared (first-compile Grad-CAM
        # can take minutes); finishing them first means they can never
        # rewrite the fixed-name overlays AFTER the clear and masquerade
        # as the new patient's artifacts
        for job in ("gradcam", "save_masks"):
            try:
                self.ws.wait(job)
            except Exception:  # noqa: BLE001 — a failed old job is moot
                pass
        for f in ("raw", "preprocessed", "segmentation", "clean"):
            self.ws.clear_folder(f)
        # also clear the static mirrors so a re-upload can never serve a
        # previous patient's image/masks/overlays (stale-cache hazard)
        for rel in ("images", "explainability"):
            self.ws.clear_folder(rel)
        static_seg = os.path.join(self.ws.root, "static", "segmentation_image")
        if os.path.isdir(static_seg):
            for fn in os.listdir(static_seg):
                try:
                    os.unlink(os.path.join(static_seg, fn))
                except OSError:
                    pass
        raw_path = os.path.join(self.ws.folder("raw"), filename)
        with open(raw_path, "wb") as f:
            f.write(image_bytes)

        img = _imread_gray(raw_path)
        if img is None:
            return {"error": "Could not read image", "redirect": "/diagnosis"}

        patient_id = f"{str(uuid.uuid4())[:8]}_{filename}"
        processed_path = os.path.join(
            self.ws.folder("preprocessed"),
            f"{os.path.splitext(filename)[0]}_processed.npy")
        np.save(processed_path, img)

        masks_path = os.path.join(
            self.ws.folder("segmentation"),
            f"{os.path.splitext(filename)[0]}_all_masks.npy")
        # cache_token keeps the feature stack device-resident so the
        # later /classify and /roi skip re-uploading it (engine.py)
        image_masks, clean_image = self.engine.process_single_image(
            img, cache_token=masks_path)

        # clean image is always written as PNG (the upload may be a DICOM)
        clean_name = os.path.splitext(filename)[0] + ".png"
        clean_path = os.path.join(self.ws.folder("clean"), clean_name)
        _imwrite(clean_path, clean_image)

        # tracked async mask PNGs (reference used an unjoined thread)
        self.ws.submit("save_masks", save_masks, image_masks, filename,
                       self.ws.folder("segmentation"))

        np.save(masks_path, image_masks)
        # rebind the cache to the content token (path, mtime) now that
        # the artifact exists — _load_features derives the same token,
        # so an out-of-band rewrite of the .npy misses and re-uploads
        self.engine.finalize_feature_token(
            masks_path, (masks_path, os.path.getmtime(masks_path)))

        self.ws.write_case({
            "dicom_file_path": raw_path,
            "preprocessed_file_path": processed_path,
            "segmented_images_file_path": masks_path,
            "patient_id": patient_id,
            "breast": breast,
            "image_view": "",
            "pathology": "",
            "modality": modality,
            "image_name": filename,
            "clean_image_path": clean_path,
        })
        return {"patient_id": patient_id, "redirect": "/diagnosis"}

    # ---------------- bulk (app.py:316-343, :774-809) ----------------
    @_locked
    def upload_bulk(self, zip_bytes: bytes) -> dict:
        self.ws.clear_folder("bulk")
        extracted = []
        MAX_MEMBER = 128 * 1024 * 1024
        MAX_TOTAL = 512 * 1024 * 1024
        total = 0
        with zipfile.ZipFile(io.BytesIO(zip_bytes)) as zf:
            for member in zf.infolist():
                name = secure_filename(os.path.basename(member.filename))
                if name == "upload" or not allowed_file(name):
                    # same filter every other upload path applies ('.' or
                    # '..' basenames would even raise IsADirectoryError)
                    continue
                # decompression-bomb guard: trust but verify declared sizes
                if member.file_size > MAX_MEMBER or total + member.file_size > MAX_TOTAL:
                    return {"error": "zip contents too large",
                            "redirect": "/bulk-select-parameters"}
                with zf.open(member) as src:
                    data = src.read(MAX_MEMBER + 1)
                    if len(data) > MAX_MEMBER:  # lied about file_size
                        return {"error": "zip contents too large",
                                "redirect": "/bulk-select-parameters"}
                    with open(os.path.join(self.ws.folder("bulk"), name), "wb") as dst:
                        dst.write(data)
                total += len(data)
                extracted.append(name)
        return {"extracted": extracted, "redirect": "/bulk-select-parameters"}

    def bulk_images(self) -> list[str]:
        return sorted(f for f in os.listdir(self.ws.folder("bulk")) if allowed_file(f))

    @_locked
    def upload_bulk_image(self, image_name: str, breast: str = "",
                          modality: str = "") -> dict:
        # path-traversal guard: the name must be a bare filename and the
        # resolved path must stay inside the bulk folder ('../x' or an
        # absolute path would otherwise read any host file with an image
        # extension and republish it under /static/images)
        bulk = os.path.realpath(self.ws.folder("bulk"))
        if not image_name or os.path.basename(image_name) != image_name:
            return {"error": "invalid image name",
                    "redirect": "/bulk-select-parameters"}
        path = os.path.join(bulk, image_name)
        if os.path.commonpath([os.path.realpath(path), bulk]) != bulk:
            return {"error": "invalid image name",
                    "redirect": "/bulk-select-parameters"}
        # isfile (not exists): image_name='.' resolves to the bulk folder
        # itself and would raise IsADirectoryError on open
        if not os.path.isfile(path):
            return {"error": f"{image_name} does not exist",
                    "redirect": "/bulk-select-parameters"}
        with open(path, "rb") as f:
            return self.upload_single(f.read(), image_name, breast, modality)

    @_locked
    def bulk_classify(self, pipeline: str = "basic") -> dict:
        """Classify EVERY bulk image in one fused batched program on the
        engine's device (an extension over the reference, which routes
        bulk images through upload_single one at a time, app.py:316-343)."""
        names = self.bulk_images()
        if not names:
            return {"error": "no bulk images", "status": 404}
        hw = self.engine.config.segment_hw
        imgs, kept = [], []
        for n in names:
            img = _imread_gray(os.path.join(self.ws.folder("bulk"), n))
            if img is None:
                continue
            imgs.append(_resize_area_like(img, hw, self.engine.device))
            kept.append(n)
        if not imgs:
            return {"error": "no readable bulk images", "status": 400}
        rows = self.engine.classify_batch(np.stack(imgs), pipeline)
        for name, row in zip(kept, rows):
            row["image_name"] = name
        return {"classificationData": rows}

    # ---------------- diagnosis / view (app.py:358-462) ----------------
    def diagnosis(self) -> list[dict]:
        return self.ws.read_cases()

    def view_image(self, patient_id: str) -> dict:
        row = self.ws.find_case(patient_id)
        if row is None:
            return {"error": f"unknown patient_id {patient_id}"}
        image_path = row["dicom_file_path"]
        return {
            "image_filename": os.path.basename(image_path),
            "image_name": os.path.basename(image_path),
            "breast": row["breast"],
            "modality": row["modality"],
            "patient_id": patient_id,
        }

    @_locked
    def view_segmentation(self) -> dict:
        cases = self.ws.read_cases()
        if not cases:
            return {"error": "Segmented path not provided", "status": 400}
        seg_path = cases[0]["segmented_images_file_path"]
        base = os.path.splitext(os.path.basename(seg_path))[0].replace("_all_masks", "")
        self.ws.wait("save_masks")  # fixed race: reference read while writing
        prefix = f"{base}_mask_"
        def _mask_index(name: str) -> int:
            try:
                return int(name[len(prefix):-len(".png")])
            except ValueError:
                return 1 << 30
        masks = sorted(
            (f for f in os.listdir(self.ws.folder("segmentation"))
             if f.startswith(prefix) and f.endswith(".png")),
            key=_mask_index)  # numeric, not lexicographic (1,2,..,10,..)
        if not masks:
            return {"error": f"No segmentation masks found for {base}", "status": 404}
        # expose masks under /static for the gallery page (app.py:429-436)
        static_seg = os.path.join(self.ws.root, "static", "segmentation_image")
        os.makedirs(static_seg, exist_ok=True)
        for m in masks:
            src = os.path.join(self.ws.folder("segmentation"), m)
            import shutil

            shutil.copy2(src, dst := os.path.join(static_seg, m))
        return {
            "masks": masks,
            "metadata": {"image_name": base + ".png", "modality": "Mammogram",
                         "body_part": "Breast"},
        }

    def copy_image_to_static(self) -> str:
        """Reference copy_image_to_static (app.py:196-212). For DICOM
        uploads the browser cannot render the raw .dcm, so the clean PNG
        (written by upload_single) is mirrored instead — the reference
        never hit this because it only accepted png/jpg/gif."""
        cases = self.ws.read_cases()
        if not cases:
            return ""
        image_path = cases[0]["dicom_file_path"]
        if image_path.lower().endswith(".dcm"):
            base = os.path.splitext(os.path.basename(image_path))[0]
            clean_path = os.path.join(self.ws.folder("clean"), base + ".png")
            if os.path.exists(clean_path):
                image_path = clean_path
        name = os.path.basename(image_path)
        dst = os.path.join(self.ws.folder("images"), name)
        if os.path.exists(image_path):
            import shutil

            shutil.copyfile(image_path, dst)
        return name

    # ---------------- classify / roi (app.py:492-764) ----------------
    def _load_features(self):
        """-> (features, cache_token, err). The token (path, mtime)
        matches the one upload_single registered with the engine, so the
        device-resident copy is used when the artifact is unchanged."""
        npy = [f for f in os.listdir(self.ws.folder("segmentation"))
               if f.endswith(".npy")]
        if len(npy) == 0:
            return None, None, {
                "error": "No .npy file found in segmentation folder",
                "status": 404}
        if len(npy) > 1:
            return None, None, {
                "error": "More than one .npy file found in segmentation folder",
                "status": 400}
        path = os.path.join(self.ws.folder("segmentation"), npy[0])
        token = (path, os.path.getmtime(path))
        # mmap: on a device-cache hit the array is only shape-compared
        # (and the async Grad-CAM job reads it lazily), so the hot path
        # skips materializing the ~16MB stack on every request
        return np.load(path, mmap_mode="r"), token, None

    @_locked
    def classify(self, pipeline: str = "basic") -> dict:
        features, token, err = self._load_features()
        if err:
            return err
        result = self.engine.classify(features, pipeline, cache_token=token)
        result["sample"] = 1

        # async Grad-CAM artifacts, tracked (reference thread at app.py:649)
        self.copy_image_to_static()
        cases = self.ws.read_cases()
        clean_path = cases[0]["clean_image_path"] if cases else None
        if clean_path and os.path.exists(clean_path):
            display = _imread_gray(clean_path)
            self.ws.submit(
                "gradcam", _on_device(self.engine.device, self.engine.write_gradcam_overlays),
                features,
                display, self.ws.folder("explainability"), (0, 1), pipeline)
        image_filename = cases[0]["image_name"] if cases else ""
        return {"classificationData": [result], "image_filename": image_filename}

    @_locked
    def roi(self, pipeline: str = "basic", reference_parity: bool = False) -> dict:
        """Per-class ROI payload. Coordinates come from each class's CAM
        (xai/roi.py) — real, image-dependent rectangles. The reference
        hardcodes one rectangle for every image (app.py:714); pass
        reference_parity=True to reproduce that constant."""
        features, token, err = self._load_features()
        if err:
            return err
        if reference_parity:
            base = self.engine.classify(features, pipeline, cache_token=token)
            coords = [{"top": 0.20, "left": 0.30,
                       "width": 0.20, "height": 0.175}] * 2
        else:
            # one shared feature-prep + forward for both payload halves
            base, coords = self.engine.classify_and_roi(
                features, pipeline, cache_token=token)
        self.ws.wait("gradcam")  # overlays ready before the viewer reads them
        results = []
        for class_idx in range(2):
            probs = base["prediction_probabilities"]
            results.append({
                "class_idx": class_idx,
                "class_name": CLASS_MAP[class_idx],
                "prediction_probabilities": probs,
                "predicted_class": base["predicted_class"],
                "accuracy": float(max(probs) * 100),
                "confidence": float(probs[class_idx] * 100),
                "diagnosis": base["predicted_class"],
                "explainability": 0.5,
                "roiCoords": coords[class_idx],
                "overlay_path": f"explainability/gradcam_overlay_class_{class_idx}.png",
            })
        cases = self.ws.read_cases()
        return {
            "classificationData": results,
            "image_filename": cases[0]["image_name"] if cases else "",
            "class_0_image_path": results[0]["overlay_path"],
            "class_1_image_path": results[1]["overlay_path"],
        }


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------

def _parse_multipart(content_type: str, body: bytes) -> dict:
    """Minimal multipart/form-data parser (fields + files), binary-safe:
    exactly ONE framing CRLF is removed around each part — stripping all
    trailing CR/LF bytes would corrupt binaries that end in 0x0a/0x0d."""
    fields: dict[str, bytes | tuple[str, bytes]] = {}
    if "boundary=" not in content_type:
        return fields
    # parameters may follow boundary (RFC 2045: '; charset=...'): split
    # them off or the delimiter never matches and uploads silently drop
    boundary = (content_type.split("boundary=", 1)[1]
                .split(";")[0].strip().strip('"'))
    delim = b"--" + boundary.encode()
    for part in body.split(delim):
        if part in (b"", b"--", b"--\r\n", b"\r\n"):
            continue
        if part.startswith(b"\r\n"):
            part = part[2:]
        if b"\r\n\r\n" not in part:
            continue
        header_blob, value = part.split(b"\r\n\r\n", 1)
        if value.endswith(b"\r\n"):  # the single CRLF before the next boundary
            value = value[:-2]
        headers = header_blob.decode("utf-8", errors="replace")
        name = None
        filename = None
        for line in headers.split("\r\n"):
            if line.lower().startswith("content-disposition"):
                for item in line.split(";"):
                    item = item.strip()
                    if item.startswith("name="):
                        name = item[5:].strip('"')
                    elif item.startswith("filename="):
                        filename = item[9:].strip('"')
        if name is None:
            continue
        fields[name] = (filename, value) if filename is not None else value
    return fields


class _Handler(BaseHTTPRequestHandler):
    app: CADxApp = None  # injected by make_server

    def log_message(self, fmt, *args):  # quiet
        pass

    # -- helpers ------------------------------------------------------------
    def _wants_html(self) -> bool:
        return "text/html" in self.headers.get("Accept", "")

    def _send_json(self, obj, status: int = 200, cookie: str | None = None):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if cookie:
            self.send_header("Set-Cookie", cookie)
        self.end_headers()
        self.wfile.write(body)

    def _send_html(self, markup: str, status: int = 200,
                   cookie: str | None = None):
        body = markup.encode()
        self.send_response(status)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        if cookie:
            self.send_header("Set-Cookie", cookie)
        self.end_headers()
        self.wfile.write(body)

    def _respond(self, obj, render, status: int = 200, cookie: str | None = None):
        """Content negotiation: browsers get HTML, API callers JSON."""
        if self._wants_html() and "error" not in obj:
            self._send_html(render(obj), status, cookie)
        else:
            self._send_json(obj, status, cookie)

    def _send_static(self, rel_path: str):
        import mimetypes

        safe = os.path.normpath(rel_path).lstrip("/")
        if safe.startswith(".."):
            self._send_json({"error": "forbidden"}, 403)
            return
        full = os.path.join(self.app.ws.root, "static", safe)
        if not os.path.isfile(full):
            self._send_json({"error": "not found"}, 404)
            return
        guessed = mimetypes.guess_type(full)[0] or "application/octet-stream"
        # never serve active content types from the artifact store
        # (stored-XSS guard: uploads are copied under static/)
        allowed_types = {"image/png", "image/jpeg", "image/gif", "text/css",
                         "application/json"}
        ctype = guessed if guessed in allowed_types else "application/octet-stream"
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(os.path.getsize(full)))
        self.end_headers()
        # chunked copy: raw mammogram mirrors can be hundreds of MB;
        # slurping them would allocate the whole file per request thread
        import shutil as _shutil

        with open(full, "rb") as f:
            _shutil.copyfileobj(f, self.wfile, length=1 << 20)

    def _redirect(self, location: str):
        self.send_response(302)
        self.send_header("Location", location)
        self.end_headers()

    @staticmethod
    def _sanitize_pipeline(value: str) -> str:
        # strict whitelist: this value flows into a Set-Cookie header and
        # engine dispatch (CRLF in a query param must never reach headers)
        return value if value in ("basic", "advanced") else "basic"

    def _pipeline(self, query: dict) -> str:
        if "pipeline" in query:
            return self._sanitize_pipeline(query["pipeline"][0])
        cookies = self.headers.get("Cookie", "")
        for item in cookies.split(";"):
            if item.strip().startswith("cadx-pipeline="):
                return self._sanitize_pipeline(item.strip().split("=", 1)[1])
        return "basic"

    # -- GET ------------------------------------------------------------
    def do_GET(self):
        try:
            self._do_get()
        except Exception as e:  # noqa: BLE001 — always answer the client
            try:
                self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)
            except Exception:
                pass

    def _do_get(self):
        parsed = urllib.parse.urlparse(self.path)
        query = urllib.parse.parse_qs(parsed.query)
        route = parsed.path.rstrip("/") or "/"
        app = self.app

        from cadx_tpu_torch.serve import templates as T

        if route == "/":
            self._respond({"page": "landing",
                           "pipelines": ["basic", "advanced"],
                           "next": "/home?pipeline=basic|advanced"},
                          lambda o: T.landing())
        elif route == "/home":
            pipeline = self._sanitize_pipeline(query.get("pipeline", ["basic"])[0])
            self._respond({"page": "home", "pipeline": pipeline},
                          lambda o: T.home(o["pipeline"]),
                          cookie=f"cadx-pipeline={pipeline}; Path=/")
        elif route == "/diagnosis":
            self._respond({"cases": app.diagnosis()},
                          lambda o: T.diagnosis(o["cases"]))
        elif route.startswith("/view/"):
            self._respond(app.view_image(route.split("/view/", 1)[1]), T.view_image)
        elif route == "/view_segmentation":
            out = app.view_segmentation()
            self._respond(out, T.view_segmentation,
                          status=out.pop("status", 200) if "error" in out else 200)
        elif route == "/classify":
            out = app.classify(self._pipeline(query))
            self._respond(out, T.classification,
                          status=out.pop("status", 200) if "error" in out else 200)
        elif route == "/roi":
            ref_parity = query.get("reference_parity", ["0"])[0] in ("1", "true")
            out = app.roi(self._pipeline(query), reference_parity=ref_parity)
            self._respond(out, T.roi,
                          status=out.pop("status", 200) if "error" in out else 200)
        elif route == "/bulk-select-parameters":
            self._respond({"images": app.bulk_images()},
                          lambda o: T.bulk_select(o["images"]))
        elif route == "/bulk-classify":
            out = app.bulk_classify(self._pipeline(query))
            self._send_json(out, status=out.pop("status", 200) if "error" in out else 200)
        elif route == "/sample":
            self._respond({"page": "sample"}, lambda o: T.sample())
        elif route.startswith("/static/"):
            self._send_static(route[len("/static/"):])
        else:
            self._send_json({"error": "not found"}, 404)

    MAX_BODY_BYTES = 256 * 1024 * 1024  # generous for raw mammograms

    # -- POST -----------------------------------------------------------
    def do_POST(self):
        try:
            self._do_post()
        except Exception as e:  # noqa: BLE001 — always answer the client
            try:
                self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)
            except Exception:
                pass

    def _do_post(self):
        length = int(self.headers.get("Content-Length", 0))
        if length > self.MAX_BODY_BYTES:
            self._send_json({"error": "request body too large"}, 413)
            return
        body = self.rfile.read(length)
        fields = _parse_multipart(self.headers.get("Content-Type", ""), body)
        route = urllib.parse.urlparse(self.path).path.rstrip("/")
        app = self.app

        def field_str(name, default=""):
            v = fields.get(name, default)
            if isinstance(v, bytes):
                return v.decode("utf-8", errors="replace")
            return v if isinstance(v, str) else default

        if route == "/upload-single":
            item = fields.get("image1")
            if not isinstance(item, tuple):
                self._redirect("/diagnosis")
                return
            filename, data = item
            out = app.upload_single(data, filename or "upload.png",
                                    field_str("body_part1"), field_str("modality1"))
            self._redirect(out.get("redirect", "/diagnosis"))
        elif route == "/upload-bulk":
            item = fields.get("bulk_images_zip")
            if isinstance(item, tuple) and (item[0] or "").endswith(".zip"):
                app.upload_bulk(item[1])
            self._redirect("/bulk-select-parameters")
        elif route == "/upload-bulk-image":
            out = app.upload_bulk_image(field_str("bulk_image_name"),
                                        field_str("body_part1"),
                                        field_str("modality1"))
            self._redirect(out.get("redirect", "/diagnosis"))
        else:
            self._send_json({"error": "not found"}, 404)


def make_server(workspace_root: str, host: str = "127.0.0.1", port: int = 0,
                engine: InferenceEngine | None = None,
                warmup: bool = False) -> ThreadingHTTPServer:
    app = CADxApp(workspace_root, engine)
    if warmup:
        # pay every serving path's first run (kernel builds included) now,
        # not on the first patient
        app.engine.warmup()
    handler = type("BoundHandler", (_Handler,), {"app": app})
    server = ThreadingHTTPServer((host, port), handler)
    server.app = app
    return server


def main(argv=None):  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser(description="cadx_tpu_torch serving layer")
    ap.add_argument("--workspace", default="./cadx_workspace")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for a CPU run)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the first run of every serving path at startup")
    args = ap.parse_args(argv)
    server = make_server(args.workspace, args.host, args.port,
                         engine=InferenceEngine(device=args.device),
                         warmup=not args.no_warmup)
    print(f"cadx_tpu_torch serving on http://{args.host}:{args.port} "
          f"({server.app.engine.device})")
    server.serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
