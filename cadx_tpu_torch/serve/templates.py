"""Server-rendered HTML for the serving layer — reference-fidelity UI.

Carries the structure and dark/red visual design of the reference's
template set (WebApplicationPrototype/templates/base.html,
Home/Landing.html, Case/AddCase.html + upload.html + History.html,
Analysis/Default/{DefaultLanding,DefaultMain,Classification,
RegionOfInterest,Sample,bulk_select_parameters,Diagnosis}.html and
static/css/style.css): black fixed header with the red product title
and nav, #121212 body, red-accent pipeline cards with module sections,
filterable case tables, the red-glow results panel, and the ROI viewer
controls. Rendered with str.format — no template engine dependency.

A reference user should recognize every page; the markup itself is
written fresh for this app's routes/data (the reference renders
client-side from Flask/Jinja context; here pages are server-rendered
with the same client-side enhancements — table filter, summary fetch,
ROI controls — as plain inline JS).
"""

from __future__ import annotations

import html
import json

_TITLE = "Visual-Based Computer-Aided Breast Cancer Diagnosis"

# theme: reference static/css/style.css + the shared page-level styles
# repeated in each template's <style> block
_BASE = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} - CAD System</title>
<style>
  body {{ background-color:#121212; color:#ffffff;
         font-family:Arial, sans-serif; margin:0; padding:0;
         min-height:100vh; display:flex; flex-direction:column; }}
  header {{ background-color:#000000; padding:1rem 2rem; display:flex;
           justify-content:space-between; align-items:center;
           border-bottom:2px solid red; position:fixed; top:0; left:0;
           right:0; z-index:1000; }}
  header h1 {{ color:red; margin:0; font-size:1.35rem; }}
  nav a {{ color:red; text-decoration:none; margin-left:1rem;
          font-weight:bold; }}
  nav a:hover {{ text-decoration:underline; }}
  main {{ flex:1; padding:6rem 2rem 2rem; }}
  footer {{ background-color:#000000; color:#999; text-align:center;
           padding:1rem 0; border-top:1px solid #333; }}
  h2 {{ color:red; margin-bottom:1rem; }}
  .container {{ background-color:#1e1e1e; padding:1.5rem;
               border-radius:8px; }}
  table {{ width:100%; border-collapse:collapse; margin-bottom:2rem; }}
  th,td {{ border:1px solid #333; padding:0.75rem; text-align:left;
          color:#fff; }}
  th {{ background-color:#222; }}
  tr:nth-child(even) {{ background-color:#1a1a1a; }}
  .clickable-row {{ cursor:pointer; }}
  .clickable-row:hover {{ background-color:#1f1f1f; }}
  .upload-btn, .view-button, .add-case-btn, .back-button {{
     display:inline-block; background-color:red; color:white;
     padding:0.6rem 1.2rem; border:none; border-radius:6px;
     font-weight:bold; font-size:1rem; cursor:pointer;
     text-decoration:none; transition:background-color 0.3s ease; }}
  .upload-btn:hover, .view-button:hover, .add-case-btn:hover,
  .back-button:hover {{ background-color:darkred; }}
  input,select {{ padding:0.5rem; font-size:1rem; border-radius:6px;
     border:1px solid #444; background-color:#222; color:white; }}
  .readonly-field {{ border:1px solid #333; color:#bbb; }}
  label {{ font-weight:bold; display:block; margin:0.6rem 0 0.3rem; }}
  #filter-container {{ margin-bottom:1rem; display:flex;
     align-items:center; gap:0.5rem; }}
  .comparison-container {{ display:flex; gap:2rem; justify-content:center;
     flex-wrap:wrap; }}
  .pipeline-card {{ background-color:#1e1e1e; border:2px solid #ff4c4c;
     border-radius:10px; padding:1.5rem; width:100%; max-width:500px;
     box-shadow:0 0 10px 2px rgba(255,0,0,0.4); }}
  .pipeline-card h2 {{ color:red; border-bottom:1px solid #444;
     padding-bottom:0.5rem; }}
  .module {{ margin-top:1.5rem; }}
  .module h3 {{ margin-bottom:0.5rem; color:#ff4c4c;
     border-bottom:1px solid #333; padding-bottom:0.25rem; }}
  .metric {{ background-color:#2c2c2c; padding:0.75rem; margin-top:1rem;
     border-radius:6px; }}
  .results {{ flex:1 1 300px; background-color:#2c2c2c; padding:1.5rem;
     border-radius:8px; box-shadow:0 0 10px 1px #ff0000aa;
     min-width:280px; }}
  .results h2 {{ color:#ff4c4c; margin-top:0; }}
  .results select, .results input[type=range] {{ width:100%;
     border:1px solid #ff4c4c; background-color:#2c2c2c; }}
  .flex-view {{ display:flex; gap:2rem; width:100%; max-width:1000px;
     justify-content:center; flex-wrap:wrap; margin:0 auto; }}
  .image-container {{ flex:1 1 400px; max-width:600px; position:relative; }}
  .image-container img {{ width:100%; height:auto; border:2px solid red;
     border-radius:8px; object-fit:contain; }}
  .mask-grid {{ display:grid; grid-template-columns:repeat(8,1fr);
     gap:6px; }}
  .mask-grid img {{ width:100%; border:1px solid #333; border-radius:4px; }}
  pre {{ white-space:pre-wrap; word-wrap:break-word; }}
</style></head>
<body>
<header>
  <h1>{header_title}</h1>
  <nav>
    <a href="/">Home</a>
    <a href="/home">New Case</a>
    <a href="/diagnosis">History</a>
    <a href="/sample">Sample</a>
  </nav>
</header>
<main>{body}</main>
<footer><p>&copy; 2025 CAD Diagnostic System</p></footer>
</body></html>"""


def page(title: str, body: str) -> str:
    return _BASE.format(title=html.escape(title), header_title=_TITLE,
                        body=body)


# the reference's DefaultLanding.html fetches each pipeline's
# training_summary JSON client-side and renders the module sections; we
# keep the same mechanism (and the same module headings/fields) so the
# cards populate from whatever artifacts the workspace serves
_LANDING_JS = """
<script>
async function loadPipelineData(path, containerId, segmentation, explainability) {
  try {
    const response = await fetch(path);
    if (!response.ok) throw new Error("missing");
    const summary = await response.json();
    const model = summary.model || {};
    const dataset = summary.dataset || {};
    const training = summary.training || {};
    const evals = summary.evaluation || {};
    const classification = evals.classification_report || {};
    const labels = summary.label_encoder || {};
    const wavg = classification["weighted avg"] || {};
    const pct = v => ((v || 0) * 100).toFixed(2) + "%";
    document.getElementById(containerId).innerHTML = `
      <div class="module"><h3>Image Preprocessing</h3><ul>
        <li>Technique: ${segmentation} segmentation</li>
        <li>Region Extraction: ROI-based lesion highlighting</li>
        <li>Integration: Pre-processing step for CNN input</li></ul></div>
      <div class="module"><h3>Explainability</h3><ul>
        <li>Technique: ${explainability}</li>
        <li>Purpose: Visual interpretation of CNN decision areas</li>
        <li>Result: Heatmaps showing influential regions</li></ul></div>
      <div class="module"><h3>Convolutional Neural Network (CNN)</h3><ul>
        <li>Architecture: ${model.architecture}</li>
        <li>Conv Layers: ${JSON.stringify(model.conv_layers)}</li>
        <li>Hidden Units: ${JSON.stringify(model.hidden_units)}</li>
        <li>Dropout Rate: ${model.dropout_rate}</li></ul></div>
      <div class="module"><h3>Dataset</h3><ul>
        <li>Samples: ${dataset.num_samples}</li>
        <li>Classes: ${dataset.num_classes}</li>
        <li>Train/Test Split: ${dataset.train_split}/${dataset.test_split}</li>
      </ul></div>
      <div class="module"><h3>Training Summary</h3><ul>
        <li>Epochs: ${training.epochs}</li>
        <li>Batch Size: ${training.batch_size}</li>
        <li>Learning Rate: ${training.learning_rate}</li>
        <li>Best Validation Accuracy: ${pct(training.best_val_acc)}</li>
      </ul></div>
      <div class="module"><h3>Evaluation Metrics</h3>
        <div class="metric">
          <p><strong>Test Accuracy:</strong> ${pct(evals.test_accuracy)}</p>
          <p><strong>Precision (Weighted Avg):</strong> ${pct(wavg.precision)}</p>
          <p><strong>Recall (Weighted Avg):</strong> ${pct(wavg.recall)}</p>
          <p><strong>F1 Score (Weighted Avg):</strong> ${pct(wavg["f1-score"])}</p>
        </div>
        <h4>Confusion Matrix</h4>
        <pre>${JSON.stringify(evals.confusion_matrix, null, 2)}</pre></div>
      <div class="module"><h3>Label Encoder</h3>
        <pre>${JSON.stringify(labels, null, 2)}</pre></div>`;
  } catch (error) {
    document.getElementById(containerId).innerHTML =
      `<p style="color:#ff4c4c;">No training summary published at ${path}</p>`;
  }
}
loadPipelineData("/static/trained_model/training_summary_basic.json",
                 "basic-content", "U-Net", "Grad-CAM");
loadPipelineData("/static/trained_model/training_summary_advanced.json",
                 "advanced-content", "U-Net", "Grad-CAM (deep CNN)");
</script>"""


def landing() -> str:
    """Pipeline comparison page (reference DefaultLanding.html)."""
    body = f"""
<h2>Pipeline Comparison</h2>
<div class="comparison-container">
  <div class="pipeline-card" id="basic-card">
    <h2>Basic Pipeline</h2>
    <div style="text-align:center; margin-top:1rem;">
      <a href="/home?pipeline=basic" class="view-button">Basic Pipeline</a>
    </div>
    <p>From-scratch CNN on U-Net bottleneck features — fully on-device.</p>
    <div id="basic-content">Loading...</div>
  </div>
  <div class="pipeline-card" id="advanced-card">
    <h2>Advanced Pipeline</h2>
    <div style="text-align:center; margin-top:1rem;">
      <a href="/home?pipeline=advanced" class="view-button">Advanced Pipeline</a>
    </div>
    <p>Deep CNN on full-resolution encoder features.</p>
    <div id="advanced-content">Loading...</div>
  </div>
</div>{_LANDING_JS}"""
    return page("Pipeline Comparison", body)


def home(pipeline: str) -> str:
    """New-case upload page (reference Case/AddCase.html + upload.html:
    readonly case fields, image file + Body Part/Modality selects, and
    the bulk-zip section)."""
    p = html.escape(pipeline)
    body = f"""
<h2>Add New Case <small style="color:#999">({p} pipeline)</small></h2>
<div class="container" style="max-width:640px">
  <label>Case ID:</label>
  <input class="readonly-field" value="C001" readonly>
  <label>Patient:</label>
  <input class="readonly-field" value="Anonymous" readonly>
  <h2 style="margin-top:1.5rem">Image</h2>
  <form action="/upload-single" method="post" enctype="multipart/form-data">
    <label>Image File (1)</label>
    <input type="file" name="image1" required>
    <label for="body_part1">Body Part</label>
    <select name="body_part1" id="body_part1" required>
      <option>Left breast</option><option>Right breast</option>
    </select>
    <label>Modality</label>
    <select name="modality1"><option>Mammogram</option></select>
    <p style="margin-top:1rem">
      <button type="submit" class="upload-btn">Save Image</button></p>
  </form>
</div>
<div class="container" style="max-width:640px; margin-top:2rem">
  <h2>Bulk Upload</h2>
  <form action="/upload-bulk" method="post" enctype="multipart/form-data">
    <label>Images Zip</label>
    <input type="file" name="bulk_images_zip" accept=".zip" required>
    <p style="margin-top:1rem">
      <button type="submit" class="upload-btn">Upload Zip</button></p>
  </form>
</div>"""
    return page("Add Case", body)


# the reference History.html column filter, generalized over the table id
_FILTER_JS = """
<script>
const filterField = document.getElementById('filter-field');
const filterInput = document.getElementById('filter-input');
function applyFilter() {
  const filterColumn = parseInt(filterField.value);
  const filterText = filterInput.value.toLowerCase();
  document.querySelectorAll('#case-table tbody tr').forEach(row => {
    if (!row.cells[filterColumn]) return;
    const cellText = row.cells[filterColumn].textContent.toLowerCase();
    row.style.display = cellText.indexOf(filterText) > -1 ? '' : 'none';
  });
}
filterInput.addEventListener('input', applyFilter);
filterField.addEventListener('change', () => {
  filterInput.value = ''; applyFilter(); });
</script>"""


def diagnosis(cases: list[dict]) -> str:
    """Case history / diagnosis-details table (reference History.html
    filter + Diagnosis.html columns and actions)."""
    rows = "".join(
        "<tr class='clickable-row'><td>{pid}</td><td>{img}</td>"
        "<td>{breast}</td><td>{mod}</td>"
        "<td><a class='view-button' href='/view/{pid}'>View</a> "
        "<a class='view-button' href='/view_segmentation'>Masks</a> "
        "<a class='view-button' href='/classify'>Classify</a></td></tr>"
        .format(pid=html.escape(c.get("patient_id", "")),
                img=html.escape(c.get("image_name", "")),
                breast=html.escape(c.get("breast", "")),
                mod=html.escape(c.get("modality", "")))
        for c in cases)
    body = f"""
<h2>Case History — Diagnosis Details</h2>
<div id="filter-container">
  <label for="filter-field" style="display:inline">Filter:</label>
  <select id="filter-field">
    <option value="0">Patient ID</option>
    <option value="1">Image Name</option>
    <option value="2">Body Part</option>
    <option value="3">Modality</option>
  </select>
  <input id="filter-input" placeholder="Type to filter...">
</div>
<div class="container"><table id="case-table">
<thead><tr><th>Patient ID</th><th>Image Name</th><th>Body Part</th>
<th>Modality</th><th>Action</th></tr></thead>
<tbody>{rows or
        '<tr><td colspan="5" style="text-align:center;">No data available</td></tr>'}
</tbody></table></div>
<p style="margin-top:1.5rem">
  <a href="/home" class="add-case-btn">Add New Case</a></p>
{_FILTER_JS}"""
    return page("Case History", body)


def view_image(info: dict) -> str:
    body = f"""
<h2>Case Details — {html.escape(info.get('patient_id', ''))}</h2>
<div class="container" style="max-width:640px">
  <div class="metric"><strong>Image:</strong>
    {html.escape(info.get('image_name', ''))}</div>
  <div class="metric"><strong>Body Part:</strong>
    {html.escape(info.get('breast', ''))}</div>
  <div class="metric"><strong>Modality:</strong>
    {html.escape(info.get('modality', ''))}</div>
</div>"""
    return page("View Case", body)


def view_segmentation(out: dict) -> str:
    imgs = "".join(
        f"<img src='/static/segmentation_image/{html.escape(m)}' "
        f"title='{html.escape(m)}'>"
        for m in out.get("masks", []))
    meta = out.get("metadata", {})
    body = f"""
<h2>Segmentation Masks</h2>
<p>{html.escape(meta.get('image_name', ''))} —
   {html.escape(meta.get('modality', ''))}</p>
<div class="container"><div class="mask-grid">{imgs}</div></div>"""
    return page("Segmentation", body)


def classification(out: dict) -> str:
    """Classification results (reference Classification.html: image +
    red-glow results panel with metric rows)."""
    panels = []
    for r in out.get("classificationData", []):
        probs = r.get("prediction_probabilities", [])
        bars = "".join(
            f"<div class='metric'><label>Class {i} Probability</label>"
            f"{p * 100:.2f}%</div>"
            for i, p in enumerate(probs))
        panels.append(f"""
  <div class="results">
    <h2>Classification Details</h2>
    <div class="metric"><label>Predicted Class</label>
      {html.escape(str(r.get('predicted_class', '')))}</div>
    <div class="metric"><label>Diagnosis</label>
      {html.escape(str(r.get('diagnosis', '')))}</div>
    <div class="metric"><label>Confidence</label>
      {r.get('accuracy', r.get('confidence', 0))}%</div>
    {bars}
  </div>""")
    img = html.escape(out.get("image_filename", ""))
    body = f"""
<h2>Classification Results</h2>
<div class="flex-view">
  <div class="image-container">
    <img id="imageDisplay" src="/static/images/{img}"
         alt="Medical Image with ROI">
  </div>
  {''.join(panels)}
</div>
<p style="text-align:center; margin-top:2rem">
  <a class="view-button" href="/roi">Regions of Interest</a>
  <a class="back-button" href="/diagnosis">Close</a></p>
<script>var classificationData =
  {json.dumps(out.get('classificationData', []))};</script>"""
    return page("Classification Results", body)


def roi(out: dict) -> str:
    """Interactive ROI viewer — parity with the reference's
    RegionOfInterest.html:92-147 controls: class select (updates overlay
    + predicted-probability readout from classificationData), separate
    original/overlay transparency sliders, and a 1x-3x zoom slider."""
    class0 = html.escape(out.get("class_0_image_path",
                                 "explainability/gradcam_overlay_class_0.png"))
    body = f"""
<h2 style="text-align:center">Regions of Interest</h2>
<div class="flex-view">
  <div class="image-container" style="overflow:hidden; max-height:640px">
    <div id="zoomBox" style="position:relative; transform-origin:top left">
      <img id="imageDisplay"
        src="/static/images/{html.escape(out.get('image_filename', ''))}">
      <img id="ov" src="/static/{class0}"
        style="position:absolute; left:0; top:0; width:100%; opacity:.5;
               border:none">
    </div>
  </div>
  <div class="results">
    <h2>Classification Details</h2>
    <div class="metric">
      <label for="classSelect">Select Class:</label>
      <select id="classSelect">
        <option value="0">Benign</option>
        <option value="1">Malignant</option>
      </select>
    </div>
    <div class="metric">
      <label>Predicted Probability:</label>
      <span id="predictionProbability">0.00</span>
    </div>
    <div class="metric">
      <label for="originalOpacity">Original Image Transparency:</label>
      <input type="range" id="originalOpacity" min="0" max="1"
             step="0.01" value="1">
    </div>
    <div class="metric">
      <label for="overlayOpacity">Overlay Transparency:</label>
      <input type="range" id="overlayOpacity" min="0" max="1"
             step="0.01" value="0.5">
    </div>
    <div class="metric">
      <label for="zoomControl">Zoom:</label>
      <input type="range" id="zoomControl" min="1" max="3"
             step="0.1" value="1">
    </div>
  </div>
</div>
<p style="text-align:center; margin-top:2rem">
  <a class="back-button" href="/classify">Close</a></p>
<script>
var classificationData = {json.dumps(out.get('classificationData', []))};
var classSelect = document.getElementById("classSelect");
var predictionProbability = document.getElementById("predictionProbability");
function updateUIForClass(idx) {{
  var data = classificationData[idx];
  if (!data) return;
  var img = document.getElementById("ov");
  img.style.opacity = 0;
  setTimeout(function() {{
    img.src = "/static/" + data.overlay_path;
    predictionProbability.textContent =
      Number(data.confidence).toFixed(2) + "%";
    img.style.opacity =
      document.getElementById("overlayOpacity").value;
  }}, 200);
}}
classSelect.addEventListener("change", function() {{
  updateUIForClass(+this.value); }});
document.getElementById("originalOpacity").addEventListener("input",
  function() {{
    document.getElementById("imageDisplay").style.opacity = this.value; }});
document.getElementById("overlayOpacity").addEventListener("input",
  function() {{
    document.getElementById("ov").style.opacity = this.value; }});
document.getElementById("zoomControl").addEventListener("input",
  function() {{
    document.getElementById("zoomBox").style.transform =
      "scale(" + this.value + ")"; }});
updateUIForClass(0);
</script>"""
    return page("Regions of Interest", body)


def bulk_select(images: list[str]) -> str:
    """Bulk parameter selection (reference
    bulk_select_parameters.html: one card per image with Body Part +
    Modality selects and a Start Diagnosis button)."""
    cards = "".join(f"""
  <div class="container" style="max-width:420px">
    <h2 style="font-size:1.1rem">{html.escape(n)}</h2>
    <form action='/upload-bulk-image' method='post'
          enctype='multipart/form-data'>
      <input type='hidden' name='bulk_image_name'
             value='{html.escape(n)}'>
      <label>Body Part</label>
      <select name='body_part1' required>
        <option>Left breast</option><option>Right breast</option>
      </select>
      <label>Modality</label>
      <select name='modality1'><option>Mammogram</option></select>
      <p style="margin-top:1rem"><button type='submit'
         class='upload-btn'>Start Diagnosis</button></p>
    </form>
  </div>"""
                    for n in images)
    body = f"""
<h2>Bulk Diagnosis — Select Parameters for Each Image</h2>
<div class="comparison-container" style="justify-content:flex-start">
{cards or '<p>No bulk images pending.</p>'}</div>"""
    return page("Bulk Diagnosis", body)


def sample() -> str:
    """Example walkthrough (reference Sample.html: raw image next to
    the highlighted result, metadata + classification sections)."""
    body = """
<h2>Example Diagnosis: Raw Image and Classification Results</h2>
<div class="flex-view">
  <div class="image-container">
    <h2 style="font-size:1rem">Raw Image</h2>
    <img src="/static/images/sample_raw.png"
         alt="Raw medical breast scan image"
         onerror="this.alt='(upload a case to populate)'">
  </div>
  <div class="results">
    <h2 id="metadataHeading">Image Metadata</h2>
    <div class="metric"><label>Modality</label>Mammogram (MLO)</div>
    <div class="metric"><label>Pipeline</label>basic / advanced</div>
    <h2 id="classificationHeading">Classification Details</h2>
    <div class="metric"><label>Flow</label>
      Upload &rarr; preprocess (artifact suppression, breast
      segmentation, pectoral removal) &rarr; U-Net features &rarr; CNN
      classify &rarr; Grad-CAM ROI overlay</div>
  </div>
</div>"""
    return page("Sample", body)
