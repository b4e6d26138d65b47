"""The serving engine, its micro-batcher, and the HTTP front (`app.py`)
with its case store and pages."""
