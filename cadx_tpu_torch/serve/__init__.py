"""The serving engine and its micro-batcher (the HTTP front is not ported)."""
