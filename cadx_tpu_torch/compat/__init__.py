"""Port of `cadx_tpu/compat`: the advanced model's torch-checkpoint loader
(`adcnnm.py`). The `Classes/` compat API is not ported yet."""
