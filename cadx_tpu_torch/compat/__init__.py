"""Port of `cadx_tpu/compat`: the reference-compatible API surfaces
(`Classes/` module equivalents in `classes.py`, the DICOM demo loader in
`load.py`) and the advanced model's torch-checkpoint loader and exporter
(`adcnnm.py`)."""

from cadx_tpu_torch.compat.adcnnm import (  # noqa: F401
    save_trained_model,
    torch_state_dict_from_params,
)
from cadx_tpu_torch.compat.classes import (  # noqa: F401
    CNNModel,
    CrossValidator,
    ExplainableAI,
    ImageSegmentation,
    Model,
    ModelEvaluator,
    ModelPredictor,
    ModelTrainer,
    Preprocessing,
    TinyUNetModel,
    load_weights,
    tiny_unet,
)
from cadx_tpu_torch.compat.load import load_dicom  # noqa: F401
