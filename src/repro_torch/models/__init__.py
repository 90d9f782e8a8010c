"""The model zoo of the port — ``repro.models`` for the families it serves
(the hybrid Zamba2, the xLSTM and the dense transformers so far)."""

from repro_torch.models.api import Model, build_model
from repro_torch.models.config import ModelConfig, RuntimeFlags

__all__ = ["Model", "ModelConfig", "RuntimeFlags", "build_model"]
