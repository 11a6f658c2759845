from repro_torch.models.api import build_model
from repro_torch.models.lstm_am import LstmAM
from repro_torch.models.transformer import Transformer

__all__ = ["build_model", "LstmAM", "Transformer"]
