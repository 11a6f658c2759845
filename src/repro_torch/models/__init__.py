from repro_torch.models.api import build_model
from repro_torch.models.lstm_am import LstmAM
from repro_torch.models.transformer import Transformer
from repro_torch.models.whisper import Whisper

__all__ = ["build_model", "LstmAM", "Transformer", "Whisper"]
