from repro_torch.kernels.lstm_seq.ops import lstm_seq
from repro_torch.kernels.lstm_seq.ref import lstm_seq_ref

__all__ = ["lstm_seq", "lstm_seq_ref"]
