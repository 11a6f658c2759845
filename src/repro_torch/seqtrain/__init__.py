"""Sequence training (paper §3.4): the sMBR loss over a senone-bigram
denominator graph, the twin of the reference's ``seqtrain``."""
from repro_torch.seqtrain.fb import forward_backward, forward_log_norm
from repro_torch.seqtrain.graphs import DenominatorGraph, build_denominator_graph
from repro_torch.seqtrain.smbr import smbr_loss, make_smbr_loss_fn

__all__ = ["forward_backward", "forward_log_norm", "DenominatorGraph",
           "build_denominator_graph", "smbr_loss", "make_smbr_loss_fn"]
