from repro_torch.checkpoint.convert import load_jax_npz, params_from_numpy
from repro_torch.checkpoint.store import (CheckpointStore, load_params,
                                         load_tree, save_tree)

__all__ = ["CheckpointStore", "save_tree", "load_tree", "load_params",
           "load_jax_npz", "params_from_numpy"]
