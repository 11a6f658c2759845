from repro_torch.checkpoint.convert import load_jax_npz, params_from_numpy

__all__ = ["load_jax_npz", "params_from_numpy"]
