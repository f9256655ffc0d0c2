"""Shared utilities: tree helpers, dataframe display."""
from mmdx_tpu_torch.utils.pytree import count_params, tree_paths, cast_floating  # noqa: F401
