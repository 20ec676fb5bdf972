from repro_torch.utils.tree import (
    TreeSpec,
    tree_leaves,
    tree_map,
    tree_num_params,
    tree_paths,
    tree_ravel,
    tree_size_bytes,
    tree_spec,
    tree_unflatten,
    tree_unravel,
)

__all__ = [
    "TreeSpec",
    "tree_leaves",
    "tree_map",
    "tree_num_params",
    "tree_paths",
    "tree_ravel",
    "tree_size_bytes",
    "tree_spec",
    "tree_unflatten",
    "tree_unravel",
]
