from repro_torch.utils.tree import (
    tree_size_bytes,
    tree_param_count,
    tree_cast,
    tree_zeros_like,
    flatten_dict,
)
