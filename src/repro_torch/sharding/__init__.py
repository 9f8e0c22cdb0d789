"""Logical sharding on ``torch.distributed``: rule tables mapping logical
dim names to mesh axes, and ``lshard``, the identity without active rules
and a DTensor redistribution under them (``logical.py``)."""
from repro_torch.sharding.logical import (
    LogicalRules,
    set_rules,
    get_rules,
    clear_rules,
    lshard,
    logical_sharding,
    DEFAULT_RULES,
    use_rules,
)
