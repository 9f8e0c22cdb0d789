"""Logical sharding of the port, on one device: ``lshard`` is the identity.

This is the reference's ``repro/sharding/logical.py::lshard`` with no rules
active, its only behaviour on one device. The mesh layer (rules, meshes,
``logical_sharding``) waits for the slice that ports ``sharding/`` whole.
"""


def lshard(x, *names):
    """The logical sharding constraint of activation ``x`` over ``names``:
    ``x`` itself, as the reference returns it without a rules context."""
    return x
