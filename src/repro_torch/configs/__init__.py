"""Assigned-architecture configs (``--arch <id>``), copied as data from
the JAX package's ``configs`` so the port imports nothing of it.

Each module defines CONFIG: ModelConfig with the exact published
hyperparameters from the assignment table.  ``registry.get(name)``
resolves ids.
"""
from .registry import ARCHS, get  # noqa: F401
