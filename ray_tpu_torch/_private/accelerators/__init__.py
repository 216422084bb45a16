"""Accelerator managers (reference: _private/accelerators/ — pluggable
per-vendor detection, visibility env vars, scheduling-name mapping)."""
from __future__ import annotations

from .accelerator import AcceleratorManager  # noqa: F401
from .gpu import GPUAcceleratorManager  # noqa: F401

_managers = {"GPU": GPUAcceleratorManager()}


def get_accelerator_manager(resource_name: str):
    return _managers.get(resource_name)


def all_accelerator_managers():
    return dict(_managers)
