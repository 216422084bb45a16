"""AcceleratorManager base (reference:
_private/accelerators/accelerator.py)."""
from __future__ import annotations

from typing import Dict, List, Optional


class AcceleratorManager:
    """Per-vendor detection + worker visibility plumbing."""

    @staticmethod
    def get_resource_name() -> str:
        raise NotImplementedError

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        raise NotImplementedError

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        return None

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> Optional[str]:
        return None

    @staticmethod
    def set_visible_accelerator_ids(env: Dict[str, str],
                                    ids: List[str]) -> None:
        pass

    @staticmethod
    def get_current_node_additional_resources() -> Dict[str, float]:
        return {}
