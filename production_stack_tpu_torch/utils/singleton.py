"""Singleton metaclasses (capability parity: reference src/vllm_router/utils.py:17-46)."""

import threading
from abc import ABCMeta


class SingletonMeta(type):
    """Metaclass that makes a class a process-wide singleton."""

    _instances: dict[type, object] = {}
    _lock = threading.Lock()

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            with SingletonMeta._lock:
                if cls not in cls._instances:
                    cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]

    @classmethod
    def _reset(mcs, cls: type) -> None:
        """Drop the stored instance (used by tests and live reconfiguration)."""
        with mcs._lock:
            mcs._instances.pop(cls, None)


class SingletonABCMeta(ABCMeta, SingletonMeta):
    """Singleton + ABC combined metaclass."""
