from .registry import Dependencies, Manager  # noqa: F401
