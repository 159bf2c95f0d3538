from .inmem import InMemoryKube, WatchEvent  # noqa: F401
