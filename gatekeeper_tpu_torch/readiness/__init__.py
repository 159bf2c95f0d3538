from .tracker import ObjectTracker, Tracker  # noqa: F401
