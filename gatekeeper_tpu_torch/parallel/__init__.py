"""Several devices: the row-sharded audit sweep (mesh.py) and the sweep
across processes (multihost.py)."""

from .mesh import audit_mesh, sharded_masks, visible_devices  # noqa: F401
