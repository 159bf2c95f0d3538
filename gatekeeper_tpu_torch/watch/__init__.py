from .manager import ControllerSwitch, Registrar, WatchManager  # noqa: F401
from .set import GVKSet  # noqa: F401
