from .excluder import AUDIT, STAR, SYNC, WEBHOOK, Excluder  # noqa: F401
