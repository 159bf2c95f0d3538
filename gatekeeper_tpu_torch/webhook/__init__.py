"""Admission webhook serving layer (reference pkg/webhook/).

`policy` re-provides the validation handler semantics of policy.go;
`namespacelabel` guards the admission.gatekeeper.sh/ignore label;
`server` is the HTTPS front end with TPU micro-batching.
"""

from .policy import (
    AdmissionResponse,
    ValidationHandler,
    SERVICE_ACCOUNT_NAME,
)
from .namespacelabel import IGNORE_LABEL, NamespaceLabelHandler
from .server import BatcherStopped, MicroBatcher, WebhookServer

__all__ = [
    "AdmissionResponse",
    "BatcherStopped",
    "IGNORE_LABEL",
    "MicroBatcher",
    "NamespaceLabelHandler",
    "SERVICE_ACCOUNT_NAME",
    "ValidationHandler",
    "WebhookServer",
]
