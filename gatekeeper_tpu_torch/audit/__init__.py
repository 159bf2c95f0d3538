"""Audit subsystem (reference pkg/audit/)."""

from .manager import AuditManager, StatusViolation

__all__ = ["AuditManager", "StatusViolation"]
