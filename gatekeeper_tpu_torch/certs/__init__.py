"""Webhook certificate rotation (reference vendored cert-controller)."""

from .rotator import CertRotator, generate_ca, generate_server_cert

__all__ = ["CertRotator", "generate_ca", "generate_server_cert"]
