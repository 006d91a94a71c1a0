"""Ported training: detection losses, optimizer, train step."""
