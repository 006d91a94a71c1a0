"""Ported box codec, selection, losses, targets and assignment."""
