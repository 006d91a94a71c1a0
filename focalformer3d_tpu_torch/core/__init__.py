"""Ported box decoding and selection."""
