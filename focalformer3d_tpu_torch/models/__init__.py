"""Ported models: sparse encoder, BEV backbone, neck, head."""
