"""Ported models (eval): sparse encoder, BEV backbone, neck, head."""
