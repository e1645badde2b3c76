"""Roofline terms of one step per device. Port of ``repro.roofline``."""
