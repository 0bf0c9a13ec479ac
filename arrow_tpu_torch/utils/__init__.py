"""Bit-packing and scan helpers."""
